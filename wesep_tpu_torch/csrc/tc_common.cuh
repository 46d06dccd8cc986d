// Tensor-core building blocks shared by the hand-written Hopper kernels
// (lstm_tc.cuh's products and chains, tcn_common.cuh's products): 16-byte
// cp.async copies into shared memory, ldmatrix fragment loads and the bf16
// mma.sync product (m16n8k16, f32 sums).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tc {

using bf16 = __nv_bfloat16;
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when `src` is null (`dummy` is then
// read for no byte).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           const void* dummy) {
  const int n = src != nullptr ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src != nullptr ? src : dummy), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  if constexpr (kTrans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  }
}

// c += a @ b for one 16 x 8 x 16 tile, bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment addresses of one lane (ldmatrix: lanes 8i..8i+7 give the rows of
// matrix i). A 16 x 16 tile at (r0, k0) of a [rows][k] smem tile (kTrans
// false) or of a [k][rows] one (kTrans true); B from a [k][n] tile (kTrans
// true) or from an [n][k] one (kTrans false).
template <bool kTrans>
__device__ __forceinline__ const bf16* a_frag(const bf16* s, int ld, int r0,
                                              int k0, int lane) {
  const int i = lane & 7;
  const int hi = (lane >> 3) & 1;  // matrices 1 and 3: rows r0 + 8 ..
  const int kk = lane >> 4;        // matrices 2 and 3: k0 + 8 ..
  return kTrans ? s + (k0 + i + kk * 8) * ld + r0 + hi * 8
                : s + (r0 + i + hi * 8) * ld + k0 + kk * 8;
}
// Two 16 x 8 tiles of B at (k0, n0) and (k0, n0 + 8), one ldmatrix.x4:
// registers 0-1 the first tile's, 2-3 the second's.
template <bool kTrans>
__device__ __forceinline__ const bf16* b_frag2(const bf16* s, int ld, int k0,
                                               int n0, int lane) {
  const int i = lane & 7;
  const int kk = (lane >> 3) & 1;  // matrices 1 and 3: k0 + 8 ..
  const int nn = lane >> 4;        // matrices 2 and 3: n0 + 8 ..
  return kTrans ? s + (k0 + i + kk * 8) * ld + n0 + nn * 8
                : s + (n0 + i + nn * 8) * ld + k0 + kk * 8;
}

template <bool kTrans>
__device__ __forceinline__ void b_load2(uint32_t (&b0)[2], uint32_t (&b1)[2],
                                        const bf16* s, int ld, int k0, int n0,
                                        int lane) {
  uint32_t r[4];
  ldsm_x4<kTrans>(r, b_frag2<kTrans>(s, ld, k0, n0, lane));
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}

}  // namespace tc
