// Fused gLN TCN block of SpEx+ / ConvTasNet, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel wesep_tpu/ops/pallas_tcn.py `_bwd_kernel`
// (`_bwd_call`, the custom VJP of `tcn_block_gln`): the adjoint of the
// forward in tcn_block.cu, from x, dy and the saved statistics (mu0, rs0,
// mu1, rs1). Nothing else is saved: u is recomputed, as on the TPU. With
// nhw = T * H and every sum below per sample unless it is a parameter's:
//
//   s    = x @ W1 + b1_eff;  u = round(PReLU_p0(s))           (recomputed)
//   n0   = a0 * u + c0 (f32), zero outside [0, T);  v = bd + sum kd * taps
//   w    = round(PReLU_p1(v));  s1hat = (w - mu1) * rs1
//   n1   = g1w * s1hat + g1b
//   dn1  = dy @ W2^T;  dW2 = round(n1)^T @ dy;  db2 = sum dy
//   dg1  = sum dn1 * s1hat;  dbe1 = sum dn1
//   m0   = sum(g1w * dn1) / nhw;  m1 = sum(g1w * dn1 * s1hat) / nhw
//   dw   = rs1 * (g1w * dn1 - m0 - s1hat * m1)
//   dp1  = sum dw * min(v, 0);  dv = dw * (v >= 0 ? 1 : p1)
//   dbd  = sum dv;  dkd[kk] = sum dv * tap_kk
//   dn0[t] = sum_kk kd[kk] * round(dv)[t - kk * dilation + pad_lo]
//            (a gather at the mirrored shifts, in the stream's dtype)
//   s0hat = (u - mu0) * rs0;  dg0 = sum dn0 * s0hat;  dbe0 = sum dn0
//   m2, m3 likewise from g0w * dn0;  du = rs0 * (g0w * dn0 - m2 - s0hat * m3)
//   dp0  = sum du * min(s, 0);  ds = du * (s >= 0 ? 1 : p0)
//   db1_eff[b] = sum_t ds;  dx = dy + round(ds) @ W1^T;  dW1 = x^T @ round(ds)
//
// The TPU kernel walks three sequential sweeps over VMEM-resident scratch
// and scatters dn0; here each global sum is a boundary between launches on
// one stream, and the elementwise work rides in the epilogues of the
// products whose tiles hold its operands (tcn_common.cuh: bf16 on the
// tensor cores, mma.sync.m16n8k16; f32 on the FMA units; f32 sums).
// The streams that pass through device memory are u, round(n1) (its
// buffer reused for dn0, then round(ds) in place) and round(dv), in the
// stream's dtype; s and dn1 are recomputed by a product where they are
// needed, and dn0 is gathered, so nothing is atomic:
//
//   u product     x @ W1 -> u                              (product 1)
//   gln1 product  dn1 = dy @ W2^T; epilogue: w from u's taps, round(n1);
//                 dg1, dbe1; sums for m0, m1               (product 2)
//   dv product    dn1 again; epilogue: dw, round(dv); dbd, dkd, dp1
//                                                          (product 3)
//   dW2 product   round(n1)^T @ dy, split rows             (product 4)
//   tcn_colsum    db2
//   tcn_dn0       dn0 gathered from round(dv); dg0, dbe0; sums for m2, m3
//   ds product    s = x @ W1 again; epilogue: u, du, round(ds); db1_eff,
//                 dp0                                      (product 5)
//   dx product    dx = dy + round(ds) @ W1^T               (product 6)
//   dW1 product   x^T @ round(ds), split rows              (product 7)
//
// Every sum over rows is written as per-block partials and added by
// tcn_sum_slices_kernel in a fixed order, so the gradients repeat bit
// for bit from run to run. An epilogue with per-channel sums stages the
// f32 tile in shared memory and walks it by columns (tcn_common.cuh
// Walk): a thread takes two neighbouring channels over 32 rows, the four
// row groups' sums are added in order; its loads of u's taps read a row's
// neighbouring channels in neighbouring threads, as vectors. The colsum
// and dn0 passes walk 128 rows x 128 channels alike, dn0 from round(dv)'s
// taps copied into shared memory.
//
// What bounds it on this card. The model's count is 8 * B * T * C * H +
// 4 * B * T * H * k operations (14 * B * T * C * H executed with the
// recomputed s, dn1 and u) against x and dy read and dx written once: at
// B = 16, T = 4799, C = 256, H = 512, 8.1e10 operations, 0.08 ms at
// 989 TFLOP/s in bf16 (1.2 ms if f32 is counted at the 67 TFLOP/s FMA
// rate), against 0.04 to 0.07 ms for the bytes: operations bound it. The
// design's own floor: 7 products of 2 B T C H (on mma.sync in bf16, at the
// FMA rate in f32), and u, round(n1), round(dv), round(ds) written once
// and read one to three times (~0.6 GB at B = 16 in bf16, ~0.2 ms).

#include "tcn_common.cuh"

namespace {

using namespace tcn;

// part[(b * chunks + chunk) * C + c] = sum over the chunk's 128 rows of
// dy, a block per (chunk, 128 channels, sample) walking its rows (Walk).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    tcn_colsum_kernel(const T* __restrict__ dy, float* __restrict__ part,
                      int T_len, int C) {
  __shared__ __align__(8) float spare[3 * kTile];
  const int z = blockIdx.z;
  const int m0 = blockIdx.x * kTile;
  const Walk wk(T_len - m0);
  const int c = blockIdx.y * kTile + wk.c;
  float2 acc[1] = {make_float2(0.0f, 0.0f)};
  if (c < C) {
    const T* base = dy + static_cast<size_t>(z) * T_len * C + c;
    for (int r = wk.r0; r < wk.r1; ++r) {
      const float2 g = load2(base + static_cast<size_t>(m0 + r) * C);
      acc[0].x += g.x;
      acc[0].y += g.y;
    }
  }
  add_groups(acc, spare);
  if (threadIdx.x < 64 && c < C) {
    *reinterpret_cast<float2*>(part + vec_at(z, blockIdx.x, gridDim.x, 1, 0,
                                             C, c)) = acc[0];
  }
}

// a0 and c0 of the pair of channels (h, h + 1): n0 = a0 * u + c0 in f32.
__device__ __forceinline__ void gln0_affine(const float* __restrict__ stats,
                                            const float* __restrict__ g0w,
                                            const float* __restrict__ g0b,
                                            int z, int h, float2& a0,
                                            float2& c0) {
  const float mu0 = stats[z * 4];
  const float rs0 = stats[z * 4 + 1];
  a0 = make_float2(g0w[h] * rs0, g0w[h + 1] * rs0);
  c0 = make_float2(g0b[h] - mu0 * a0.x, g0b[h + 1] - mu0 * a0.y);
}

// f(kk, i, n0) for each tap kk of u and the walk's rows i < rows whose row
// t0 + i + kk * dilation - pad_lo lies in [0, T), taps in order, n0 =
// a0 * u + c0 of the pair; every thread of the block calls it, f only
// where `live`. bf16 (kStagedTaps): the block copies each tap's 128 rows
// of its 128 channels into `buf` first (tcn_common.cuh stage_tap), in
// flight at once and costing no registers, where loads of u from each
// thread left the epilogue waiting on them. f32 reads u in place: a 64 KB
// tap buffer would leave one block an SM, which cost the FMA products more
// than the copies gained.
template <typename T>
constexpr bool kStagedTaps = sizeof(T) == 2;

template <typename T, class F>
__device__ __forceinline__ void for_each_u_tap(
    T* buf, const T* __restrict__ u, float2 a0, float2 c0, bool live,
    const Walk& wk, int z, int m0, int n0, int T_len, int H, int k,
    int dilation, int pad_lo, F&& f) {
  const int t0 = m0 + wk.r0, rows = wk.r1 - wk.r0;
#pragma unroll
  for (int kk = 0; kk < kMaxTaps; ++kk) {  // kk a constant in f
    if (kk >= k) break;
    const int shift = kk * dilation - pad_lo;
    if constexpr (kStagedTaps<T>) {
      stage_tap(buf, u, z, m0 + shift, T_len, H, n0);
      tc::cp_async_wait<0>();
      __syncthreads();
    }
    if (live) {
      const T* ub = u + static_cast<size_t>(z) * T_len * H + n0 + wk.c;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int tt = t0 + i + shift;
        if (i < rows && tt >= 0 && tt < T_len) {
          const float2 uu =
              kStagedTaps<T> ? load2(buf + (wk.r0 + i) * kTile + wk.c)
                             : load2(ub + static_cast<size_t>(tt) * H);
          f(kk, i, make_float2(a0.x * uu.x + c0.x, a0.y * uu.y + c0.y));
        }
      }
    }
    if constexpr (kStagedTaps<T>) {
      __syncthreads();  // the tap is read before the next is copied in
    }
  }
}

template <typename T>
__device__ __forceinline__ void load_kd(const T* __restrict__ kd, int h,
                                        int H, int k,
                                        float2 (&kdc)[kMaxTaps]) {
#pragma unroll
  for (int kk = 0; kk < kMaxTaps; ++kk) {
    kdc[kk] = kk < k ? load2(kd + static_cast<size_t>(kk) * H + h)
                     : make_float2(0.0f, 0.0f);
  }
}

// v of the walk's rows and pair of channels (h, h + 1) in f32, recomputed
// from the taps of u: v = bd + sum_kk kd[kk] * n0[t + kk * dilation -
// pad_lo], taps outside [0, T) adding nothing; a0 and c0 of the pair for
// further passes over the taps. Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void recompute_v(
    float2 (&v)[kRows], float2& a0, float2& c0, T* buf,
    const T* __restrict__ u, const float* __restrict__ stats,
    const float* __restrict__ g0w, const float* __restrict__ g0b,
    const T* __restrict__ kd, const float* __restrict__ bd, bool live,
    const Walk& wk, int z, int m0, int n0, int T_len, int H, int k,
    int dilation, int pad_lo) {
  const int h = n0 + wk.c;
  float2 kdc[kMaxTaps];
  a0 = c0 = make_float2(0.0f, 0.0f);
  if (live) {
    gln0_affine(stats, g0w, g0b, z, h, a0, c0);
    load_kd(kd, h, H, k, kdc);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    v[i] = live ? make_float2(bd[h], bd[h + 1]) : make_float2(0.0f, 0.0f);
  }
  for_each_u_tap(buf, u, a0, c0, live, wk, z, m0, n0, T_len, H, k, dilation,
                 pad_lo, [&](int kk, int i, float2 n) {
                   v[i].x = v[i].x + kdc[kk].x * n.x;
                   v[i].y = v[i].y + kdc[kk].y * n.y;
                 });
}

__device__ __forceinline__ float2 tile_pair(const float* tile, int r, int c) {
  return *reinterpret_cast<const float2*>(tile + r * kLdMN + c);
}

// The pair's per-channel partials of vector `vec` of `nvec` (group 0).
__device__ __forceinline__ void put_pair(float* vpart, int z, int nvec,
                                         int vec, int H, int h, float2 v) {
  *reinterpret_cast<float2*>(
      vpart + vec_at(z, blockIdx.x, gridDim.x, nvec, vec, H, h)) = v;
}

// Epilogue of the dx product, tile of round(ds) @ W1^T for sample z,
// staged and written by rows: dx = dy + that.
template <typename T>
struct EpiDx {
  static constexpr bool kTaps = false;
  static constexpr int kBM = kTile;
  const T* dy;
  T* dx;
  int T_len, C;
  __device__ void operator()(const float (&acc)[64], int z, int m0, int n0,
                             float* tile) const {
    stage_tile<T>(acc, tile);
    for_each_row8<kBM>(tile, [&](int r, int c, float (&v)[8]) {
      if (m0 + r >= T_len || n0 + c >= C) return;
      const size_t idx =
          (static_cast<size_t>(z) * T_len + m0 + r) * C + n0 + c;
      float g[8];
      load8(dy + idx, g);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += g[j];
      store8(dx + idx, v);
    });
  }
};

// Epilogue of a weight-gradient product: the split z's partial [M, N].
template <typename T>
struct EpiWgrad {
  static constexpr bool kTaps = false;
  static constexpr int kBM = kTile;
  float* part;
  int M, N;
  __device__ void operator()(const float (&acc)[64], int z, int m0, int n0,
                             float*) const {
    float* out = part + static_cast<size_t>(z) * M * N;
    for_each_pair<T, kBM>(acc, [&](int r, int c, float v0, float v1) {
      const int row = m0 + r, col = n0 + c;
      if (row >= M || col >= N) return;
      *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * N + col) =
          make_float2(v0, v1);
    });
  }
};

// Epilogue of the gln1 product, tile of dn1 = dy @ W2^T for sample z,
// walked by columns: round(n1) for the dW2 product; partials of dg1, dbe1
// (vpart, 2 vectors) and of sum(g1w * dn1), sum(g1w * dn1 * s1hat)
// (spart).
template <typename T>
struct EpiGln1 {
  static constexpr bool kTaps = kStagedTaps<T>;
  static constexpr int kBM = kTile;
  const T* u;
  const float *stats, *g0w, *g0b;
  const T* kd;
  const float *bd, *g1w, *g1b, *p1;
  T* n1c;
  float* vpart;
  double* spart;
  int T_len, H, k, dilation, pad_lo;
  __device__ void operator()(const float (&acc)[64], int z, int m0, int n0,
                             float* tile) const {
    stage_tile<T>(acc, tile);
    T* buf = reinterpret_cast<T*>(tile + kTile * kLdMN);
    const Walk wk(T_len - m0);
    const int h = n0 + wk.c;
    const bool live = h < H;
    const int t0 = m0 + wk.r0, rows = wk.r1 - wk.r0;
    float2 a0, c0, v[kRows];
    recompute_v(v, a0, c0, buf, u, stats, g0w, g0b, kd, bd, live, wk, z, m0,
                n0, T_len, H, k, dilation, pad_lo);
    float2 vec[2] = {make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f)};
    double acc0 = 0.0, acc1 = 0.0;
    if (live) {
      const size_t base = static_cast<size_t>(z) * T_len * H + h;
      const float mu1 = stats[z * 4 + 2];
      const float rs1 = stats[z * 4 + 3];
      const float p = *p1;
      const float2 gw = make_float2(g1w[h], g1w[h + 1]);
      const float2 gb = make_float2(g1b[h], g1b[h + 1]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (i >= rows) break;
        const float2 s1 =
            make_float2((rnd<T>(prelu(v[i].x, p)) - mu1) * rs1,
                        (rnd<T>(prelu(v[i].y, p)) - mu1) * rs1);
        store2<T>(n1c + base + static_cast<size_t>(t0 + i) * H,
                  gw.x * s1.x + gb.x, gw.y * s1.y + gb.y);
        const float2 d = tile_pair(tile, wk.r0 + i, wk.c);
        vec[0].x += d.x * s1.x;
        vec[0].y += d.y * s1.y;
        vec[1].x += d.x;
        vec[1].y += d.y;
        acc0 += gw.x * d.x;
        acc0 += gw.y * d.y;
        acc1 += gw.x * d.x * s1.x;
        acc1 += gw.y * d.y * s1.y;
      }
    }
    add_groups(vec, reinterpret_cast<float*>(buf));
    if (threadIdx.x < 64 && live) {
      put_pair(vpart, z, 2, 0, H, h, vec[0]);
      put_pair(vpart, z, 2, 1, H, h, vec[1]);
    }
    block_scalars(spart, z, acc0, acc1);
  }
};

// Epilogue of the dv product, tile of dn1 again, walked by columns:
// round(dv) for the gather; partials of dbd and dkd (vpart, 1 + k
// vectors) and of dp1 (spart, first of two). acc01[z] = the two sums of
// the gln1 epilogue.
template <typename T>
struct EpiDv {
  static constexpr bool kTaps = kStagedTaps<T>;
  static constexpr int kBM = kTile;
  const T* u;
  const float* stats;
  const double* acc01;
  const float *g0w, *g0b;
  const T* kd;
  const float *bd, *g1w, *p1;
  T* dvc;
  float* vpart;
  double* spart;
  int T_len, H, k, dilation, pad_lo;
  double nhw;
  __device__ void operator()(const float (&acc)[64], int z, int m0, int n0,
                             float* tile) const {
    stage_tile<T>(acc, tile);
    T* buf = reinterpret_cast<T*>(tile + kTile * kLdMN);
    const Walk wk(T_len - m0);
    const int h = n0 + wk.c;
    const bool live = h < H;
    const int t0 = m0 + wk.r0, rows = wk.r1 - wk.r0;
    float2 a0, c0, v[kRows];
    recompute_v(v, a0, c0, buf, u, stats, g0w, g0b, kd, bd, live, wk, z, m0,
                n0, T_len, H, k, dilation, pad_lo);
    float2 vec[1 + kMaxTaps];
#pragma unroll
    for (int i = 0; i < 1 + kMaxTaps; ++i) vec[i] = make_float2(0.0f, 0.0f);
    double dp1 = 0.0;
    if (live) {
      const size_t base = static_cast<size_t>(z) * T_len * H + h;
      const float mu1 = stats[z * 4 + 2];
      const float rs1 = stats[z * 4 + 3];
      const float m0s = static_cast<float>(acc01[z * 2] / nhw);
      const float m1s = static_cast<float>(acc01[z * 2 + 1] / nhw);
      const float p = *p1;
      const float2 gw = make_float2(g1w[h], g1w[h + 1]);
      // dv replaces dn1 in the tile cell the thread owns, for the dkd pass
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (i >= rows) break;
        float2* cell =
            reinterpret_cast<float2*>(tile + (wk.r0 + i) * kLdMN + wk.c);
        const float2 d = *cell;
        float dv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float vj = j == 0 ? v[i].x : v[i].y;
          const float s1hat = (rnd<T>(prelu(vj, p)) - mu1) * rs1;
          const float dw = rs1 * ((j == 0 ? gw.x * d.x : gw.y * d.y) - m0s -
                                  s1hat * m1s);
          dp1 += dw * fminf(vj, 0.0f);
          dv[j] = dw * (vj >= 0.0f ? 1.0f : p);
        }
        *cell = make_float2(dv[0], dv[1]);
        vec[0].x += dv[0];
        vec[0].y += dv[1];
        store2<T>(dvc + base + static_cast<size_t>(t0 + i) * H, dv[0], dv[1]);
      }
    }
    // dkd[kk] = sum dv * tap_kk, the taps of n0 copied in again
    for_each_u_tap(buf, u, a0, c0, live, wk, z, m0, n0, T_len, H, k,
                   dilation, pad_lo, [&](int kk, int i, float2 n) {
                     const float2 dv = tile_pair(tile, wk.r0 + i, wk.c);
                     vec[1 + kk].x += dv.x * n.x;
                     vec[1 + kk].y += dv.y * n.y;
                   });
    add_groups(vec, reinterpret_cast<float*>(buf));
    if (threadIdx.x < 64 && live) {
      put_pair(vpart, z, 1 + k, 0, H, h, vec[0]);
#pragma unroll
      for (int kk = 0; kk < kMaxTaps; ++kk) {
        if (kk < k) put_pair(vpart, z, 1 + k, 1 + kk, H, h, vec[1 + kk]);
      }
    }
    block_scalars(spart, z, dp1, 0.0);
  }
};

// Epilogue of the ds product, tile of x @ W1 for sample z, walked by
// columns: s, u, dn0 (read where tcn_dn0_kernel left it, in the buffer
// round(ds) then overwrites element by element), du; round(ds) for the
// last two products; partials of db1_eff (vpart, one vector) and of dp0
// (spart, first of two). acc23[z] = the two sums of tcn_dn0_kernel.
template <typename T>
struct EpiDs {
  static constexpr bool kTaps = false;
  static constexpr int kBM = kTile;
  const float* stats;
  const double* acc23;
  const float *b1_eff, *g0w, *p0;
  T* dsc;  // dn0 in, round(ds) out
  float* vpart;
  double* spart;
  int T_len, H;
  double nhw;
  __device__ void operator()(const float (&acc)[64], int z, int m0, int n0,
                             float* tile) const {
    stage_tile<T>(acc, tile);
    const Walk wk(T_len - m0);
    const int h = n0 + wk.c;
    float2 vec[1] = {make_float2(0.0f, 0.0f)};
    double dp0 = 0.0;
    if (h < H) {
      const size_t base = static_cast<size_t>(z) * T_len * H + h;
      const int t0 = m0 + wk.r0, rows = wk.r1 - wk.r0;
      const float mu0 = stats[z * 4];
      const float rs0 = stats[z * 4 + 1];
      const float m2 = static_cast<float>(acc23[z * 2] / nhw);
      const float m3 = static_cast<float>(acc23[z * 2 + 1] / nhw);
      const float p = *p0;
      const float2 gw = make_float2(g0w[h], g0w[h + 1]);
      const float* be = b1_eff + static_cast<size_t>(z) * H + h;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (i >= rows) break;
        const float2 acc_s = tile_pair(tile, wk.r0 + i, wk.c);
        T* cell = dsc + base + static_cast<size_t>(t0 + i) * H;
        const float2 dn0 = load2(cell);
        float ds[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float s = (j == 0 ? acc_s.x : acc_s.y) + be[j];
          const float s0hat = (rnd<T>(prelu(s, p)) - mu0) * rs0;
          const float du =
              rs0 * ((j == 0 ? gw.x * dn0.x : gw.y * dn0.y) - m2 - s0hat * m3);
          dp0 += du * fminf(s, 0.0f);
          ds[j] = du * (s >= 0.0f ? 1.0f : p);
        }
        vec[0].x += ds[0];
        vec[0].y += ds[1];
        store2<T>(cell, ds[0], ds[1]);
      }
    }
    add_groups(vec, tile + kTile * kLdMN);
    if (threadIdx.x < 64 && h < H) put_pair(vpart, z, 1, 0, H, h, vec[0]);
    block_scalars(spart, z, dp0, 0.0);
  }
};

// dn0 by a gather of round(dv) at the mirrored shifts, accumulated in the
// stream's dtype, written to dn0_out for the ds epilogue; partials of
// dg0, dbe0 (vpart, 2 vectors) and of sum(g0w * dn0), sum(g0w * dn0 *
// s0hat) per sample (spart). A block walks 128 rows and 128 channels of
// one sample, as a product's tile, each tap's rows of round(dv) copied
// into shared memory by cp.async while the previous tap is summed.
// bf16: three blocks an SM (64 KB of taps each, at most 85 registers a
// thread); f32 takes 128 KB of taps, one block.
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 3 : 1)
    tcn_dn0_kernel(const T* __restrict__ u, const T* __restrict__ dvc,
                   const float* __restrict__ stats,
                   const float* __restrict__ g0w, const T* __restrict__ kd,
                   T* __restrict__ dn0_out, float* __restrict__ vpart,
                   double* __restrict__ spart,
                   int T_len, int H, int k, int dilation, int pad_lo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* taps = reinterpret_cast<T*>(smem_raw);  // two [kTile][kTile] buffers
  __shared__ __align__(8) float spare[3 * 2 * kTile];
  const int z = blockIdx.z;
  const int m0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  const Walk wk(T_len - m0);
  const int h = n0 + wk.c;
  const bool live = h < H;
  const int t0 = m0 + wk.r0, rows = wk.r1 - wk.r0;
  float2 dn0[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) dn0[i] = make_float2(0.0f, 0.0f);
  // adjoint of v[t'] += kd[kk] * n0[t' + kk * dilation - pad_lo]: tap kk
  // of dn0 reads round(dv) at t - kk * dilation + pad_lo
  stage_tap(taps, dvc, z, m0 + pad_lo, T_len, H, n0);
  for (int kk = 0; kk < k; ++kk) {
    if (kk + 1 < k) {
      stage_tap(taps + ((kk + 1) & 1) * kTile * kTile, dvc, z,
                m0 - (kk + 1) * dilation + pad_lo, T_len, H, n0);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const T* tap = taps + (kk & 1) * kTile * kTile;
      const float2 kdk = load2(kd + static_cast<size_t>(kk) * H + h);
      const int shift = pad_lo - kk * dilation;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int src = t0 + i + shift;
        if (i < rows && src >= 0 && src < T_len) {
          const float2 d = load2(tap + (wk.r0 + i) * kTile + wk.c);
          const float2 kd2 = rnd2<T>(make_float2(kdk.x * d.x, kdk.y * d.y));
          dn0[i] = rnd2<T>(make_float2(dn0[i].x + kd2.x, dn0[i].y + kd2.y));
        }
      }
    }
    __syncthreads();
  }
  float2 vec[2] = {make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f)};
  double acc2 = 0.0, acc3 = 0.0;
  if (live) {
    const size_t base = static_cast<size_t>(z) * T_len * H + h;
    const float mu0 = stats[z * 4];
    const float rs0 = stats[z * 4 + 1];
    const float2 gw = make_float2(g0w[h], g0w[h + 1]);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i >= rows) break;
      const size_t idx = base + static_cast<size_t>(t0 + i) * H;
      store2<T>(dn0_out + idx, dn0[i].x, dn0[i].y);
      const float2 uu = load2(u + idx);
      const float2 s0 = make_float2((uu.x - mu0) * rs0, (uu.y - mu0) * rs0);
      vec[0].x += dn0[i].x * s0.x;
      vec[0].y += dn0[i].y * s0.y;
      vec[1].x += dn0[i].x;
      vec[1].y += dn0[i].y;
      acc2 += gw.x * dn0[i].x;
      acc2 += gw.y * dn0[i].y;
      acc3 += gw.x * dn0[i].x * s0.x;
      acc3 += gw.y * dn0[i].y * s0.y;
    }
  }
  add_groups(vec, spare);
  if (threadIdx.x < 64 && live) {
    put_pair(vpart, z, 2, 0, H, h, vec[0]);
    put_pair(vpart, z, 2, 1, H, h, vec[1]);
  }
  block_scalars(spart, z, acc2, acc3);
}

// out [M, N] = a^T @ b over all R rows of a [R, M] and b [R, N], through
// `part` [splits, M, N], the rows split in runs of `per` (a multiple of
// 32, from ops/cuda_tcn.py `wgrad_rows`).
template <typename T>
cudaError_t wgrad(const T* a, const T* b, float* part, float* out,
                  long long R, int M, int N, long long per, Marks& mk,
                  cudaStream_t stream) {
  const int splits = static_cast<int>((R + per - 1) / per);
  const Operands<T> op{a, 0, M, b, N, M, N, R, per};
  TCN_CHECK(mk.done(launch_product<T, true>(op, EpiWgrad<T>{part, M, N}, splits,
                                            stream),
                    stream));
  // few splits over many elements: one thread an element
  return mk.done(sum_partials(part, out, 1, splits, M * N, M * N, stream),
                 stream);
}

// Floats of the backward's f32 scratch, region by region (ops/cuda_tcn.py
// `backward_plan` plans the same): first the f64 scalar partials and
// per-sample sums (two floats each), then the per-channel and weight
// partials.
struct Layout {
  size_t spart, acc01, acc23, vpart, wpart, total;
};

Layout layout(int B, int T_len, int C, int H, int k, long long per) {
  const size_t chunks =
      static_cast<size_t>(B) * ((T_len + kTile - 1) / kTile);
  const size_t vec_h = chunks * (1 + k) * H;
  const size_t vec_c = chunks * C;
  const long long rows = static_cast<long long>(B) * T_len;
  Layout l;
  l.spart = 0;
  l.acc01 = l.spart + 4 * static_cast<size_t>(B) * product_blocks(T_len, H);
  l.acc23 = l.acc01 + 4 * static_cast<size_t>(B);
  l.vpart = l.acc23 + 4 * static_cast<size_t>(B);
  l.wpart = l.vpart + (vec_h > vec_c ? vec_h : vec_c);
  l.total = l.wpart + static_cast<size_t>((rows + per - 1) / per) * H * C;
  return l;
}

struct Args {
  const void *x, *dy, *stats, *b1_eff, *w1, *w1t, *p0, *kd, *bd, *g0w, *g0b,
      *p1, *w2t, *g1w, *g1b;
  void *dx, *db1e, *dw1, *dw2, *dvec_dv, *dvec_g0, *dvec_g1, *db2, *dscal,
      *stream_ws, *f32_ws;
};

template <typename T>
cudaError_t backward(const Args& a, int B, int T_len, int C, int H, int k,
                     int dilation, int pad_lo, long long per, Marks& mk,
                     cudaStream_t stream) {
  const size_t n = static_cast<size_t>(B) * T_len * H;
  T* u = static_cast<T*>(a.stream_ws);
  T* n1c = u + n;
  T* dsc = n1c;  // round(n1) is dead once dW2 is formed: dn0, then ds
  T* dvc = n1c + n;
  const Layout l = layout(B, T_len, C, H, k, per);
  float* ws = static_cast<float*>(a.f32_ws);
  float* vpart = ws + l.vpart;
  float* wpart = ws + l.wpart;
  double* spart = reinterpret_cast<double*>(ws + l.spart);
  double* acc01 = reinterpret_cast<double*>(ws + l.acc01);
  double* acc23 = reinterpret_cast<double*>(ws + l.acc23);
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w2t = static_cast<const T*>(a.w2t);
  const T* kd = static_cast<const T*>(a.kd);
  const float* stats = static_cast<const float*>(a.stats);
  const float* b1_eff = static_cast<const float*>(a.b1_eff);
  const float* g0w = static_cast<const float*>(a.g0w);
  const float* g0b = static_cast<const float*>(a.g0b);
  const float* g1w = static_cast<const float*>(a.g1w);
  const float* g1b = static_cast<const float*>(a.g1b);
  const float* bd = static_cast<const float*>(a.bd);
  const float* p0 = static_cast<const float*>(a.p0);
  const float* p1 = static_cast<const float*>(a.p1);
  float* dscal = static_cast<float*>(a.dscal);
  const int chunks = (T_len + kTile - 1) / kTile;  // 128 rows each
  const int pblocks = product_blocks(T_len, H);      // partials a sample
  const double nhw = static_cast<double>(T_len) * H;
  const long long rows = static_cast<long long>(B) * T_len;
  // dy @ W2^T and x @ W1, over the rows of each sample
  const Operands<T> op_dn1{dy, static_cast<long long>(T_len) * C, C, w2t, H,
                           T_len, H, C, 0};
  const Operands<T> op_s{x, static_cast<long long>(T_len) * C, C, w1, H,
                         T_len, H, C, 0};

  TCN_CHECK(mk.done(cudaSuccess, stream));
  TCN_CHECK(mk.done(launch_product<T, false>(
                        op_s, EpiU<T>{u, b1_eff, p0, nullptr, T_len, H}, B,
                        stream),
                    stream));

  TCN_CHECK(mk.done(
      launch_product<T, false>(
          op_dn1,
          EpiGln1<T>{u, stats, g0w, g0b, kd, bd, g1w, g1b, p1, n1c, vpart,
                     spart, T_len, H, k, dilation, pad_lo},
          B, stream),
      stream));
  TCN_CHECK(mk.done(sum_slices(vpart, static_cast<float*>(a.dvec_g1), 1,
                                 B * chunks, 2 * H, 2 * H, stream),
                    stream));
  TCN_CHECK(mk.done(sum_slices(spart, acc01, B, pblocks, 2, 2, stream),
                    stream));

  TCN_CHECK(mk.done(
      launch_product<T, false>(
          op_dn1,
          EpiDv<T>{u, stats, acc01, g0w, g0b, kd, bd, g1w, p1, dvc, vpart,
                   spart, T_len, H, k, dilation, pad_lo, nhw},
          B, stream),
      stream));
  TCN_CHECK(mk.done(sum_slices(vpart, static_cast<float*>(a.dvec_dv), 1,
                                 B * chunks, (1 + k) * H, (1 + k) * H,
                                 stream),
                    stream));
  TCN_CHECK(mk.done(
      sum_slices(spart, dscal + 1, 1, B * pblocks, 2, 1, stream), stream));

  TCN_CHECK(wgrad<T>(n1c, dy, wpart, static_cast<float*>(a.dw2), rows, H, C,
                     per, mk, stream));

  tcn_colsum_kernel<T>
      <<<dim3(chunks, (C + kTile - 1) / kTile, B), kThreads, 0, stream>>>(
          dy, vpart, T_len, C);
  TCN_CHECK(mk.done(cudaGetLastError(), stream));
  TCN_CHECK(mk.done(sum_slices(vpart, static_cast<float*>(a.db2), 1,
                                 B * chunks, C, C, stream),
                    stream));

  TCN_CHECK(cudaFuncSetAttribute(tcn_dn0_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(tap_bytes<T>())));
  tcn_dn0_kernel<T><<<dim3(chunks, (H + kTile - 1) / kTile, B), kThreads,
                      tap_bytes<T>(), stream>>>(
      u, dvc, stats, g0w, kd, dsc, vpart, spart, T_len, H, k, dilation,
      pad_lo);
  TCN_CHECK(mk.done(cudaGetLastError(), stream));
  TCN_CHECK(mk.done(sum_slices(vpart, static_cast<float*>(a.dvec_g0), 1,
                                 B * chunks, 2 * H, 2 * H, stream),
                    stream));
  TCN_CHECK(mk.done(sum_slices(spart, acc23, B, pblocks, 2, 2, stream),
                    stream));

  TCN_CHECK(mk.done(
      launch_product<T, false>(
          op_s,
          EpiDs<T>{stats, acc23, b1_eff, g0w, p0, dsc, vpart, spart, T_len,
                   H, nhw},
          B, stream),
      stream));
  TCN_CHECK(mk.done(sum_slices(vpart, static_cast<float*>(a.db1e), B,
                                 chunks, H, H, stream),
                    stream));
  TCN_CHECK(mk.done(sum_slices(spart, dscal, 1, B * pblocks, 2, 1, stream),
                    stream));

  const Operands<T> op_dx{dsc, static_cast<long long>(T_len) * H, H,
                          static_cast<const T*>(a.w1t), C, T_len, C, H, 0};
  TCN_CHECK(mk.done(
      launch_product<T, false>(
          op_dx, EpiDx<T>{dy, static_cast<T*>(a.dx), T_len, C}, B, stream),
      stream));
  return wgrad<T>(x, dsc, wpart, static_cast<float*>(a.dw1), rows, C, H, per,
                  mk, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes by
// wesep_tpu_torch/ops/cuda_tcn.py. dtype: 0 = f32, 1 = bf16.
//
// x, dy [B, T, C], w1 [C, H], w1t = w1^T [H, C], kd [k, H], w2t = w2^T
// [C, H] in the stream's dtype; stats [B, 4], b1_eff [B, H], bd, g0w, g0b,
// g1w, g1b [H], p0, p1 [1] f32. Writes dx [B, T, C] in the stream's dtype
// and, in f32, db1e [B, H], dw1 [C, H], dw2 [H, C], dvec_dv [1 + k, H] =
// (dbd, dkd), dvec_g0 [2, H] = (dg0, dbe0), dvec_g1 [2, H] = (dg1, dbe1),
// db2 [C], dscal [2] = (dp0, dp1). wgrad_rows: rows of B * T per split of
// the weight-gradient products, a multiple of 32, at most 65535 splits.
// stream_ws holds n_stream elements of the stream's dtype (3 B T H) and
// f32_ws n_f32 floats (at least `layout`'s total). events: null, or
// n_events CUDA events, recorded before the first launch and after each
// in turn. All contiguous
// and 16-byte aligned; C % 8 == 0, H % 8 == 0, k <= 8. Returns the CUDA
// error code of the first launch that failed (0 on success) and never
// synchronises.
extern "C" int tcn_block_backward(
    const void* x, const void* dy, const void* stats, const void* b1_eff,
    const void* w1, const void* w1t, const void* p0, const void* kd,
    const void* bd, const void* g0w, const void* g0b, const void* p1,
    const void* w2t, const void* g1w, const void* g1b, void* dx, void* db1e,
    void* dw1, void* dw2, void* dvec_dv, void* dvec_g0, void* dvec_g1,
    void* db2, void* dscal, void* stream_ws, void* f32_ws, void* events,
    int B, int T_len, int C, int H, int k, int dilation, int pad_lo,
    int dtype, int n_events, long long wgrad_rows, long long n_stream,
    long long n_f32, void* stream) {
  if (tcn::bad_shape(B, T_len, C, H, k, dilation, pad_lo) ||
      wgrad_rows <= 0 || wgrad_rows % 32 != 0 ||
      (static_cast<long long>(B) * T_len + wgrad_rows - 1) / wgrad_rows >
          65535 ||
      n_stream < 3LL * B * T_len * H ||
      n_f32 < static_cast<long long>(
                  layout(B, T_len, C, H, k, wgrad_rows).total)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = {x,   dy,  stats, b1_eff, w1,  w1t,     p0,      kd,      bd,
                  g0w, g0b, p1,    w2t,    g1w, g1b,     dx,      db1e,    dw1,
                  dw2, dvec_dv, dvec_g0, dvec_g1, db2, dscal, stream_ws,
                  f32_ws};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tcn::Marks mk{static_cast<void* const*>(events), n_events, 0};
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = backward<float>(a, B, T_len, C, H, k, dilation, pad_lo, wgrad_rows,
                          mk, s);
  } else if (dtype == 1) {
    err = backward<__nv_bfloat16>(a, B, T_len, C, H, k, dilation, pad_lo,
                                  wgrad_rows, mk, s);
  }
  return static_cast<int>(err);
}
