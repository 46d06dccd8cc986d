// The bf16 backward of the LSTM layers on Hopper's tensor cores and thread
// block clusters, shared by all four LSTM routes (entry points in
// lstm_backward_tc.cu, whose header describes the design and its bounds).
//
// Two kernels:
//
// - `tc_product_kernel`, one tiled bf16 x bf16 -> f32 product
//   (mma.sync.m16n8k16, operands staged by a 3-stage cp.async ring, 16-byte
//   copies, fragments read by ldmatrix with or without .trans) in three
//   operand layouts (`Mode`):
//     kWgrad  dW[dir] = A^T @ dg[dir], reduced over a slice of the B * T rows
//             (split-K; partials in a fixed order);
//     kGates  G[dir]  = act(A @ [Wx ; Wh][dir] + (b or xw)), the gates of
//             every step, f32: sigmoid of i, f, o and tanh of g, with the
//             serial kernel's formulas (they need no carry);
//     kDx     dx[dir] = dg[dir] @ Wx[dir]^T, rounded to bf16.
//   A[n] = [x row n ; h_{t-1}] is read in place from the stream and from y
//   shifted one step in the forward's direction (zero at the boundary), as
//   `Rows` says: rows of x [B * T, D] (kRowX), frames of unfold(ks, hs)
//   over x [B, L, C] in k-major order (kRowUnfold: element k * C + c, ks * C
//   contiguous values of x; the wrapper permutes Wx and the results to and
//   from the channel-major order of the weights), or h alone (kRowH).
// - `lstm_chain_kernel`, the serial adjoint with only the carry's product
//   on the chain, over clusters of kCluster blocks.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace lstm_tc {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// ---- PTX helpers -----------------------------------------------------------

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

// ---- where row n of A = [x row ; h_{t-1}] lies ------------------------------

enum RowKind { kRowX = 0, kRowUnfold = 1, kRowH = 2 };

struct Rows {
  int D;      // length of the x part (0 for kRowH; ks * C for kRowUnfold)
  int H;
  int T;      // steps (frames) per sequence
  int L;      // kRowUnfold: raw rows per sequence
  int C;      // kRowUnfold: channels
  int hs;     // kRowUnfold: hop
  int dirs;   // directions of y's rows (width dirs * H)
  int reverse;
  int rows;   // B * T < 2^31
  // whether direction dir walked time from T-1 down (bilstm_common.cuh)
  __device__ __forceinline__ bool walks_back(int dir) const {
    return (dirs == 2 && dir != 0) != (reverse != 0);
  }
};

// A thread's place in the rows of A: row n = b * T + t. The copies of a
// stage are addressed from it without a division: `advance` moves it on
// by the rows of a stage.
struct Cursor {
  int n;
  int t;
  int b;
  __device__ __forceinline__ void start(int row, int T_len) {
    n = row;
    b = row / T_len;
    t = row - b * T_len;
  }
  __device__ __forceinline__ void advance(int rows, int T_len) {
    n += rows;
    t += rows;
    while (t >= T_len) {
      t -= T_len;
      ++b;
    }
  }
};

// The 8 values of A at (row c.n, columns m .. m + 7) of direction dir, m a
// multiple of 8 (D % 8 == 0, H % 8 == 0), or null where they are zero.
template <int kKind>
__device__ __forceinline__ const bf16* a_chunk(const Rows& g,
                                               const bf16* __restrict__ x,
                                               const bf16* __restrict__ y,
                                               int dir, const Cursor& c,
                                               int m) {
  if (c.n >= g.rows || m >= g.D + g.H) return nullptr;
  if (m < g.D) {
    if constexpr (kKind == kRowUnfold) {
      return x + (static_cast<long long>(c.b) * g.L +
                  static_cast<long long>(c.t) * g.hs) * g.C + m;
    } else {
      return x + static_cast<long long>(c.n) * g.D + m;
    }
  }
  const int step = g.walks_back(dir) ? 1 : -1;
  if (c.t + step < 0 || c.t + step >= g.T) return nullptr;
  return y + static_cast<long long>(c.n + step) * (g.dirs * g.H) +
         dir * g.H + (m - g.D);
}

// ---- the product kernel ----------------------------------------------------

enum Mode { kWgrad = 0, kGates = 1, kDx = 2 };

constexpr int kBM = 128;   // rows of the output tile
constexpr int kBN = 128;   // columns of the output tile
constexpr int kBK = 64;    // depth of a stage of kWgrad (32 for the others)
constexpr int kStages = 3;
constexpr int kThreads = 256;  // 8 warps: 2 (rows, 64 each) x 4 (cols, 32)
constexpr int kPad = 8;        // bf16 per smem row: odd 16-byte strides

struct Operands {
  const bf16* x;        // the stream (kRowX, kRowUnfold)
  const bf16* y;        // the forward's output [B, T, dirs * H]
  const bf16* dg;       // [dirs, rows, 4H] rounded dgates (kWgrad, kDx)
  const bf16* wx[2];    // [D, 4H] per direction (kGates, kDx)
  const bf16* wh[2];    // [H, 4H] per direction (kGates)
  void* out;            // see the modes
  int k_per_split;      // kWgrad: rows of the reduction per split, % kBK
  // kGates: where the gates start, added to each sum once: the bias [4H]
  // f32 per direction, or xw [dirs, rows, 4H] bf16 (then bias is null)
  const float* bias[2];
  const bf16* xw;
};

// Operand shapes of a mode: the output is M x N, the reduction K long.
//   kWgrad: M = D + H, N = 4H, K = a slice of the rows (A^T staged [k][m],
//           dg staged [k][n]: both ldmatrix .trans)
//   kGates: M = rows, N = 4H, K = D + H (A staged [m][k]; W staged [k][n],
//           .trans)
//   kDx:    M = rows, N = D, K = 4H (dg staged [m][k]; Wx staged [n][k])
template <int kMode>
struct Layout {
  static constexpr bool kATrans = kMode == kWgrad;
  static constexpr bool kBTrans = kMode != kDx;
  // the long reduction of kWgrad takes deep stages; the short ones of
  // kGates (K = D + H) and kDx (K = 4H) more, shallower stages
  static constexpr int kK = kMode == kWgrad ? kBK : 32;
  // copies of A a thread makes for a stage, one row (a Cursor) each
  static constexpr int kRowsA = kK * kBM / 8 / kThreads;
  static constexpr int kLdA = kATrans ? kBM + kPad : kK + kPad;
  static constexpr int kLdB = kBTrans ? kBN + kPad : kK + kPad;
  static constexpr int kSizeA = kATrans ? kK * kLdA : kBM * kLdA;
  static constexpr int kSizeB = kBTrans ? kK * kLdB : kBN * kLdB;
  static constexpr int kStage = kSizeA + kSizeB;  // bf16 elements
  static constexpr size_t kSmem = sizeof(bf16) * kStage * kStages;
};

// The A copies of thread `tid` for a stage: kWgrad row k0 + tid / 16 +
// 16 i (i < kRowsA), columns m0 + (tid % 16) * 8; kGates row m0 +
// tid / (kK / 8) + (kThreads / (kK / 8)) i, columns k0 + (tid % (kK / 8)) * 8.
template <int kMode>
__device__ __forceinline__ int a_row(int tid, int i) {
  using Lo = Layout<kMode>;
  return kMode == kWgrad ? tid / (kBM / 8) + i * (kThreads / (kBM / 8))
                         : tid / (Lo::kK / 8) + i * (kThreads / (Lo::kK / 8));
}

template <int kMode, int kKind>
__device__ __forceinline__ void load_stage(
    bf16* sa, bf16* sb, const Rows& g, const Operands& op, int dir, int m0,
    int n0, int k0, int k_end,
    const Cursor (&cur)[Layout<kMode>::kRowsA]) {
  using Lo = Layout<kMode>;
  const int h4 = 4 * g.H;
  const bf16* dummy = op.y;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < Lo::kK * kBM / 8 / kThreads; ++i) {  // A, 8 a chunk
    const int idx = tid + i * kThreads;
    if constexpr (kMode == kWgrad) {  // [k][m]: row n = k, columns m
      const int kk = idx / (kBM / 8), mc = idx % (kBM / 8);
      const bf16* src = k0 + kk < k_end
                            ? a_chunk<kKind>(g, op.x, op.y, dir, cur[i],
                                             m0 + mc * 8)
                            : nullptr;
      cp_async16(sa + kk * Lo::kLdA + mc * 8, src, dummy);
    } else if constexpr (kMode == kGates) {  // [m][k]: row n = m
      const int mm = idx / (Lo::kK / 8), kc = idx % (Lo::kK / 8);
      cp_async16(sa + mm * Lo::kLdA + kc * 8,
                 k0 + kc * 8 < k_end
                     ? a_chunk<kKind>(g, op.x, op.y, dir, cur[i], k0 + kc * 8)
                     : nullptr,
                 dummy);
    } else {  // kDx, [m][k]: dg rows
      const int mm = idx / (Lo::kK / 8), kc = idx % (Lo::kK / 8);
      const int n = m0 + mm;
      cp_async16(sa + mm * Lo::kLdA + kc * 8,
                 n < g.rows ? op.dg + (static_cast<long long>(dir) * g.rows +
                                       n) * h4 + k0 + kc * 8
                            : nullptr,
                 dummy);
    }
  }
#pragma unroll
  for (int i = 0; i < Lo::kK * kBN / 8 / kThreads; ++i) {  // B
    const int idx = tid + i * kThreads;
    if constexpr (kMode == kWgrad) {  // [k][n]: dg rows
      const int kk = idx / (kBN / 8), nc = idx % (kBN / 8);
      const int n = k0 + kk, c = n0 + nc * 8;
      cp_async16(sb + kk * Lo::kLdB + nc * 8,
                 (n < k_end && c < h4)
                     ? op.dg + (static_cast<long long>(dir) * g.rows + n) * h4 +
                           c
                     : nullptr,
                 dummy);
    } else if constexpr (kMode == kGates) {  // [k][n]: rows of [Wx ; Wh]
      const int kk = idx / (kBN / 8), nc = idx % (kBN / 8);
      const int k = k0 + kk, c = n0 + nc * 8;
      const bf16* src = nullptr;
      if (k < k_end && c < h4) {
        src = k < g.D ? op.wx[dir] + static_cast<long long>(k) * h4 + c
                      : op.wh[dir] + static_cast<long long>(k - g.D) * h4 + c;
      }
      cp_async16(sb + kk * Lo::kLdB + nc * 8, src, dummy);
    } else {  // kDx, [n][k]: rows of Wx
      const int nn = idx / (Lo::kK / 8), kc = idx % (Lo::kK / 8);
      const int j = n0 + nn;
      cp_async16(sb + nn * Lo::kLdB + kc * 8,
                 j < g.D ? op.wx[dir] + static_cast<long long>(j) * h4 + k0 +
                               kc * 8
                         : nullptr,
                 dummy);
    }
  }
}

// One block: a kBM x kBN tile of the output of direction dir (and, for
// kWgrad, of one split of the rows). blockIdx: kWgrad (m tile, n tile,
// split * dirs + dir); kGates and kDx (n tile, m tile, dir). Two blocks
// on an SM.
template <int kMode, int kKind>
__global__ void __launch_bounds__(kThreads, 2)
    tc_product_kernel(Rows g, Operands op) {
  using Lo = Layout<kMode>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int h4 = 4 * g.H;
  int m0, n0, dir, split = 0, k_begin, k_end, M, N;
  if constexpr (kMode == kWgrad) {
    m0 = blockIdx.x * kBM;
    n0 = blockIdx.y * kBN;
    dir = blockIdx.z % g.dirs;
    split = blockIdx.z / g.dirs;
    k_begin = split * op.k_per_split;
    k_end = min(k_begin + op.k_per_split, g.rows);
    M = g.D + g.H;
    N = h4;
  } else {
    n0 = blockIdx.x * kBN;
    m0 = blockIdx.y * kBM;
    dir = blockIdx.z;
    k_begin = 0;
    k_end = kMode == kGates ? g.D + g.H : h4;
    M = g.rows;
    N = kMode == kGates ? h4 : g.D;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * 64;   // the warp's rows in the tile
  const int wn = (warp >> 1) * 32;  // and columns
  constexpr int NI = 4;             // its 8-column tiles

  float acc[4][NI][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < NI; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.0f;

  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + Lo::kK - 1) / Lo::kK : 0;
  // the rows of A this thread copies: fixed for kGates, moved on by a
  // stage's rows after each stage for kWgrad
  Cursor cur[Lo::kRowsA];
#pragma unroll
  for (int i = 0; i < Lo::kRowsA; ++i) {
    cur[i].start(
        (kMode == kWgrad ? k_begin : m0) + a_row<kMode>(threadIdx.x, i), g.T);
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      bf16* st = smem + s * Lo::kStage;
      load_stage<kMode, kKind>(st, st + Lo::kSizeA, g, op, dir, m0, n0,
                               k_begin + s * Lo::kK, k_end, cur);
      if constexpr (kMode == kWgrad) {
#pragma unroll
        for (int i = 0; i < Lo::kRowsA; ++i) cur[i].advance(Lo::kK, g.T);
      }
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free again
    const int next = kt + kStages - 1;
    if (next < n_tiles) {
      bf16* st = smem + (next % kStages) * Lo::kStage;
      load_stage<kMode, kKind>(st, st + Lo::kSizeA, g, op, dir, m0, n0,
                               k_begin + next * Lo::kK, k_end, cur);
      if constexpr (kMode == kWgrad) {
#pragma unroll
        for (int i = 0; i < Lo::kRowsA; ++i) cur[i].advance(Lo::kK, g.T);
      }
    }
    cp_async_commit();

    const bf16* sa = smem + (kt % kStages) * Lo::kStage;
    const bf16* sb = sa + Lo::kSizeA;
#pragma unroll
    for (int ks = 0; ks < Lo::kK; ks += 16) {
      uint32_t af[4][4];
      uint32_t bfr[NI][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        ldsm_x4<Lo::kATrans>(
            af[mi], a_frag<Lo::kATrans>(sa, Lo::kLdA, wm + mi * 16, ks, lane));
      }
#pragma unroll
      for (int ni = 0; ni < NI; ni += 2) {
        b_load2<Lo::kBTrans>(bfr[ni], bfr[ni + 1], sb, Lo::kLdB, ks,
                             wn + ni * 8, lane);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();

  // epilogue: thread (group gid, quad q) holds rows gid and gid + 8 of each
  // 16 x 8 tile, columns 2q and 2q + 1
  const int gid = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm + mi * 16 + gid + half * 8;
      if (r >= M) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int c = n0 + wn + ni * 8 + 2 * q;
        if (c >= N) continue;
        const float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        if constexpr (kMode == kWgrad) {
          float* out = static_cast<float*>(op.out) +
                       ((static_cast<long long>(split) * g.dirs + dir) * M +
                        r) * N + c;
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
        } else if constexpr (kMode == kGates) {
          const long long at =
              (static_cast<long long>(dir) * g.rows + r) * N + c;
          float b0, b1;
          if (op.xw != nullptr) {
            const __nv_bfloat162 xv =
                *reinterpret_cast<const __nv_bfloat162*>(op.xw + at);
            b0 = __low2float(xv);
            b1 = __high2float(xv);
          } else {
            b0 = op.bias[dir][c];
            b1 = op.bias[dir][c + 1];
          }
          // columns c and c + 1 lie in one gate (H is even): g is tanh,
          // i, f and o are sigmoids
          float a0 = v0 + b0, a1 = v1 + b1;
          if (c / g.H == 2) {
            a0 = tanhf(a0);
            a1 = tanhf(a1);
          } else {
            a0 = 1.0f / (1.0f + expf(-a0));
            a1 = 1.0f / (1.0f + expf(-a1));
          }
          *reinterpret_cast<float2*>(static_cast<float*>(op.out) + at) =
              make_float2(a0, a1);
        } else {
          bf16* out = static_cast<bf16*>(op.out) +
                      (static_cast<long long>(dir) * g.rows + r) * N + c;
          *reinterpret_cast<__nv_bfloat162*>(out) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <int kMode, int kKind>
cudaError_t launch_product(const Rows& g, const Operands& op, int splits,
                           cudaStream_t stream) {
  auto kernel = tc_product_kernel<kMode, kKind>;
  const size_t smem = Layout<kMode>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int h4 = 4 * g.H;
  dim3 grid;
  if (kMode == kWgrad) {
    grid = dim3((g.D + g.H + kBM - 1) / kBM, (h4 + kBN - 1) / kBN,
                g.dirs * splits);
  } else {
    const int n = kMode == kGates ? h4 : g.D;
    grid = dim3((n + kBN - 1) / kBN, (g.rows + kBM - 1) / kBM, g.dirs);
  }
  kernel<<<grid, kThreads, smem, stream>>>(g, op);
  return cudaGetLastError();
}

// ---- the serial adjoint over a cluster --------------------------------------

// A cluster of kCluster blocks over kChainRows batch rows: block r owns
// H / kCluster hidden units. 8 rows per block keep every thread at H / 32
// items (a row and a unit each) whatever the cluster's size.
constexpr int kCluster = 4;
constexpr int kChainRows = 8 * kCluster;
constexpr int kChainThreads = 256;

// Built with -DLSTM_CHAIN_PHASES (tools/lstm_chain_phases.py), the chain
// reads clock64() at the borders of each phase of a step, and threads 0
// and 255 of blocks 0-7 of direction 0 keep each phase's cycles summed over
// the steps: slot ((tid ? 8 : 0) + block) * 16 + phase. Phases: 0
// elementwise, 1 block barrier, 2 dh product, 3 scatter, 4 arrive, 5 next
// loads, 6 wait, 7 partial sums, 8 loop top.
#ifdef LSTM_CHAIN_PHASES
__device__ long long g_phase_cycles[2 * 8 * 16];
#define CHAIN_PHASE(k)                        \
  {                                           \
    const long long c_ = clock64();           \
    if (s > 0) phase_acc[k] += c_ - phase_at; \
    phase_at = c_;                            \
  }
#else
#define CHAIN_PHASE(k)
#endif

struct ChainArgs {
  const float* g;        // [dirs, B, T, 4H] gates (i, f, g, o activated)
  const bf16* wh[2];     // [H, 4H] per direction
  const float* cs;       // [B, T, dirs * H]
  const bf16* dy;        // [B, T, dirs * H]
  bf16* dg;              // [dirs, B, T, 4H] out, rounded dgates
  float* db_part;        // [ceil(B / kChainRows), dirs, 4H] out
  int B;
  int T;
  int dirs;
  int reverse;
};

// Shared memory of a block at H = 32 * NT, with HU = H / kCluster: the
// block's slice of Wh [H][4 * HU (+ pad)] bf16, the tile's rounded dgates
// [kChainRows][4 * HU (+ pad)] bf16 and the partial-dh exchange
// [2][kCluster][kChainRows][HU] f32 (two parities, one slot per sender).
template <int NT>
struct ChainSmem {
  static constexpr int kH = 32 * NT;
  static constexpr int kHU = kH / kCluster;  // units of a block
  static constexpr int kOC = 4 * kHU;        // gate columns of a block
  static constexpr int kLd = kOC + kPad;
  static constexpr size_t kW = sizeof(bf16) * kH * kLd;
  static constexpr size_t kDg = sizeof(bf16) * kChainRows * kLd;
  static constexpr size_t kEx =
      sizeof(float) * 2 * kCluster * kChainRows * kHU;
  static constexpr size_t kBytes = kW + kDg + kEx;
};

template <int NT>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kChainThreads, 1) lstm_chain_kernel(ChainArgs a) {
  using S = ChainSmem<NT>;
  constexpr int H = S::kH, HU = S::kHU, OC = S::kOC, LD = S::kLd;
  constexpr int h4 = 4 * H;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw);                 // [H][LD]
  bf16* dg_s = reinterpret_cast<bf16*>(smem_raw + S::kW);  // [rows][LD]
  float* ex_s = reinterpret_cast<float*>(smem_raw + S::kW + S::kDg);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / kCluster;
  const int dir = blockIdx.y;
  const int b0 = tile * kChainRows;
  const int u0 = rank * HU;  // the block's first hidden unit
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool backwards = (a.dirs == 2 && dir != 0) != (a.reverse != 0);
  const int width = a.dirs * H;
  const long long rows = static_cast<long long>(a.B) * a.T;

  // the block's slice of Wh, once: w_s[k][gate * HU + j] = Wh[k][gate * H +
  // u0 + j]
  const bf16* wh = a.wh[dir];
  for (int i = tid; i < H * (OC / 8); i += kChainThreads) {
    const int k = i / (OC / 8), ch = i % (OC / 8);
    const int gate = ch / (HU / 8), j = (ch % (HU / 8)) * 8;
    *reinterpret_cast<uint4*>(w_s + k * LD + ch * 8) =
        *reinterpret_cast<const uint4*>(wh + static_cast<long long>(k) * h4 +
                                        gate * H + u0 + j);
  }

  // item i of a thread: row it / HU, unit it % HU of the tile, it = tid +
  // i * 256 (NT items)
  float dh[NT], dc[NT], db[NT][4];
  // the raw inputs of the coming step: loaded between the arrive and the
  // wait of a step's barrier and first read after it, so that no load
  // waits on the chain
  float gv[NT][4], c_t[NT], c_p[NT];
  bf16 dy_t[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    dh[i] = dc[i] = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) db[i][q] = 0.0f;
  }

  // the step's inputs of every item, into registers: G, c_t, c_{t-1}, dy_t;
  // rows past B read row B - 1 and c_{t-1} at the boundary reads c_t, and
  // the elementwise part zeroes them: no branch, no use of a loaded value
  auto load_step = [&](int s) {
    const int t = backwards ? s : a.T - 1 - s;
    const int tp = backwards ? t + 1 : t - 1;
    const int dt = (tp >= 0 && tp < a.T) ? tp - t : 0;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int it = tid + i * kChainThreads;
      const int b = min(b0 + it / HU, a.B - 1), u = u0 + it % HU;
      const long long n = static_cast<long long>(b) * a.T + t;
      const float* gp = a.g + (dir * rows + n) * h4 + u;
#pragma unroll
      for (int q = 0; q < 4; ++q) gv[i][q] = gp[q * H];
      const long long at = n * width + dir * H + u;
      c_t[i] = a.cs[at];
      c_p[i] = a.cs[at + dt * static_cast<long long>(width)];
      dy_t[i] = a.dy[at];
    }
  };

  load_step(0);
  cluster.sync();  // every block of the cluster runs, and w_s is loaded

  const int gid = lane >> 2, quad = lane & 3;
  // the warp's rows of the dh product (MI 16-row tiles) and its units
  constexpr int MI = kChainRows / 32;
  const int wr = (warp & 1) * (kChainRows / 2);
  const int wu = (warp >> 1) * (8 * NT);  // and its units (of H)
#ifdef LSTM_CHAIN_PHASES
  long long phase_acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  long long phase_at = 0;
#endif
  for (int s = 0; s < a.T; ++s) {
    CHAIN_PHASE(8)
    const int t = backwards ? s : a.T - 1 - s;
    const int tp = backwards ? t + 1 : t - 1;
    const bool has_prev = tp >= 0 && tp < a.T;
    const int par = s & 1;
    // dgates, elementwise, with the rounding points of bilstm_bwd_kernel;
    // rows past B read row B - 1's gates but no dy, dh or dc, so their
    // dgates are zero
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int it = tid + i * kChainThreads;
      const int r = it / HU, j = it % HU;
      const int b = b0 + r;
      const bool valid = b < a.B;
      const float ig = gv[i][0], fg = gv[i][1], gg = gv[i][2], og = gv[i][3];
      const float tc = tanhf(valid ? c_t[i] : 0.0f);
      const float cp = (valid && has_prev) ? c_p[i] : 0.0f;
      const float dh_total =
          (valid ? __bfloat162float(dy_t[i]) : 0.0f) + dh[i];
      const float d_o = dh_total * tc;
      const float dct = dh_total * og * (1.0f - tc * tc) + dc[i];
      float d[4];
      d[0] = (dct * gg) * ig * (1.0f - ig);
      d[1] = (dct * cp) * fg * (1.0f - fg);
      d[2] = (dct * ig) * (1.0f - gg * gg);
      d[3] = d_o * og * (1.0f - og);
      dc[i] = dct * fg;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        db[i][q] += d[q];  // the bias sums the unrounded dgates
        const bf16 lp = __float2bfloat16(d[q]);
        dg_s[r * LD + q * HU + j] = lp;
        if (valid) {
          a.dg[(dir * rows + static_cast<long long>(b) * a.T + t) * h4 +
               q * H + u0 + j] = lp;
        }
      }
    }
    CHAIN_PHASE(0)
    if (s + 1 == a.T) break;  // the last step's dh is not needed
    __syncthreads();  // the tile's rounded dgates are in dg_s
    CHAIN_PHASE(1)

    // this block's part of dh = dg @ Wh^T: its own gate columns only,
    // [kChainRows, H] f32, one 16 x 8 x 16 product at a time
    float acc[MI][NT][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.0f;
#pragma unroll
    for (int k0 = 0; k0 < OC; k0 += 16) {
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        ldsm_x4<false>(af[mi], a_frag<false>(dg_s, LD, wr + mi * 16, k0,
                                             lane));
      }
#pragma unroll
      for (int ni = 0; ni < NT; ni += 2) {
        uint32_t b0[2], b1[2];
        b_load2<false>(b0, b1, w_s, LD, k0, wu + ni * 8, lane);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_bf16(acc[mi][ni], af[mi], b0);
          mma_bf16(acc[mi][ni + 1], af[mi], b1);
        }
      }
    }
    CHAIN_PHASE(2)
    // scatter: unit u's partial goes to the block that owns u, into slot
    // `rank` of its exchange buffer of this parity
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int u = wu + ni * 8 + 2 * quad;
      float* remote = cluster.map_shared_rank(ex_s, u / HU);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wr + mi * 16 + gid + half * 8;
          *reinterpret_cast<float2*>(
              remote + ((par * kCluster + rank) * kChainRows + r) * HU +
              u % HU) = make_float2(acc[mi][ni][2 * half],
                                    acc[mi][ni][2 * half + 1]);
        }
      }
    }
    CHAIN_PHASE(3)
    // one cluster barrier a step, split: the next step's loads go out
    // between its arrive and its wait
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    CHAIN_PHASE(4)
    load_step(s + 1);
    CHAIN_PHASE(5)
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    CHAIN_PHASE(6)
    // dh of the block's own units: the kCluster partials, in rank order
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int it = tid + i * kChainThreads;
      const int r = it / HU, j = it % HU;
      float sum = 0.0f;
#pragma unroll
      for (int src = 0; src < kCluster; ++src) {
        sum += ex_s[((par * kCluster + src) * kChainRows + r) * HU + j];
      }
      dh[i] = sum;
    }
    CHAIN_PHASE(7)
  }
#ifdef LSTM_CHAIN_PHASES
  if ((tid == 0 || tid == 255) && blockIdx.x < 8 && blockIdx.y == 0) {
    for (int k = 0; k < 9; ++k) {
      g_phase_cycles[((tid ? 8 : 0) + blockIdx.x) * 16 + k] = phase_acc[k];
    }
  }
#endif

  // db of the tile: each item's sum over steps, then over the tile's rows
  // in order; the exchange buffer is free (no block writes to it after
  // the last barrier, and this block has read it)
  __syncthreads();
  float* db_s = ex_s;  // [kChainRows][OC]
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int it = tid + i * kChainThreads;
    const int r = it / HU, j = it % HU;
#pragma unroll
    for (int q = 0; q < 4; ++q) db_s[r * OC + q * HU + j] = db[i][q];
  }
  __syncthreads();
  for (int col = tid; col < OC; col += kChainThreads) {
    float sum = 0.0f;
    for (int r = 0; r < kChainRows; ++r) sum += db_s[r * OC + col];
    const int q = col / HU, j = col % HU;
    a.db_part[(static_cast<long long>(tile) * a.dirs + dir) * h4 + q * H +
              u0 + j] = sum;
  }
}

template <int NT>
cudaError_t launch_chain_nt(const ChainArgs& a, cudaStream_t stream) {
  auto kernel = lstm_chain_kernel<NT>;
  const size_t smem = ChainSmem<NT>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (a.B + kChainRows - 1) / kChainRows;
  kernel<<<dim3(tiles * kCluster, a.dirs), kChainThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace lstm_tc
