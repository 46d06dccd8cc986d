// The bf16 forward and backward of the LSTM layers on Hopper's tensor cores
// and thread block clusters, shared by all four LSTM routes (entry points in
// lstm_forward_tc.cu and lstm_backward_tc.cu, whose headers describe the
// designs and their bounds).
//
// Three kernels:
//
// - `tc_product_kernel`, one tiled bf16 x bf16 -> f32 product
//   (mma.sync.m16n8k16, operands staged by a 3-stage cp.async ring, 16-byte
//   copies, fragments read by ldmatrix with or without .trans) in four
//   operand layouts (`Mode`):
//     kWgrad  dW[dir] = A^T @ dg[dir], reduced over a slice of the B * T rows
//             (split-K; partials in a fixed order);
//     kGates  G[dir]  = act(A @ [Wx ; Wh][dir] + (b or xw)), the gates of
//             every step, f32: sigmoid of i, f, o and tanh of g, with the
//             serial kernel's formulas (they need no carry);
//     kDx     dx[dir] = dg[dir] @ Wx[dir]^T, rounded to bf16;
//     kProject xw[dir] = x @ Wx[dir] + b, f32 and not activated: the
//             forward's input projection of every step (A's x part only),
//             written in the forward chain's order (ChainXw).
//   A[n] = [x row n ; h_{t-1}] is read in place from the stream and from y
//   shifted one step in the forward's direction (zero at the boundary), as
//   `Rows` says: rows of x [B * T, D] (kRowX), frames of unfold(ks, hs)
//   over x [B, L, C] in k-major order (kRowUnfold: element k * C + c, ks * C
//   contiguous values of x; the wrapper permutes Wx and the results to and
//   from the channel-major order of the weights), or h alone (kRowH).
// - `lstm_chain_kernel`, the serial adjoint with only the carry's product
//   on the chain, over clusters of kCluster blocks.
// - `lstm_forward_chain_kernel`, the forward recurrence from xw with only
//   h_{t-1} @ Wh on the chain, over clusters of kCluster blocks.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tc_common.cuh"

namespace lstm_tc {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// ---- PTX helpers (tc_common.cuh) ----------------------------------------

using tc::a_frag;
using tc::b_frag2;
using tc::b_load2;
using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ldsm_x4;
using tc::mma_bf16;
using tc::smem_addr;

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

// ---- where the forward chain reads xw -------------------------------------

// Blocks of a cluster of either chain kernel (the adjoint's and the
// forward's); a cluster of the forward chain takes kFwdRows batch rows of
// one direction (its design: lstm_forward_tc.cu). 64 rows keep the
// pBSRNN's band shape (2 x 512 rows) in one wave of 16 clusters and halve
// the comm shape's waves against 32 rows.
constexpr int kCluster = 4;
constexpr int kFwdRows = 64;

// The order in which the projection (kProject) writes xw for the forward
// chain: per direction, tile of kFwdRows batch rows and step, the [64, 4H]
// pre-activations as [rank][warp][piece][lane][4], so that each thread of
// the chain finds the values of its items (FwdShape, below) in 16-byte
// pieces and the 32 lanes of a warp read 512 contiguous bytes a piece. A
// piece holds one gate of a 16-row tile: rows gid and gid + 8 (the two
// halves), units 2 quad and 2 quad + 1: what one thread of the projection
// holds too, as it walks its rows step by step (t * ceil(B / 64) * 64 +
// b), so that it writes each piece whole. Rows of the last tile past B
// hold the bias (each row feeds only itself in the chain, which stores
// nothing for them).
//
// Element (dir, b, t, c) lies at row(dir, b, t) + col(c): with r = b % 64
// split into (row split, 16-row tile mi, half, r % 8) and c into (gate q,
// rank, 8-unit group, unit pair, unit % 2), a thread (warp (split, group),
// lane (r % 8, pair)) holds value ((mi * 4 + q) * 2 + half) * 2 + unit % 2
// of its step, in pieces of 4.
struct ChainXw {
  int H;
  int T;
  int tiles;  // ceil(B / kFwdRows)
  __host__ __device__ int groups() const { return H / kCluster / 8; }
  __host__ __device__ int splits() const { return groups() >= 6 ? 1 : 2; }
  // values of a thread a step (16 per 16-row tile of its warp)
  __host__ __device__ int values() const { return kFwdRows / splits(); }
  __host__ __device__ long long row(int dir, int b, int t) const {
    const int r = b % kFwdRows, rr = r % values();
    const long long slab =
        ((static_cast<long long>(dir) * tiles + b / kFwdRows) * T + t) *
        (kFwdRows * 4LL * H);
    return slab + (r / values()) * groups() * values() * 32 +
           (rr / 16) * 512 + (rr % 8) * 16 + ((rr / 8) % 2) * 2;
  }
  __host__ __device__ int col(int c) const {
    const int hu = H / kCluster, q = c / H, u = c % H;
    const int rank = u / hu, j = u % hu;
    return (rank * groups() * splits() + j / 8) * values() * 32 + q * 128 +
           ((j % 8) / 2) * 4 + j % 2;
  }
};

// ---- the product kernel ----------------------------------------------------

enum Mode { kWgrad = 0, kGates = 1, kDx = 2, kProject = 3 };

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
  // kGates, kProject: where the sums start, added to each once: the bias
  // [4H] f32 per direction, or (kGates) xw [dirs, rows, 4H] bf16 (then
  // bias is null)
  const float* bias[2];
  const bf16* xw;
};

// Operand shapes of a mode: the output is M x N, the reduction K long.
//   kWgrad: M = D + H, N = 4H, K = a slice of the rows (A^T staged [k][m],
//           dg staged [k][n]: both ldmatrix .trans)
//   kGates: M = rows, N = 4H, K = D + H (A staged [m][k]; W staged [k][n],
//           .trans)
//   kDx:    M = rows, N = D, K = 4H (dg staged [m][k]; Wx staged [n][k])
//   kProject: M = rows, N = 4H, K = D (staged as kGates)
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
    } else if constexpr (kMode == kGates || kMode == kProject) {  // [m][k]
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
    } else if constexpr (kMode == kGates || kMode == kProject) {
      // [k][n]: rows of [Wx ; Wh] (kProject: of Wx, as k_end is D)
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

// B rounded up to the forward chain's tiles of kFwdRows rows.
__device__ __forceinline__ int padded_batch(const Rows& g) {
  return (g.rows / g.T + kFwdRows - 1) / kFwdRows * kFwdRows;
}

// One block: a kBM x kBN tile of the output of direction dir (and, for
// kWgrad, of one split of the rows). blockIdx: kWgrad (m tile, n tile,
// split * dirs + dir); kProject (m tile * n tiles + n tile, 1, dir); the
// others (n tile, m tile, dir). Two blocks
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
    if constexpr (kMode == kProject) {
      // one grid dimension, column tiles fastest (an x tile is read by
      // the column tiles one after the other, from L2)
      const int n_tiles = (h4 + kBN - 1) / kBN;
      n0 = (blockIdx.x % n_tiles) * kBN;
      m0 = (blockIdx.x / n_tiles) * kBM;
    } else {
      n0 = blockIdx.x * kBN;
      m0 = blockIdx.y * kBM;
    }
    dir = blockIdx.z;
    k_begin = 0;
    k_end = kMode == kGates ? g.D + g.H : kMode == kProject ? g.D : h4;
    // kProject walks its rows step by step: t * padded + b
    M = kMode == kProject ? g.T * padded_batch(g) : g.rows;
    N = kMode == kDx ? g.D : h4;
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
    const int row =
        (kMode == kWgrad ? k_begin : m0) + a_row<kMode>(threadIdx.x, i);
    if constexpr (kMode == kProject) {
      // row t * padded + b of the walk: row b * T + t of x, none past B
      const int padded = padded_batch(g);
      cur[i].t = row / padded;
      cur[i].b = row - cur[i].t * padded;
      cur[i].n = cur[i].b < g.rows / g.T && cur[i].t < g.T
                     ? cur[i].b * g.T + cur[i].t
                     : g.rows;
    } else {
      cur[i].start(row, g.T);
    }
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
  if constexpr (kMode == kProject) {
    // both rows (batch rows b and b + 8 of step t) and both columns are
    // one 16-byte piece of the chain's order
    const int padded = padded_batch(g);
    const ChainXw order{g.H, g.T, padded / kFwdRows};
    float* out = static_cast<float*>(op.out);
    int col[NI];
    float2 bias[NI];
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int c = min(n0 + wn + ni * 8 + 2 * q, N - 2);
      col[ni] = order.col(c);
      bias[ni] = make_float2(op.bias[dir][c], op.bias[dir][c + 1]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int r = m0 + wm + mi * 16 + gid;
      if (r >= M) continue;
      const int t = r / padded;
      float* row = out + order.row(dir, r - t * padded, t);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        if (n0 + wn + ni * 8 >= N) continue;
        *reinterpret_cast<float4*>(row + col[ni]) = make_float4(
            acc[mi][ni][0] + bias[ni].x, acc[mi][ni][1] + bias[ni].y,
            acc[mi][ni][2] + bias[ni].x, acc[mi][ni][3] + bias[ni].y);
      }
    }
  } else {
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
          const float v0 = acc[mi][ni][2 * half];
          const float v1 = acc[mi][ni][2 * half + 1];
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
    const int n = kMode == kDx ? g.D : h4;
    if (kMode == kProject) {
      const long long m =
          static_cast<long long>(g.T) *
          ((g.rows / g.T + kFwdRows - 1) / kFwdRows * kFwdRows);
      grid = dim3(static_cast<unsigned>((m + kBM - 1) / kBM *
                                        ((n + kBN - 1) / kBN)),
                  1, g.dirs);
    } else {
      grid = dim3((n + kBN - 1) / kBN, (g.rows + kBM - 1) / kBM, g.dirs);
    }
  }
  kernel<<<grid, kThreads, smem, stream>>>(g, op);
  return cudaGetLastError();
}

// ---- the serial adjoint over a cluster --------------------------------------

// A cluster of kCluster blocks over kChainRows batch rows: block r owns
// H / kCluster hidden units. 8 rows per block keep every thread at H / 32
// items (a row and a unit each) whatever the cluster's size.
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

// ---- the forward recurrence over a cluster ---------------------------------

// Shapes of the forward chain at H = 32 * NT (ChainXw is its run-time
// twin). A warp owns one 8-unit group of the block's units, all four of
// their gates (4 column tiles of 8) and kWarpRows rows: it then holds i, f,
// g and o of its (row, unit) items in its own accumulators. H 256 and 192
// take 8 and 6 warps over all rows; H 128 and 64 split the rows in two (8
// and 4 warps).
template <int NT>
struct FwdShape {
  static constexpr int kH = 32 * NT;
  static constexpr int kHU = kH / kCluster;  // units of a block
  static constexpr int kOC = 4 * kHU;        // gate columns of a block
  static constexpr int kGroups = kHU / 8;    // 8-unit groups of a block
  static constexpr int kRowSplits = kGroups >= 6 ? 1 : 2;
  static constexpr int kWarps = kGroups * kRowSplits;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kWarpRows = kFwdRows / kRowSplits;
  static constexpr int kMI = kWarpRows / 16;  // 16-row tiles of a warp
  static constexpr int kValues = 16 * kMI;    // xw values of a thread a step
  static constexpr int kLdW = kOC + kPad;
  static constexpr int kLdH = kH + kPad;
  static constexpr size_t kW = sizeof(bf16) * kH * kLdW;
  static constexpr size_t kHBuf = sizeof(bf16) * kFwdRows * kLdH;
  static constexpr size_t kCs = sizeof(float) * kFwdRows * kHU;
  // Wh's slice, h at two parities, c's slice and two mbarriers
  static constexpr size_t kBytes = kW + 2 * kHBuf + kCs + 16;  // 214 KB
};

template <typename XW>
struct FwdArgs {
  // pre-activations x @ Wx + b: f32 in chain order (ChainXw, from the
  // projection), or bf16 [dirs, B, T, 4H] (the two-kernel layers)
  const XW* xw;
  const bf16* wh[2];  // [H, 4H] per direction
  bf16* y;            // [B, T, dirs * H] out
  float* cs;          // [B, T, dirs * H] out, or null
  int B;
  int T;
  int dirs;
  int reverse;
};

__device__ __forceinline__ void load_pair(const bf16* p, float* v) {
  const __nv_bfloat162 f = *reinterpret_cast<const __nv_bfloat162*>(p);
  v[0] = __low2float(f);
  v[1] = __high2float(f);
}

// __expf and the reciprocal of the special function unit (__fdividef):
// both within 2 units in the last place of f32, as tanhf's own are
__device__ __forceinline__ float sigmoid_f32(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}

// mbarriers in shared memory, and 16-byte stores into a peer block's shared
// memory that count their bytes on the peer's mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// The phase of `bar` of this parity has completed; a wait that never ends
// (a fault of the protocol) traps, a launch error, rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (long long spins = 0; !mbar_try_wait(bar, parity); ++spins) {
    if (spins > (1LL << 30)) __trap();
  }
}
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_addr(p)), "r"(rank));
  return out;
}
__device__ __forceinline__ void st_async16(uint32_t addr, const uint4& v,
                                           uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// Built with -DLSTM_CHAIN_PHASES the forward chain keeps its phases in
// g_phase_cycles as the adjoint does: 0 h product, 1 cell update, 2 block
// barrier, 3 exchange (h_t's slice to the peers), 4 the stores of y and cs,
// 5 the next step's loads, 6 wait, 7 loop top.
template <int NT, typename XW>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(FwdShape<NT>::kThreads, 1)
        lstm_forward_chain_kernel(FwdArgs<XW> a) {
  using S = FwdShape<NT>;
  constexpr int H = S::kH, HU = S::kHU, LDW = S::kLdW, LDH = S::kLdH;
  constexpr int MI = S::kMI, OC = S::kOC, NV = S::kValues;
  constexpr int h4 = 4 * H;
  constexpr int kHElems = kFwdRows * LDH;  // one parity of h
  // bytes of h_t the three peers send a block each step
  constexpr int kExchange = (kCluster - 1) * kFwdRows * HU * 2;
  // xw in chain order is f32 (from the projection); bf16 xw is in the
  // layers' own [dirs, B, T, 4H] order
  constexpr bool kChainOrder = sizeof(XW) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw);          // [H][LDW]
  bf16* h_s = reinterpret_cast<bf16*>(smem_raw + S::kW);  // [2][rows][LDH]
  float* cs_s =  // [rows][HU], c_t of the block's units
      reinterpret_cast<float*>(smem_raw + S::kW + 2 * S::kHBuf);
  // bar[p] counts the bytes of h the peers send into parity p of h_s
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + S::kW +
                                              2 * S::kHBuf + S::kCs);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / kCluster;
  const int dir = blockIdx.y;
  const int b0 = tile * kFwdRows;
  const int u0 = rank * HU;  // the block's first hidden unit
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool backwards = (a.dirs == 2 && dir != 0) != (a.reverse != 0);
  const int width = a.dirs * H;

  // the block's slice of Wh, once, each 8-unit group's four gates side by
  // side: w_s[k][grp * 32 + gate * 8 + j] = Wh[k][gate * H + u0 + grp * 8
  // + j]
  const bf16* wh = a.wh[dir];
  for (int i = tid; i < H * (OC / 8); i += S::kThreads) {
    const int k = i / (OC / 8), ch = i % (OC / 8);
    const int grp = ch / 4, gate = ch % 4;
    *reinterpret_cast<uint4*>(w_s + k * LDW + ch * 8) =
        *reinterpret_cast<const uint4*>(wh + static_cast<long long>(k) * h4 +
                                        gate * H + u0 + grp * 8);
  }
  // h_{-1} = 0 (parity 0)
  for (int i = tid; i < kHElems / 8; i += S::kThreads) {
    reinterpret_cast<uint4*>(h_s)[i] = make_uint4(0, 0, 0, 0);
  }
  // bar[1] takes h_0 (sent in step 0, read in step 1), bar[0] h_1
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(&bar[1], kExchange);
    mbar_expect_tx(&bar[0], kExchange);
  }
  // where this block's slice goes in each peer: both parities of h_s and
  // their mbarriers
  uint32_t peer_h[kCluster - 1], peer_bar[kCluster - 1];
#pragma unroll
  for (int p = 0; p < kCluster - 1; ++p) {
    const int peer = (rank + 1 + p) % kCluster;
    peer_h[p] = peer_addr(h_s, peer);
    peer_bar[p] = peer_addr(bar, peer);
  }

  // the thread's items: rows wr + mi * 16 + gid (+ 8) and units col, col +
  // 1 (of H) of the warp's group, the four gates of each; value v = ((mi *
  // 4 + gate) * 2 + half) * 2 + e of xv holds item (mi, half, e)'s gate
  const int grp = warp % S::kGroups;
  const int wr = (warp / S::kGroups) * S::kWarpRows;
  const int gid = lane >> 2, quad = lane & 3;
  const int col = u0 + grp * 8 + 2 * quad;

  // the pre-activations of the coming step, loaded after the step's
  // exchange and first read after the next wait; rows past B read row B -
  // 1 (the layers' order) or what the projection left there (chain order:
  // a row feeds only itself) and store nothing
  float xv[NV];
  auto load_step = [&](int s) {
    const int t = backwards ? a.T - 1 - s : s;
    if constexpr (kChainOrder) {
      // this thread's NV values lie in NV / 4 16-byte pieces, 512 bytes
      // apart: piece k of the 32 lanes is 512 contiguous bytes
      const float* p = reinterpret_cast<const float*>(a.xw) +
                       ((static_cast<long long>(dir) * gridDim.x / kCluster +
                         tile) * a.T + t) * (kFwdRows * h4) +
                       (rank * S::kWarps + warp) * NV * 32 + lane * 4;
#pragma unroll
      for (int k = 0; k < NV / 4; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(p + k * 128);
        xv[4 * k] = v.x;
        xv[4 * k + 1] = v.y;
        xv[4 * k + 2] = v.z;
        xv[4 * k + 3] = v.w;
      }
    } else {
      const long long rows = static_cast<long long>(a.B) * a.T;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int b = min(b0 + wr + mi * 16 + gid + half * 8, a.B - 1);
          const bf16* p = reinterpret_cast<const bf16*>(a.xw) +
                          (dir * rows + static_cast<long long>(b) * a.T + t) *
                              h4 + col;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            load_pair(p + q * H, xv + ((mi * 4 + q) * 2 + half) * 2);
          }
        }
      }
    }
  };

  float c[MI][2][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) c[mi][half][0] = c[mi][half][1] = 0.0f;

  load_step(0);
  // every block of the cluster runs and has its mbarriers set up; w_s and
  // h_s are written
  cluster.sync();
  int phase[2] = {0, 0};  // the next phase of bar[p] to wait for
#ifdef LSTM_CHAIN_PHASES
  long long phase_acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  long long phase_at = 0;
#endif
  for (int s = 0; s < a.T; ++s) {
    const int t = backwards ? a.T - 1 - s : s;
    const int par = s & 1;
    const bool last = s + 1 == a.T;
    if (s > 0) {
      // h_{t-1}'s slices from the peers are in parity par; then arm the
      // barrier for the slices of h_{t+1}, which go to the same parity
      mbar_wait(&bar[par], phase[par]);
      phase[par] ^= 1;
      if (tid == 0 && s + 2 < a.T) mbar_expect_tx(&bar[par], kExchange);
    }
    CHAIN_PHASE(6)
    const bf16* hp = h_s + par * kHElems;  // h_{t-1}
    bf16* hn = h_s + (par ^ 1) * kHElems;  // h_t

    // the block's gate columns of h_{t-1} @ Wh, [rows, OC] f32
    float acc[MI][4][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][q][e] = 0.0f;
#pragma unroll 4
    for (int k0 = 0; k0 < H; k0 += 16) {
      uint32_t b[4][2];
      b_load2<true>(b[0], b[1], w_s, LDW, k0, grp * 32, lane);
      b_load2<true>(b[2], b[3], w_s, LDW, k0, grp * 32 + 16, lane);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        uint32_t af[4];
        ldsm_x4<false>(af, a_frag<false>(hp, LDH, wr + mi * 16, k0, lane));
#pragma unroll
        for (int q = 0; q < 4; ++q) mma_bf16(acc[mi][q], af, b[q]);
      }
    }
    CHAIN_PHASE(0)

    // the cell update of every item: g = xw + h_{t-1} @ Wh in f32, c in
    // f32, h rounded to bf16 (as it enters the next product and y)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wr + mi * 16 + gid + half * 8;
        const float* x = xv + mi * 16 + half * 2;  // gate q at x[4 q + e]
        float hv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ig = sigmoid_f32(x[e] + acc[mi][0][2 * half + e]);
          const float fg = sigmoid_f32(x[4 + e] + acc[mi][1][2 * half + e]);
          const float gg = tanhf(x[8 + e] + acc[mi][2][2 * half + e]);
          const float og = sigmoid_f32(x[12 + e] + acc[mi][3][2 * half + e]);
          const float cv = fg * c[mi][half][e] + ig * gg;
          c[mi][half][e] = cv;
          hv[e] = og * tanhf(cv);
        }
        *reinterpret_cast<__nv_bfloat162*>(hn + r * LDH + col) =
            __floats2bfloat162_rn(hv[0], hv[1]);
        if (a.cs != nullptr) {
          *reinterpret_cast<float2*>(cs_s + r * HU + col - u0) =
              make_float2(c[mi][half][0], c[mi][half][1]);
        }
      }
    }
    CHAIN_PHASE(1)
    __syncthreads();  // the block's slices of h_t and c_t are in smem
    CHAIN_PHASE(2)
    // h_t's slice, 16 bytes at a time, into the same place of every peer's
    // hn, counted on the peer's bar[par ^ 1] (not after the last step: no
    // block reads it then). A peer writes this block's hn only after its
    // product of this step, which needs this block's h_{t-1}, sent after
    // this block's product of the step before: so no block writes a
    // parity of h_s that another still reads, and one barrier (the
    // peers' bytes) a step is enough.
    if (!last) {
      const uint32_t hn_off =
          static_cast<uint32_t>((par ^ 1) * kHElems * sizeof(bf16));
      for (int i = tid; i < kFwdRows * (HU / 8); i += S::kThreads) {
        const int at = (i / (HU / 8)) * LDH + u0 + (i % (HU / 8)) * 8;
        const uint4 v = *reinterpret_cast<const uint4*>(hn + at);
#pragma unroll
        for (int p = 0; p < kCluster - 1; ++p) {
          st_async16(peer_h[p] + hn_off + at * sizeof(bf16), v,
                     peer_bar[p] + (par ^ 1) * sizeof(uint64_t));
        }
      }
    }
    CHAIN_PHASE(3)
    // y and cs, 16 bytes at a time (the block's own columns of hn and cs_s
    // are written again only in the next step's cell update)
    const long long out_row = static_cast<long long>(b0) * a.T + t;
    for (int i = tid; i < kFwdRows * (HU / 8); i += S::kThreads) {
      const int r = i / (HU / 8), j = (i % (HU / 8)) * 8;
      if (b0 + r < a.B) {
        *reinterpret_cast<uint4*>(
            a.y + (out_row + static_cast<long long>(r) * a.T) * width +
            dir * H + u0 + j) =
            *reinterpret_cast<const uint4*>(hn + r * LDH + u0 + j);
      }
    }
    if (a.cs != nullptr) {
      for (int i = tid; i < kFwdRows * (HU / 4); i += S::kThreads) {
        const int r = i / (HU / 4), j = (i % (HU / 4)) * 4;
        if (b0 + r < a.B) {
          *reinterpret_cast<float4*>(
              a.cs + (out_row + static_cast<long long>(r) * a.T) * width +
              dir * H + u0 + j) =
              *reinterpret_cast<const float4*>(cs_s + r * HU + j);
        }
      }
    }
    CHAIN_PHASE(4)
    if (last) break;
    load_step(s + 1);
    CHAIN_PHASE(5)
  }
#ifdef LSTM_CHAIN_PHASES
  if ((tid == 0 || tid == S::kThreads - 1) && blockIdx.x < 8 &&
      blockIdx.y == 0) {
    for (int k = 0; k < 9; ++k) {
      g_phase_cycles[((tid ? 8 : 0) + blockIdx.x) * 16 + k] = phase_acc[k];
    }
  }
#endif
}

template <int NT, typename XW>
cudaError_t launch_forward_chain_nt(const FwdArgs<XW>& a,
                                    cudaStream_t stream) {
  auto kernel = lstm_forward_chain_kernel<NT, XW>;
  const size_t smem = FwdShape<NT>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (a.B + kFwdRows - 1) / kFwdRows;
  kernel<<<dim3(tiles * kCluster, a.dirs), FwdShape<NT>::kThreads, smem,
           stream>>>(a);
  return cudaGetLastError();
}

// How many clusters of the forward chain the card runs at once
// (cudaOccupancyMaxActiveClusters).
template <int NT>
cudaError_t forward_chain_clusters_nt(int* out) {
  auto kernel = lstm_forward_chain_kernel<NT, float>;
  const size_t smem = FwdShape<NT>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 1024, 1, 1);
  cfg.blockDim = dim3(FwdShape<NT>::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

}  // namespace lstm_tc
