// The f32 backward of the four LSTM layers, redesigned for Hopper (sm_90a):
// the gate recompute, dx and the weight gradients as tiled FMA products over
// every step at once, and a serial adjoint that keeps only the carry's
// product dh = dg @ Wh^T on its chain, with Wh held in registers over a
// thread-block cluster. Every product and the elementwise adjoint run in f32
// on the FMA units (TF32 tensor cores would change the result; 3xTF32 broke
// the f32 limits of the TCN block).
//
// Replaces, for f32 streams whose shapes pass the route gate of
// wesep_tpu_torch/ops/cuda_lstm_f32.py (`f32_backward_fits`), the backward
// of four Pallas TPU kernels of wesep_tpu/ops/pallas_lstm.py:
// `_bi_layer_backward` (the custom VJP of `bilstm_layer`, K0b),
// `_bi_unfold_backward` (of `bilstm_layer_unfold`, K3b), `_bi_backward` (of
// `bilstm_fused`, K2b) and `_bwd_impl` (of `lstm_fused`, K1b). f32 is what
// the joint v2 recipes train their separators in (everything after the
// speaker fuse is promoted to f32) and what the gradient checks run. Shapes
// the gate refuses keep the FMA kernels of bilstm_backward.cuh, and bf16
// streams the tensor-core backward of lstm_backward_tc.cu.
//
// The adjoint of step t (per direction, walking the forward's steps back):
//   g      = x_t @ Wx + h_{t-1} @ Wh + b     (or xw_t + h_{t-1} @ Wh)
//   dgates = f(g, c_t, c_{t-1}, dy_t + dh, dc)      all in f32, not rounded
//   dh     = dg @ Wh^T                       (the only carried product)
//   dx_t   = dg @ Wx^T;  dW += [x_t ; h_{t-1}]^T @ dg;  db += sum(dgates)
// Only dh depends on the previous adjoint step. So four launches:
//
// 1. `lstm_f32_gates`: G = act([x ; h_{t-1}] @ [Wx ; Wh] + b) (or act(xw +
//    h_{t-1} @ Wh), the two-kernel layers) for every step at once: the
//    128 x 128 FMA tile of lstm_forward_f32.cu's projection (8 x 8 sums a
//    thread, two shared-memory stages, the next stage's loads issued into
//    registers before the current stage's sums) with K = D + H. A row is x
//    (or the k-major unfold frame) read in place beside the saved y shifted
//    one step in the forward's direction, zero at the boundary. G is stored
//    activated (sigmoid i, f, o; tanh g) in the chain's order (as the
//    forward's F32ChainXw: [rank][row][unit j][gate q] per tile of R rows and
//    step), so that a chain thread finds the four gates of its (row, unit)
//    item in one 16-byte piece. G is 2 * B * T * 4H f32 (1.58 GB at the
//    pBSRNN's training band), alive until the chain has run.
// 2. `lstm_f32_adjoint`, the serial adjoint over thread-block clusters of
//    H / 32 blocks (8 at H 256, 6 at H 192) over R batch rows of one
//    direction (R of 8, 12, 16, 20 or 32, chosen per call from the clusters
//    the card runs at once, as for the forward chain). Block `rank` owns
//    units [32 rank, 32 rank + 32) and their four gate columns; lane j of
//    warp w owns the items (row w + 8 i, unit j), keeping their dc and
//    their db sums (of the unrounded dgates) in registers. A step: dh of the
//    items, the sum of the H / 32 blocks' partials in rank order; the
//    dgates; dg to the stream and, as [row][unit j][gate q], into shared
//    memory; one block barrier; the block's partial dh[r, k] = sum over its
//    128 columns c of dg[r, c] Wh[k, c] for all H values of k: warp w
//    (w < H / 32) takes k in [32 w, 32 w + 32), the units of block w; its
//    lane l holds rows 32 w + 2 (l % 16) and + 1 of Wh over the half l / 16
//    of the block's columns in registers (2 x 64 f32, 128 KB a block at H
//    256, loaded once) and reads dg as 16-byte loads that the half-warp
//    shares (the halves 4 banks apart, so a warp's load is one wavefront:
//    8 FMAs a load), four rows at a time; one shuffle adds the two halves
//    (the same bits in both, the sum being commutative); each half-warp
//    sends two of the four rows into slot `rank` of block w's exchange
//    buffer (st.async into distributed shared memory, 8 bytes a lane and
//    row, counted on block w's mbarrier of the step's parity; the own slot
//    by a plain store); the next step's G, c and dy
//    loaded into registers; one block barrier. No cluster barrier: a block
//    writes parity p of a peer's buffer at step s + 2 only after it has
//    received that peer's partials of step s + 1, which the peer sends after
//    reading parity p at step s + 1, so the double buffer is never
//    overwritten while it is read. The owner adds its H / 32 slots in rank
//    order: the same bits from run to run. db: each item's sum over steps,
//    then over the tile's R rows in order, then (the wrapper) over the tiles
//    in order.
// 3. `lstm_f32_dx` (K0 and K3 only): dx = dg @ Wx^T per direction, the same
//    FMA tile with K = 4H; the wrapper adds the two directions in a fixed
//    order. The two-kernel layers form dx outside their kernels, as the JAX
//    package does.
// 4. `lstm_f32_wgrad`: dW = [x ; h_{t-1}]^T @ dg per direction, the same
//    tile over a slice of the B * T rows (16-byte loads of the x, y and dg
//    rows), one partial a slice, added by the wrapper in a fixed order.
//
// What bounds them on this card (67 TFLOP/s f32 outside the tensor cores,
// 3.35 TB/s), at the pBSRNN's training band shape (B' 512, T 376, D 128,
// H 256, both directions). The gates and dW are 3.0e11 operations each
// (4.5 ms at the peak), dx 1.0e11 (1.5 ms). The chain is bound by its 376
// dependent steps: a step costs each SM R * H * 128 FMAs (R * H issue cycles
// of its four schedulers), a shared load of dg for every 8 of them, the
// elementwise adjoint, two block barriers and the exchange's round
// trip between SMs (tools/lstm_chain_phases.py --chain f32bwd builds this
// file with -DLSTM_CHAIN_PHASES to count the cycles of each part). The FMA
// kernel it replaces re-read Wx, Wh and their transposes from L2 in every
// step of every block (~3.1 MB a block and step) and ran the gate recompute
// and dx inside its serial loop.

#include "lstm_tc.cuh"

namespace lstm_f32_bwd {

using lstm_tc::Cursor;
using lstm_tc::kRowH;
using lstm_tc::kRowUnfold;
using lstm_tc::kRowX;
using lstm_tc::mbar_expect_tx;
using lstm_tc::mbar_init;
using lstm_tc::mbar_wait;
using lstm_tc::peer_addr;
namespace cg = cooperative_groups;

// ---- the products -----------------------------------------------------------

constexpr int kBM = 128;       // rows of a block's output tile
constexpr int kBN = 128;       // columns
constexpr int kBK = 16;        // depth of a stage
constexpr int kPadA = 4;       // padding of the A tile's rows
constexpr int kPadB = 16;      // padding of the B tile's rows
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 sums each

enum Mode { kGates = 0, kDx = 1, kWgrad = 2 };

// Where the gates product writes G for the chain: per direction, tile of R
// batch rows and step, the [R, 4H] activated gates as [rank][row][unit j]
// [gate q], so that value (dir, b, t, q * H + 32 rank + j) lies at
// at(dir, b, t, rank) + j * 4 + q (the layout of lstm_forward_f32.cu's
// F32ChainXw). Rows of the last tile past B are never written; the chain
// reads them as zero.
struct ChainG {
  int H;
  int T;
  int R;
  int tiles;  // ceil(B / R)
  __host__ __device__ long long at(int dir, int b, int t, int rank) const {
    return ((static_cast<long long>(dir) * tiles + b / R) * T + t) *
               (static_cast<long long>(R) * 4 * H) +
           (static_cast<long long>(rank) * R + b % R) * 128;
  }
};

struct ProductArgs {
  const float* x;        // the stream (kRowX, kRowUnfold), or null
  const float* y;        // [B, T, dirs * H] (kGates, kWgrad)
  const float* dg;       // [dirs, B * T, 4H] (kDx, kWgrad)
  const float* wx[2];    // [D, 4H] per direction (k-major for kRowUnfold)
  const float* wh[2];    // [H, 4H] per direction (kGates)
  const float* bias[2];  // [4H] per direction (kGates of K0, K3), or null
  const float* xw;       // [dirs, B, T, 4H] (kGates of K1, K2), or null
  float* out;            // G in ChainG / dx2 [dirs, B * T, D] /
                         // dw_part [splits, dirs, D + H, 4H]
  int kind;
  int B;
  int T;
  int D;
  int L;
  int C;
  int hs;
  int H;
  int dirs;
  int reverse;
  int rows;             // B * T
  int rows_per_split;   // kWgrad
  ChainG order;         // kGates
  __device__ __forceinline__ bool walks_back(int dir) const {
    return (dirs == 2 && dir != 0) != (reverse != 0);
  }
};

// The first of the D values of the x part of row m = b * T + t of A: a row
// of x, or the k-major frame t of unfold(D / C, hs) over x[b].
__device__ __forceinline__ const float* x_row(const ProductArgs& p, int b,
                                              int t) {
  if (p.kind == kRowUnfold) {
    return p.x + (static_cast<long long>(b) * p.L +
                  static_cast<long long>(t) * p.hs) * p.C;
  }
  return p.x + (static_cast<long long>(b) * p.T + t) * p.D;
}

// The first of the H values of h_{t-1} of row (b, t) of direction dir, or
// null at the boundary (zero).
__device__ __forceinline__ const float* h_row(const ProductArgs& p, int dir,
                                              int b, int t) {
  const int step = p.walks_back(dir) ? 1 : -1;
  if (t + step < 0 || t + step >= p.T) return nullptr;
  return p.y + (static_cast<long long>(b) * p.T + t + step) * (p.dirs * p.H) +
         dir * p.H;
}

// The i-th of a thread's 8 rows (or columns) of the tile: two runs of four,
// 64 apart, so that a warp's 16-byte reads of a tile row meet in no bank.
__device__ __forceinline__ int tile_index(int t16, int i) {
  return i < 4 ? 4 * t16 + i : 64 + 4 * t16 + (i - 4);
}

__device__ __forceinline__ float sigmoid_precise(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// One block: the 128 x 128 output tile of one direction (and, for kWgrad,
// one slice of the B * T rows). blockIdx: (m tile, n tile, dir) for kGates
// and kDx, (row tile of dW, column tile, split * dirs + dir) for kWgrad.
//   kGates: rows m = b * T + t of A = [x part ; h_{t-1}], columns the four
//           gates of 32 units (in the chain's order: column 4 j + q of the
//           tile is gate q of unit 32 rank + j, rank = n0 / 128), K = D + H;
//           each stage stages 8 consecutive k of A row tid / 2 transposed,
//           and 8 consecutive units of gate q of row tid / 16 of [Wx ; Wh]
//           in the tile's order.
//   kDx:    rows m of dg, columns d of Wx (both read 8 consecutive values of
//           the 4H axis and staged transposed), K = 4H.
//   kWgrad: rows k of [x part ; h_{t-1}] over its columns, columns of dg,
//           K the rows of a slice; both tiles staged as they lie, 16 bytes
//           a copy (float4 i of a stage: row i / 32, columns 4 (i % 32)).
template <int kMode>
__global__ void __launch_bounds__(kThreads, 2)
    f32_product_kernel(ProductArgs p) {
  __shared__ __align__(16) float as[2][kBK][kBM + kPadA];
  __shared__ __align__(16) float bs[2][kBK][kBN + kPadB];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int H = p.H, h4 = 4 * H, K1 = p.D + H;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  int dir, split = 0, k_len;
  long long n_begin = 0, n_end = 0;
  if constexpr (kMode == kWgrad) {
    dir = blockIdx.z % p.dirs;
    split = blockIdx.z / p.dirs;
    n_begin = static_cast<long long>(split) * p.rows_per_split;
    n_end = min(n_begin + p.rows_per_split, static_cast<long long>(p.rows));
    k_len = static_cast<int>(n_end - n_begin);
  } else {
    dir = blockIdx.z;
    k_len = kMode == kGates ? K1 : h4;
  }

  // kGates / kDx: the thread's A row and the 8 k it stages
  const int am = tid >> 1, ak = (tid & 1) * 8;
  const float* a_x = nullptr;  // kGates: x part of the row; kDx: dg row
  const float* a_h = nullptr;  // kGates: h_{t-1} of the row
  // kGates: the [Wx ; Wh] row, gate and first unit the thread stages
  const int bk = tid >> 4, bq = (tid & 15) >> 2, bj = (tid & 3) * 8;
  const int rank = n0 / kBN;
  // kDx: the Wx row (column d of the tile) the thread stages
  const float* b_row = nullptr;
  // kWgrad: the two rows a thread stages, their columns and cursors
  Cursor cur[2];
  const int wcol = (tid & 31) * 4, wrow = tid >> 5;  // rows wrow, wrow + 8
  if constexpr (kMode == kGates) {
    const int m = m0 + am;
    if (m < p.rows) {
      const int b = m / p.T, t = m - b * p.T;
      if (p.D > 0) a_x = x_row(p, b, t);
      a_h = h_row(p, dir, b, t);
    }
  } else if constexpr (kMode == kDx) {
    const int m = m0 + am;
    if (m < p.rows) {
      a_x = p.dg + (static_cast<long long>(dir) * p.rows + m) * h4;
    }
    const int d = n0 + am;
    if (d < p.D) b_row = p.wx[dir] + static_cast<long long>(d) * h4;
  } else {
    cur[0].start(static_cast<int>(n_begin) + wrow, p.T);
    cur[1].start(static_cast<int>(n_begin) + wrow + 8, p.T);
  }
  const float* dg_dir =
      kMode == kWgrad ? p.dg + static_cast<long long>(dir) * p.rows * h4
                      : nullptr;

  float4 ra[2], rb[2];
  auto fetch = [&](int k0) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    ra[0] = ra[1] = rb[0] = rb[1] = z;
    if constexpr (kMode == kGates) {
      const int k = k0 + ak;
      const float* src = nullptr;
      if (k < p.D) {
        src = a_x == nullptr ? nullptr : a_x + k;
      } else if (k < K1 && a_h != nullptr) {
        src = a_h + (k - p.D);
      }
      if (src != nullptr) {
        ra[0] = *reinterpret_cast<const float4*>(src);
        ra[1] = *reinterpret_cast<const float4*>(src + 4);
      }
      const int kb = k0 + bk;
      if (kb < K1) {
        const float* w =
            kb < p.D ? p.wx[dir] + static_cast<long long>(kb) * h4
                     : p.wh[dir] + static_cast<long long>(kb - p.D) * h4;
        w += bq * H + rank * 32 + bj;
        rb[0] = *reinterpret_cast<const float4*>(w);
        rb[1] = *reinterpret_cast<const float4*>(w + 4);
      }
    } else if constexpr (kMode == kDx) {
      if (a_x != nullptr) {
        ra[0] = *reinterpret_cast<const float4*>(a_x + k0 + ak);
        ra[1] = *reinterpret_cast<const float4*>(a_x + k0 + ak + 4);
      }
      if (b_row != nullptr) {
        rb[0] = *reinterpret_cast<const float4*>(b_row + k0 + ak);
        rb[1] = *reinterpret_cast<const float4*>(b_row + k0 + ak + 4);
      }
    } else {
      // rows n of the slice: A's columns m0 + wcol .. + 3 and dg's n0 +
      // wcol .. + 3
      const int kc = m0 + wcol;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const Cursor& c = cur[q];
        if (k0 + wrow + 8 * q >= k_len) continue;
        const float* src = nullptr;
        if (kc < p.D) {
          src = x_row(p, c.b, c.t) + kc;
        } else if (kc < K1) {
          const float* h = h_row(p, dir, c.b, c.t);
          if (h != nullptr) src = h + (kc - p.D);
        }
        if (src != nullptr) ra[q] = *reinterpret_cast<const float4*>(src);
        rb[q] = *reinterpret_cast<const float4*>(
            dg_dir + static_cast<long long>(c.n) * h4 + n0 + wcol);
      }
    }
  };
  auto stage = [&](int buf) {
    if constexpr (kMode == kWgrad) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        *reinterpret_cast<float4*>(&as[buf][wrow + 8 * q][wcol]) = ra[q];
        *reinterpret_cast<float4*>(&bs[buf][wrow + 8 * q][wcol]) = rb[q];
      }
      cur[0].advance(kBK, p.T);
      cur[1].advance(kBK, p.T);
    } else {
      const float av[8] = {ra[0].x, ra[0].y, ra[0].z, ra[0].w,
                           ra[1].x, ra[1].y, ra[1].z, ra[1].w};
      const float bv[8] = {rb[0].x, rb[0].y, rb[0].z, rb[0].w,
                           rb[1].x, rb[1].y, rb[1].z, rb[1].w};
#pragma unroll
      for (int j = 0; j < 8; ++j) as[buf][ak + j][am] = av[j];
      if constexpr (kMode == kDx) {
#pragma unroll
        for (int j = 0; j < 8; ++j) bs[buf][ak + j][am] = bv[j];
      } else {
        // unit bj + (i + rot) % 8 is stored i-th, so that the stores of a
        // warp (4 values of bj, 4 gates, 2 rows 16 banks apart) meet in no
        // bank (as lstm_forward_f32.cu stages Wx)
        const int rot = bj >> 3;
        float v1[8], v2[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          v1[i] = (rot & 1) ? bv[(i + 1) & 7] : bv[i];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          v2[i] = (rot & 2) ? v1[(i + 2) & 7] : v1[i];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          bs[buf][bk][(bj + ((i + rot) & 7)) * 4 + bq] = v2[i];
        }
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  fetch(0);
  stage(0);
  __syncthreads();
  const int stages = (k_len + kBK - 1) / kBK;
  for (int s = 0; s < stages; ++s) {
    const int buf = s & 1;
    if (s + 1 < stages) fetch((s + 1) * kBK);  // in flight over the sums
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][kk][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[buf][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[buf][kk][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (s + 1 < stages) {
      stage(buf ^ 1);  // the other buffer: last read a stage ago
      __syncthreads();
    }
  }

  if constexpr (kMode == kGates) {
    // columns 4 tx .. 4 tx + 3 and 64 + 4 tx .. are the four gates of units
    // j = tx and 16 + tx of rank n0 / 128: one 16-byte piece each, plus the
    // bias (or xw), activated
    const int u = rank * 32 + tx;
    float4 base[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                      make_float4(0.f, 0.f, 0.f, 0.f)};
    if (p.bias[dir] != nullptr) {
      const float* bias = p.bias[dir] + u;
      base[0] = make_float4(bias[0], bias[H], bias[2 * H], bias[3 * H]);
      base[1] = make_float4(bias[16], bias[H + 16], bias[2 * H + 16],
                            bias[3 * H + 16]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + tile_index(ty, i);
      if (m >= p.rows) continue;
      const int b = m / p.T, t = m - b * p.T;
      float* out = p.out + p.order.at(dir, b, t, rank);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float4 add = base[half];
        if (p.xw != nullptr) {
          const float* xw = p.xw + (static_cast<long long>(dir) * p.rows + m) *
                                       h4 + u + 16 * half;
          add = make_float4(xw[0], xw[H], xw[2 * H], xw[3 * H]);
        }
        const float* v = acc[i] + 4 * half;
        *reinterpret_cast<float4*>(out + 64 * half + 4 * tx) = make_float4(
            sigmoid_precise(v[0] + add.x), sigmoid_precise(v[1] + add.y),
            tanhf(v[2] + add.z), sigmoid_precise(v[3] + add.w));
      }
    }
  } else {
    // row-major outputs: dx2 [dirs, B * T, D] or dw_part [splits, dirs,
    // D + H, 4H]; 16-byte pieces of four columns
    const int M = kMode == kDx ? p.rows : K1;
    const int N = kMode == kDx ? p.D : h4;
    float* out = kMode == kDx
                     ? p.out + static_cast<long long>(dir) * p.rows * p.D
                     : p.out + (static_cast<long long>(split) * p.dirs + dir) *
                                   K1 * h4;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + tile_index(ty, i);
      if (m >= M) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = n0 + 64 * half + 4 * tx;
        if (n >= N) continue;
        *reinterpret_cast<float4*>(out + static_cast<long long>(m) * N + n) =
            make_float4(acc[i][4 * half], acc[i][4 * half + 1],
                        acc[i][4 * half + 2], acc[i][4 * half + 3]);
      }
    }
  }
}

// ---- the serial adjoint over a cluster --------------------------------------

// Shapes of the adjoint chain at H = 32 * NT over R rows (a multiple of 4):
// NT blocks a cluster, 8 warps a block whatever H is (the first NT of them
// run the dh product, two values of k over half the columns a lane);
// shared memory holds the tile's dgates [R][kLd] f32 (column c = 4 j + q,
// unit j, gate q, at c + 4 (c >= 64): the two halves of a row 4 banks
// apart), the partial-dh exchange [2 parities][NT senders][R][32 units] f32
// and an mbarrier per parity.
constexpr int kChainWarps = 8;
constexpr int kLd = 132;  // floats of a row of the dgates tile

template <int NT, int R>
struct AdjointShape {
  static_assert(R % 4 == 0, "the dh product takes rows four at a time");
  static constexpr int kH = 32 * NT;
  static constexpr int kThreads = 32 * kChainWarps;
  static constexpr int kItems = (R + kChainWarps - 1) / kChainWarps;
  static constexpr size_t kDg = sizeof(float) * R * kLd;
  static constexpr size_t kEx = sizeof(float) * 2 * NT * R * 32;
  static constexpr size_t kBars = sizeof(uint64_t) * 2;
  static constexpr size_t kBytes = kDg + kEx + kBars;  // <= 81 KB
};

struct AdjointArgs {
  const float* g;       // ChainG: the gates, activated
  const float* wh[2];   // [H, 4H] per direction
  const float* cs;      // [B, T, dirs * H]
  const float* dy;      // [B, T, dirs * H]
  float* dg;            // [dirs, B, T, 4H] out, the dgates
  float* db_part;       // [ceil(B / R), dirs, 4H] out
  int B;
  int T;
  int dirs;
  int reverse;
};

__device__ __forceinline__ void st_async8(uint32_t addr, float v0, float v1,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "r"(__float_as_uint(v0)), "r"(__float_as_uint(v1)), "r"(bar)
      : "memory");
}

// Built with -DLSTM_F32_MAXNREG=N (tools/lstm_f32_regcap.py) the chain is
// held to N registers a thread by __maxnreg__ instead of its launch bounds
// (which -maxrregcount does not override), so that a second build
// allocates its registers otherwise.
#ifdef LSTM_F32_MAXNREG
#define ADJOINT_REGISTERS(threads) __maxnreg__(LSTM_F32_MAXNREG)
#else
#define ADJOINT_REGISTERS(threads) __launch_bounds__(threads, 1)
#endif

// Built with -DLSTM_CHAIN_PHASES the chain keeps its phases in
// g_phase_cycles (lstm_tc.cuh) as the other chains do: 0 wait and the sum
// of the partials, 1 the elementwise adjoint with the dg stores, 2 block
// barrier, 3 the dh product with the exchange, 4 the next step's loads,
// 5 the step's last block barrier.
template <int NT, int R>
__global__ void __cluster_dims__(NT, 1, 1)
    ADJOINT_REGISTERS(32 * kChainWarps)
        f32_adjoint_kernel(AdjointArgs a) {
  using S = AdjointShape<NT, R>;
  constexpr int H = S::kH, h4 = 4 * H, ITEMS = S::kItems;
  constexpr int W = kChainWarps;
  // bytes of the partial dh a peer sends a block each step (its R rows of
  // the block's 32 units), and what a block receives from all its peers
  constexpr int kSlice = R * 32 * 4;
  constexpr int kExpect = (NT - 1) * kSlice;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dg_s = reinterpret_cast<float*>(smem_raw);  // [R][kLd]
  float* ex = reinterpret_cast<float*>(smem_raw + S::kDg);  // [2][NT][R][32]
  // bar[p] counts the bytes the peers send into parity p of ex
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + S::kDg + S::kEx);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / NT, tiles = gridDim.x / NT;
  const int dir = blockIdx.y;
  const int b0 = tile * R;
  const int u0 = rank * 32;  // the block's first hidden unit
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool backwards = (a.dirs == 2 && dir != 0) != (a.reverse != 0);
  const int width = a.dirs * H;
  const ChainG order{H, a.T, R, tiles};

  // lane (kp, half) of the first NT warps: rows k = 32 warp + 2 kp and k +
  // 1 of Wh[:, own columns] over the columns c = 64 half + c' (unit c / 4,
  // gate c % 4), once: w[kk][c'] = Wh[k + kk][(c % 4) H + u0 + c / 4]
  const bool product = warp < NT;
  const int kp = lane & 15, half = lane >> 4;
  float w[2][64];
  {
    const float* wh =
        a.wh[dir] + static_cast<long long>(product ? 32 * warp + 2 * kp : 0) *
                        h4 + u0 + 16 * half;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          w[kk][4 * j + q] = product ? wh[kk * h4 + q * H + j] : 0.f;
        }
  }
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(&bar[0], kExpect);
    mbar_expect_tx(&bar[1], kExpect);
  }

  // the thread's items: rows warp + 8 i (< R) of the tile, unit u0 + lane;
  // the coming step's gates, c_t, c_{t-1} and dy in registers, loaded
  // before the step's wait (rows past B read as zero and store nothing)
  float dh[ITEMS], dc[ITEMS], db[ITEMS][4];
  float gv[ITEMS][4], c_t[ITEMS], c_p[ITEMS], dy_t[ITEMS];
  auto load_step = [&](int s) {
    const int t = backwards ? s : a.T - 1 - s;
    const int tp = backwards ? t + 1 : t - 1;  // the forward's previous step
    const bool has_prev = tp >= 0 && tp < a.T;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int r = warp + W * i, b = b0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      c_t[i] = c_p[i] = dy_t[i] = 0.0f;
      if (r < R && b < a.B) {
        v = *reinterpret_cast<const float4*>(a.g + order.at(dir, b, t, rank) +
                                             lane * 4);
        const long long at =
            (static_cast<long long>(b) * a.T + t) * width + dir * H + u0 +
            lane;
        c_t[i] = a.cs[at];
        if (has_prev) c_p[i] = a.cs[at + static_cast<long long>(tp - t) *
                                             width];
        dy_t[i] = a.dy[at];
      }
      gv[i][0] = v.x;
      gv[i][1] = v.y;
      gv[i][2] = v.z;
      gv[i][3] = v.w;
    }
  };
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    dh[i] = dc[i] = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) db[i][q] = 0.0f;
  }

  load_step(0);
  // every block of the cluster runs and has its mbarriers set up
  cluster.sync();
  // bit p: the next phase of the barrier of parity p to wait for
  int phases = 0;
#ifdef LSTM_CHAIN_PHASES
  long long phase_acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  long long phase_at = 0;
#endif
  for (int s = 0; s < a.T; ++s) {
    const int t = backwards ? s : a.T - 1 - s;
    const int par = s & 1;
    if (s > 0) {
      // the peers' partials of the step before are in parity par ^ 1; the
      // first thread then arms that barrier for the partials of step s + 1
      // (no peer sends them before this block's partials of step s, sent
      // after the block barrier below)
      const int pp = par ^ 1;
      mbar_wait(&bar[pp], (phases >> pp) & 1);
      phases ^= 1 << pp;
      if (tid == 0 && s + 2 < a.T) mbar_expect_tx(&bar[pp], kExpect);
      const float* slots = ex + pp * NT * R * 32;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int r = warp + W * i;
        if (r >= R) break;
        float sum = slots[r * 32 + lane];
#pragma unroll
        for (int src = 1; src < NT; ++src) {
          sum += slots[(src * R + r) * 32 + lane];
        }
        dh[i] = sum;
      }
    }
    CHAIN_PHASE(0)

    // the dgates of the thread's items, in f32 (bilstm_bwd_kernel's
    // formulas); dg to shared memory and the stream
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int r = warp + W * i;
      if (r >= R) break;
      const float ig = gv[i][0], fg = gv[i][1], gg = gv[i][2], og = gv[i][3];
      const float tc = tanhf(c_t[i]);
      const float dh_total = dy_t[i] + dh[i];
      const float d_o = dh_total * tc;
      const float dct = dh_total * og * (1.0f - tc * tc) + dc[i];
      float d[4];
      d[0] = (dct * gg) * ig * (1.0f - ig);
      d[1] = (dct * c_p[i]) * fg * (1.0f - fg);
      d[2] = (dct * ig) * (1.0f - gg * gg);
      d[3] = d_o * og * (1.0f - og);
      dc[i] = dct * fg;
#pragma unroll
      for (int q = 0; q < 4; ++q) db[i][q] += d[q];
      *reinterpret_cast<float4*>(dg_s + r * kLd + 4 * lane + 4 * half) =
          make_float4(d[0], d[1], d[2], d[3]);
      const int b = b0 + r;
      if (b < a.B) {
        float* out = a.dg + ((static_cast<long long>(dir) * a.B + b) * a.T +
                             t) * h4 + u0 + lane;
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q * H] = d[q];
      }
    }
    CHAIN_PHASE(1)
    __syncthreads();  // the tile's dgates are in dg_s
    CHAIN_PHASE(2)
    if (s + 1 == a.T) break;  // the last step's dh is not needed

    if (product) {
      // the partial dh[r][k] of the lane's two k over the block's 128
      // columns, rows four at a time: each half of the columns summed in
      // column order, then the two halves added; warp w's k are block w's
      // units: its rows go into slot `rank` of block w's parity par, half
      // h sending rows rg + 2 h and + 1
      const float* dg_h = dg_s + 68 * half;
      float* own = ex + (par * NT + rank) * R * 32 + 2 * kp;
      const uint32_t to = peer_addr(own, warp);
      const uint32_t to_bar = peer_addr(&bar[par], warp);
#pragma unroll 1
      for (int rg = 0; rg < R; rg += 4) {
        float acc[4][2];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) acc[rr][0] = acc[rr][1] = 0.0f;
#pragma unroll
        for (int c4 = 0; c4 < 16; ++c4) {
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const float4 v = *reinterpret_cast<const float4*>(
                dg_h + (rg + rr) * kLd + 4 * c4);
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              float x = acc[rr][kk];
              x = fmaf(v.x, w[kk][4 * c4], x);
              x = fmaf(v.y, w[kk][4 * c4 + 1], x);
              x = fmaf(v.z, w[kk][4 * c4 + 2], x);
              x = fmaf(v.w, w[kk][4 * c4 + 3], x);
              acc[rr][kk] = x;
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            acc[rr][kk] += __shfl_xor_sync(0xffffffffu, acc[rr][kk], 16);
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rr = 2 * half + i;
          const float v0 = half ? acc[2 + i][0] : acc[i][0];
          const float v1 = half ? acc[2 + i][1] : acc[i][1];
          if (warp == rank) {
            *reinterpret_cast<float2*>(own + (rg + rr) * 32) =
                make_float2(v0, v1);
          } else {
            st_async8(to + (rg + rr) * 32 * 4, v0, v1, to_bar);
          }
        }
      }
    }
    CHAIN_PHASE(3)
    load_step(s + 1);
    CHAIN_PHASE(4)
    // the own slot is written for every warp's next sums, and no warp
    // still reads dg_s
    __syncthreads();
    CHAIN_PHASE(5)
  }
#ifdef LSTM_CHAIN_PHASES
  if ((tid == 0 || tid == S::kThreads - 1) && blockIdx.x < 8 &&
      blockIdx.y == 0) {
    for (int k = 0; k < 9; ++k) {
      lstm_tc::g_phase_cycles[((tid ? 8 : 0) + blockIdx.x) * 16 + k] =
          phase_acc[k];
    }
  }
#endif

  // db of the tile: each item's sum over steps, then over the tile's rows
  // in order; ex is free (every peer's partials have been received, and
  // every thread has read them before the last block barrier)
  float* db_s = ex;  // [R][4 gates][32 units]; NT >= 2, so it fits
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int r = warp + W * i;
    if (r >= R) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) db_s[r * 128 + q * 32 + lane] = db[i][q];
  }
  __syncthreads();
  if (tid < 128) {
    float sum = 0.0f;
    for (int r = 0; r < R; ++r) sum += db_s[r * 128 + tid];
    const int q = tid >> 5, j = tid & 31;
    a.db_part[(static_cast<long long>(tile) * a.dirs + dir) * h4 + q * H +
              u0 + j] = sum;
  }
}

template <int NT, int R>
cudaError_t launch_adjoint(const AdjointArgs& a, cudaStream_t stream) {
  auto kernel = f32_adjoint_kernel<NT, R>;
  const size_t smem = AdjointShape<NT, R>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (a.B + R - 1) / R;
  kernel<<<dim3(tiles * NT, a.dirs), AdjointShape<NT, R>::kThreads, smem,
           stream>>>(a);
  return cudaGetLastError();
}

// Rows a cluster the chain takes: 8, 12, 16, 20 and 32.
template <int NT>
cudaError_t adjoint_nt(const AdjointArgs& a, int rows, cudaStream_t s) {
  switch (rows) {
    case 8: return launch_adjoint<NT, 8>(a, s);
    case 12: return launch_adjoint<NT, 12>(a, s);
    case 16: return launch_adjoint<NT, 16>(a, s);
    case 20: return launch_adjoint<NT, 20>(a, s);
    case 32: return launch_adjoint<NT, 32>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// How many clusters of the adjoint chain the card runs at once
// (cudaOccupancyMaxActiveClusters).
template <int NT, int R>
cudaError_t clusters_at_once(int* out) {
  auto kernel = f32_adjoint_kernel<NT, R>;
  const size_t smem = AdjointShape<NT, R>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NT * 1024, 1, 1);
  cfg.blockDim = dim3(AdjointShape<NT, R>::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = NT;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

template <int NT>
cudaError_t clusters_nt(int* out, int rows) {
  switch (rows) {
    case 8: return clusters_at_once<NT, 8>(out);
    case 12: return clusters_at_once<NT, 12>(out);
    case 16: return clusters_at_once<NT, 16>(out);
    case 20: return clusters_at_once<NT, 20>(out);
    case 32: return clusters_at_once<NT, 32>(out);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_rows(int rows) {
  return rows != 8 && rows != 12 && rows != 16 && rows != 20 && rows != 32;
}

bool bad_hidden(int H) {
  return H != 64 && H != 128 && H != 192 && H != 256;
}

// The geometry of A's rows and of the direction(s) a product takes.
bool bad_rows_of_a(int kind, int B, int T, int D, int L, int C, int hs, int H,
                   int dirs, int reverse) {
  if (B <= 0 || T <= 0 || D < 0 || D % 8 != 0 || bad_hidden(H) || dirs < 1 ||
      dirs > 2 || reverse < 0 || reverse > 1 || (dirs == 2 && reverse) ||
      static_cast<long long>(B) * T >= (1LL << 31)) {
    return true;
  }
  if (kind == kRowX) return D == 0;
  if (kind == kRowUnfold) {
    return C <= 0 || C % 8 != 0 || D == 0 || D % C != 0 || hs <= 0 ||
           L < D / C || (L - D / C) / hs + 1 != T;
  }
  return kind != kRowH || D != 0;
}

ProductArgs product_args(const void* x, const void* y, const void* dg,
                         const void* out, int kind, int B, int T, int D,
                         int L, int C, int hs, int H, int dirs, int reverse) {
  ProductArgs p{};
  p.x = static_cast<const float*>(x);
  p.y = static_cast<const float*>(y);
  p.dg = static_cast<const float*>(dg);
  p.out = static_cast<float*>(const_cast<void*>(out));
  p.kind = kind;
  p.B = B;
  p.T = T;
  p.D = D;
  p.L = L;
  p.C = C;
  p.hs = hs;
  p.H = H;
  p.dirs = dirs;
  p.reverse = reverse;
  p.rows = B * T;
  return p;
}

}  // namespace lstm_f32_bwd

using namespace lstm_f32_bwd;

// Plain C entry points, bound with ctypes by
// wesep_tpu_torch/ops/cuda_lstm_f32.py. Tensors f32 and contiguous; D and
// (kind 1) C multiples of 8, H one of 64, 128, 192, 256, B * T < 2^31.
// dirs and reverse as the forward was launched (the bidirectional layers:
// 2, 0). Each returns the CUDA error code of its launch (0 on success) and
// never synchronises.

// G = act([x ; h_{t-1}] @ [Wx ; Wh] + (b or xw)) per direction, in the
// chain's order for `rows` rows a cluster (ChainG: dirs * ceil(B / rows) *
// T * rows * 4H values): sigmoid of the i, f, o columns, tanh of the g
// ones. x as `kind` says (0: rows of x [B, T, D]; 1: frames of unfold(D /
// C, hs) over x [B, L, C], k-major; 2: none, D 0), y [B, T, dirs * H];
// wx_* [D, 4H] (k-major rows for kind 1; null for kind 2) and wh_* [H, 4H];
// b_* [4H] (kinds 0, 1) or xw [dirs, B, T, 4H] (kind 2; b_* null). The _b
// operands are null when dirs is 1.
extern "C" int lstm_f32_gates(const void* x, const void* y, const void* wx_f,
                              const void* wh_f, const void* wx_b,
                              const void* wh_b, const void* b_f,
                              const void* b_b, const void* xw, void* g,
                              int kind, int B, int T, int D, int L, int C,
                              int hs, int H, int dirs, int reverse, int rows,
                              void* stream) {
  if (bad_rows_of_a(kind, B, T, D, L, C, hs, H, dirs, reverse) ||
      bad_rows(rows) || (xw == nullptr) == (b_f == nullptr) ||
      (xw == nullptr) != (kind != kRowH) ||
      (dirs == 2) != (wh_b != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ProductArgs p = product_args(x, y, nullptr, g, kind, B, T, D, L, C, hs, H,
                               dirs, reverse);
  p.wx[0] = static_cast<const float*>(wx_f);
  p.wx[1] = static_cast<const float*>(wx_b);
  p.wh[0] = static_cast<const float*>(wh_f);
  p.wh[1] = static_cast<const float*>(wh_b);
  p.bias[0] = static_cast<const float*>(b_f);
  p.bias[1] = static_cast<const float*>(b_b);
  p.xw = static_cast<const float*>(xw);
  p.order = ChainG{H, T, rows, (B + rows - 1) / rows};
  const dim3 grid(static_cast<unsigned>((p.rows + kBM - 1) / kBM),
                  4 * H / kBN, dirs);
  f32_product_kernel<kGates>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The serial adjoint over clusters of H / 32 blocks, `rows` batch rows a
// cluster. g from lstm_f32_gates at the same rows; wh_* [H, 4H] (wh_b null
// when dirs is 1); cs and dy [B, T, dirs * H]. Writes dg [dirs, B, T, 4H]
// and db_part [ceil(B / rows), dirs, 4H].
extern "C" int lstm_f32_adjoint(const void* g, const void* wh_f,
                                const void* wh_b, const void* cs,
                                const void* dy, void* dg, void* db_part,
                                int B, int T, int H, int dirs, int reverse,
                                int rows, void* stream) {
  if (B <= 0 || T <= 0 || bad_hidden(H) || dirs < 1 || dirs > 2 ||
      reverse < 0 || reverse > 1 || (dirs == 2 && reverse) ||
      (dirs == 2) != (wh_b != nullptr) || bad_rows(rows) ||
      static_cast<long long>(B) * T >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AdjointArgs a{static_cast<const float*>(g),
                      {static_cast<const float*>(wh_f),
                       static_cast<const float*>(wh_b)},
                      static_cast<const float*>(cs),
                      static_cast<const float*>(dy),
                      static_cast<float*>(dg),
                      static_cast<float*>(db_part),
                      B,
                      T,
                      dirs,
                      reverse};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H / 32) {
    case 2: return static_cast<int>(adjoint_nt<2>(a, rows, s));
    case 4: return static_cast<int>(adjoint_nt<4>(a, rows, s));
    case 6: return static_cast<int>(adjoint_nt<6>(a, rows, s));
    case 8: return static_cast<int>(adjoint_nt<8>(a, rows, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out[0] = how many clusters of the adjoint chain at hidden size H over
// `rows` rows the card runs at once.
extern "C" int lstm_f32_adjoint_clusters(void* out, int H, int rows,
                                         void* stream) {
  (void)stream;
  int* n = static_cast<int*>(out);
  switch (bad_hidden(H) ? 0 : H / 32) {
    case 2: return static_cast<int>(clusters_nt<2>(n, rows));
    case 4: return static_cast<int>(clusters_nt<4>(n, rows));
    case 6: return static_cast<int>(clusters_nt<6>(n, rows));
    case 8: return static_cast<int>(clusters_nt<8>(n, rows));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dx2 [dirs, rows, D] = dg @ Wx^T per direction; dg [dirs, rows, 4H],
// wx_* [D, 4H] (the _b one null when dirs is 1).
extern "C" int lstm_f32_dx(const void* dg, const void* wx_f, const void* wx_b,
                           void* dx2, int rows, int D, int H, int dirs,
                           void* stream) {
  if (bad_rows_of_a(kRowX, rows, 1, D, 0, 0, 0, H, dirs, 0) ||
      (dirs == 2) != (wx_b != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ProductArgs p = product_args(nullptr, nullptr, dg, dx2, kRowX, rows, 1, D,
                               0, 0, 0, H, dirs, 0);
  p.wx[0] = static_cast<const float*>(wx_f);
  p.wx[1] = static_cast<const float*>(wx_b);
  const dim3 grid(static_cast<unsigned>((rows + kBM - 1) / kBM),
                  (D + kBN - 1) / kBN, dirs);
  f32_product_kernel<kDx>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// dw_part [splits, dirs, D + H, 4H]: for each slice of rows_per_split (a
// multiple of 16) of the B * T rows and each direction, [x ; h_{t-1}]^T @
// dg; rows :D are dWx (k-major for kind 1), rows D: dWh. x, y as for
// lstm_f32_gates, dg [dirs, B, T, 4H].
extern "C" int lstm_f32_wgrad(const void* x, const void* y, const void* dg,
                              void* dw_part, int kind, int B, int T, int D,
                              int L, int C, int hs, int H, int dirs,
                              int reverse, int rows_per_split, void* stream) {
  if (bad_rows_of_a(kind, B, T, D, L, C, hs, H, dirs, reverse) ||
      rows_per_split <= 0 || rows_per_split % kBK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ProductArgs p = product_args(x, y, dg, dw_part, kind, B, T, D, L, C, hs,
                               H, dirs, reverse);
  p.rows_per_split = rows_per_split;
  const int splits = (p.rows + rows_per_split - 1) / rows_per_split;
  if (splits * dirs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((D + H + kBM - 1) / kBM, 4 * H / kBN, splits * dirs);
  f32_product_kernel<kWgrad>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

#ifdef LSTM_CHAIN_PHASES
// The chain's phase cycles (lstm_tc.cuh, LSTM_CHAIN_PHASES): 256 values.
extern "C" int lstm_tc_read_phase_cycles(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, lstm_tc::g_phase_cycles, sizeof(lstm_tc::g_phase_cycles)));
}
#endif
