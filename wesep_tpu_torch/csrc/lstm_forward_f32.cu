// The f32 forward of the four LSTM layers, redesigned for Hopper (sm_90a):
// the input projection of every step as one tiled FMA product, and a
// recurrence that keeps only h_{t-1} @ Wh on its chain, with Wh held in
// registers over a thread-block cluster. Every product and the cell update
// run in f32 on the FMA units (TF32 tensor cores would change the result).
//
// Replaces, for f32 streams whose shapes pass the route gate of
// wesep_tpu_torch/ops/cuda_lstm_f32.py (`f32_forward_fits`), the forward of
// four Pallas TPU kernels of wesep_tpu/ops/pallas_lstm.py:
// `_bi_layer_forward` (of `bilstm_layer`, K0), `_bi_unfold_forward` (of
// `bilstm_layer_unfold`, K3), `_bi_forward` (of `bilstm_fused`, K2) and
// `_forward` (of `lstm_fused`, K1). f32 is the serving path (bin/infer) and
// bin/train's validation step; shapes the gate refuses keep
// `bilstm_fwd_kernel` of bilstm_common.cuh, and bf16 streams the
// tensor-core forward of lstm_forward_tc.cu.
//
// A step of the forward (per direction, in its walk's order):
//   g   = (x_t @ Wx + b) + h_{t-1} @ Wh                       all in f32
//   c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(g);  h_t = sigmoid(o) tanh(c_t)
// Only h_{t-1} @ Wh depends on the previous step. So two launches:
//
// 1. `lstm_f32_project` (the layers that project x, K0 and K3): xw[dir] =
//    A @ Wx[dir] + b for every step at once, f32, not activated: a 128 x 128
//    tiled product, 8 x 8 sums a thread, operands staged through shared
//    memory, the next stage's loads issued into registers before the
//    current stage's sums. A is the rows of x in place, or the k-major
//    frames of unfold(ks, hs) read in place (the wrapper permutes Wx's rows
//    to k-major order, as for the bf16 kernels). A block's 128 columns are
//    the four gates of 32 units, staged from Wx in the order (unit, gate),
//    so that each thread holds the four gates of a unit side by side and
//    writes them as one 16-byte piece, in the chain's order (F32ChainXw
//    below), where each thread of the chain finds its step's four gates of
//    a (row, unit) item in one piece and a warp reads 512 contiguous bytes.
//    The two-kernel layers (K1, K2) bring xw from their own f32 torch
//    projection, in their [dirs, B, T, 4H] order; the chain reads that
//    order too (four 128-byte lines a warp and item).
// 2. `lstm_f32_forward`, the recurrence over thread-block clusters of H / 32
//    blocks (8 at H 256, 6 at H 192) over R batch rows of one direction
//    (R of 8, 12, 16, 20 or 32, chosen by the wrapper from the clusters the
//    card runs at once, so that few waves run). Block `rank` owns hidden
//    units [32 rank, 32 rank + 32) and all four gate columns of each: lane
//    j of every warp owns unit j. The block's 8 warps split k: warp w holds
//    Wh[w H / 8 : (w + 1) H / 8, the block's columns] in registers (H / 8 x
//    4 f32 a thread, 128 KB a block at H 256: weight-stationary, as f32 Wh
//    in shared memory would leave no room for h at H 256 and cost a
//    non-broadcast shared load per four FMAs), two warps on each of the
//    SM's four schedulers at every H; h_{t-1} of all R rows and H units at
//    two parities lies in shared memory. A step starts warp by warp: warp
//    w's rows of k are the units of one block (two at H 192), and it waits
//    only for those blocks' slices of h_{t-1} (an mbarrier per parity and
//    sending block; none for the block's own units), then sums its k for
//    every row and the lane's four gates (FMAs, h read as broadcast 16-byte
//    loads) into partial sums in shared memory; one block barrier; each
//    (row, unit) item adds xw and the 8 partials in warp order, the cell
//    update in registers (c never leaves them; sigmoid from the special
//    function unit's exponential and reciprocal, as the bf16 chain's), h_t
//    into the block's own h buffer of the next parity, y and cs stored (cs
//    only when a backward follows); each warp pushes its rows' slice of
//    h_t, 16 bytes at a time, into the same place of every peer's buffer
//    (st.async into distributed shared memory, each store counting its
//    bytes on the peer's mbarrier of that parity for this block, as the
//    bf16 chain of lstm_tc.cuh counts them on one); the next step's xw
//    loaded into registers; one block barrier (the own slice of h_t is read
//    next step, and the partials are reused). No cluster barrier: a peer
//    can write a parity of a block's h only after its own product of the
//    step, which needs that block's slice of the step before, sent after
//    the block's product: so the double buffer is never overwritten while
//    it is read.
//
// What bounds them on this card (67 TFLOP/s f32 outside the tensor cores,
// 3.35 TB/s), at the pBSRNN's serving band shape (B' 64, T 376, D 128, H
// 256, both directions). The forward's own function is 37.9 GFLOP (0.57
// ms) and ~27 MB; the split adds xw, 197 MB written by the projection and
// read back by the chain (0.12 ms of traffic). The projection alone is
// 12.6 GFLOP (0.19 ms). The chain is bound by its 376 dependent steps: a
// step costs each SM R * H * 128 FMAs (R * H issue cycles of its four
// schedulers), h's broadcast loads, which do not overlap the FMAs, the
// cell update, two block barriers and the exchange's round trip between
// SMs; about 465 cycles a row and 1.2 k a step at H 256. The card runs 15
// clusters of 8 blocks at once (17 of 6 at H 192), so the band's 2 x 64
// rows take one wave at 12 rows a cluster (tools/lstm_chain_phases.py
// --chain f32 builds this file with -DLSTM_CHAIN_PHASES to count the
// cycles of each part).

#include "lstm_tc.cuh"

namespace lstm_f32 {

using lstm_tc::kRowUnfold;
using lstm_tc::kRowX;
using lstm_tc::mbar_expect_tx;
using lstm_tc::mbar_init;
using lstm_tc::mbar_wait;
using lstm_tc::peer_addr;
using lstm_tc::sigmoid_f32;
using lstm_tc::st_async16;
namespace cg = cooperative_groups;

// ---- the projection ----------------------------------------------------------

constexpr int kBM = 128;      // rows of a block's output tile
constexpr int kBN = 128;      // columns (one rank's 32 units x 4 gates)
constexpr int kBK = 16;       // depth of a stage
constexpr int kPadA = 4;      // padding of the transposed A tile
constexpr int kPadB = 16;     // padding of the Wx tile's rows
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 sums each

// Where the projection writes xw for the chain: per direction, tile of R
// batch rows and step, the [R, 4H] pre-activations as [rank][row][unit j]
// [gate q] (R * 4H values), so that value (dir, b, t, q * H + 32 rank + j)
// lies at slab(dir, b / R, t) + rank * R * 128 + (b % R) * 128 + j * 4 + q.
// Rows of the last tile past B are never written; the chain reads them as
// zero.
struct F32ChainXw {
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

struct ProjectArgs {
  const float* x;
  const float* wx[2];    // [D, 4H] (k-major rows for kRowUnfold)
  const float* bias[2];  // [4H]
  float* xw;             // F32ChainXw
  int kind;              // kRowX or kRowUnfold
  int B;
  int T;
  int D;
  int L;
  int C;
  int hs;
  F32ChainXw order;
};

// The first of the D values of row m = b * T + t of A: a row of x, or the
// k-major frame t of unfold(D / C, hs) over x[b] (ks * C contiguous values).
__device__ __forceinline__ const float* a_row(const ProjectArgs& p, int m) {
  if (p.kind == kRowUnfold) {
    const int b = m / p.T, t = m - b * p.T;
    return p.x + (static_cast<long long>(b) * p.L +
                  static_cast<long long>(t) * p.hs) * p.C;
  }
  return p.x + static_cast<long long>(m) * p.D;
}

// The i-th of a thread's 8 rows (or columns) of the tile: two runs of four,
// 64 apart, so that a warp's 16-byte reads of a tile row meet in no bank
// (as tcn_common.cuh lays them out).
__device__ __forceinline__ int tile_index(int t16, int i) {
  return i < 4 ? 4 * t16 + i : 64 + 4 * t16 + (i - 4);
}

// One block: the 128 x 128 output tile (m0, n0) of direction blockIdx.z,
// its columns in the chain's order: column n0 + 4 j + q of the tile is gate
// q of unit 32 rank + j, rank = n0 / 128, so that each thread holds the
// four gates of a unit side by side. Thread t stages 8 consecutive k of A
// row t / 2, and 8 consecutive units of gate q of Wx row t / 16 (columns q
// H + 32 rank + j0 ..), stored in the tile's order; D % 8 == 0.
__global__ void __launch_bounds__(kThreads, 2)
    f32_project_kernel(ProjectArgs p) {
  __shared__ __align__(16) float as[2][kBK][kBM + kPadA];
  __shared__ __align__(16) float bs[2][kBK][kBN + kPadB];
  const int dir = blockIdx.z;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int M = p.B * p.T, N = 4 * p.order.H;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int am = tid >> 1, ak = (tid & 1) * 8;   // A: row, first k
  // Wx: row, gate, first unit
  const int bk = tid >> 4, bq = (tid & 15) >> 2, bj = (tid & 3) * 8;
  const int rank = n0 / kBN;
  const float* arow = m0 + am < M ? a_row(p, m0 + am) : nullptr;
  const float* wx = p.wx[dir] + bq * p.order.H + rank * 32 + bj;

  float4 ra[2], rb[2];
  auto fetch = [&](int k0) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    ra[0] = ra[1] = rb[0] = rb[1] = z;
    if (arow != nullptr && k0 + ak < p.D) {
      ra[0] = *reinterpret_cast<const float4*>(arow + k0 + ak);
      ra[1] = *reinterpret_cast<const float4*>(arow + k0 + ak + 4);
    }
    if (k0 + bk < p.D) {
      const float* src = wx + static_cast<long long>(k0 + bk) * N;
      rb[0] = *reinterpret_cast<const float4*>(src);
      rb[1] = *reinterpret_cast<const float4*>(src + 4);
    }
  };
  auto stage = [&](int buf) {
    const float av[8] = {ra[0].x, ra[0].y, ra[0].z, ra[0].w,
                         ra[1].x, ra[1].y, ra[1].z, ra[1].w};
    const float bv[8] = {rb[0].x, rb[0].y, rb[0].z, rb[0].w,
                         rb[1].x, rb[1].y, rb[1].z, rb[1].w};
#pragma unroll
    for (int j = 0; j < 8; ++j) as[buf][ak + j][am] = av[j];
    // unit bj + (i + rot) % 8 is stored i-th, so that the stores of a warp
    // (4 values of bj, 4 gates, 2 rows 16 banks apart) meet in no bank
    const int rot = bj >> 3;
    float v1[8], v2[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v1[i] = (rot & 1) ? bv[(i + 1) & 7] : bv[i];
#pragma unroll
    for (int i = 0; i < 8; ++i) v2[i] = (rot & 2) ? v1[(i + 2) & 7] : v1[i];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      bs[buf][bk][(bj + ((i + rot) & 7)) * 4 + bq] = v2[i];
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
  const int stages = (p.D + kBK - 1) / kBK;
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

  // columns 4 tx .. 4 tx + 3 and 64 + 4 tx .. are the four gates of units
  // j = tx and 16 + tx of rank n0 / 128: one 16-byte piece each
  const float* bias = p.bias[dir] + rank * 32 + tx;
  const int H = p.order.H;
  const float4 bias0 = make_float4(bias[0], bias[H], bias[2 * H], bias[3 * H]);
  const float4 bias1 =
      make_float4(bias[16], bias[H + 16], bias[2 * H + 16], bias[3 * H + 16]);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tile_index(ty, i);
    if (m >= M) continue;
    const int b = m / p.T, t = m - b * p.T;
    float* out = p.xw + p.order.at(dir, b, t, rank);
    *reinterpret_cast<float4*>(out + 4 * tx) =
        make_float4(acc[i][0] + bias0.x, acc[i][1] + bias0.y,
                    acc[i][2] + bias0.z, acc[i][3] + bias0.w);
    *reinterpret_cast<float4*>(out + 64 + 4 * tx) =
        make_float4(acc[i][4] + bias1.x, acc[i][5] + bias1.y,
                    acc[i][6] + bias1.z, acc[i][7] + bias1.w);
  }
}

// ---- the recurrence over a cluster -------------------------------------------

// Shapes of the chain at H = 32 * NT over R rows (a multiple of 4): NT
// blocks a cluster, 8 warps a block whatever H is (two on each of the SM's
// four schedulers), warp w summing the KW = H / 8 rows of k from KW w (the
// units of one block, or at H 192 of two); shared memory holds h at two
// parities [2][R][H] f32, the warps' partial sums [8][R][32] of float4
// (the four gates of a lane's unit) and an mbarrier per parity and sending
// block.
constexpr int kChainWarps = 8;

template <int NT, int R>
struct F32Shape {
  static_assert(R % 4 == 0, "the product takes rows four at a time");
  static constexpr int kH = 32 * NT;
  static constexpr int kKW = kH / kChainWarps;  // rows of k of a warp
  static_assert(kKW % 4 == 0, "h is read 16 bytes at a time");
  static constexpr int kThreads = 32 * kChainWarps;
  static constexpr int kItems =  // rows of a warp in the cell update
      (R + kChainWarps - 1) / kChainWarps;
  static constexpr size_t kHBuf = sizeof(float) * R * kH;
  static constexpr size_t kPart = sizeof(float4) * kChainWarps * R * 32;
  static constexpr size_t kBars = sizeof(uint64_t) * 2 * NT;
  static constexpr size_t kBytes = 2 * kHBuf + kPart + kBars;  // <= 192 KB
};

struct ChainArgs {
  const float* xw;     // F32ChainXw (chain_order) or [dirs, B, T, 4H]
  const float* wh[2];  // [H, 4H] per direction
  float* y;            // [B, T, dirs * H] out
  float* cs;           // [B, T, dirs * H] out, or null
  int B;
  int T;
  int dirs;
  int reverse;
};

// Built with -DLSTM_CHAIN_PHASES the chain keeps its phases in
// g_phase_cycles (lstm_tc.cuh) as the bf16 chains do: 0 wait, 1 h product,
// 2 block barrier, 3 cell update with the y and cs stores, 4 exchange (h_t's
// slice to the peers), 5 the next step's xw loads, 6 the step's last block
// barrier.
template <int NT, int R, bool kChainOrder>
__global__ void __cluster_dims__(NT, 1, 1)
    __launch_bounds__(F32Shape<NT, R>::kThreads, 1)
        f32_chain_kernel(ChainArgs a) {
  using S = F32Shape<NT, R>;
  constexpr int H = S::kH, h4 = 4 * H, ITEMS = S::kItems, KW = S::kKW;
  constexpr int W = kChainWarps;
  constexpr int kHElems = R * H;  // one parity of h
  // bytes of h_t a peer sends a block each step (its 32 units of R rows)
  constexpr int kSlice = R * 32 * 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* h_s = reinterpret_cast<float*>(smem_raw);  // [2][R][H]
  float4* part = reinterpret_cast<float4*>(smem_raw + 2 * S::kHBuf);
  // bar[p * NT + src] counts the bytes of h that block src sends into
  // parity p of h_s (its own entries unused)
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(smem_raw + 2 * S::kHBuf + S::kPart);

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

  // the thread's slice of Wh, once: w[k][q] = Wh[KW warp + k][q H + u0 +
  // lane]
  float w[KW][4];
  {
    const float* wh =
        a.wh[dir] + static_cast<long long>(KW * warp) * h4 + u0 + lane;
#pragma unroll
    for (int k = 0; k < KW; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) w[k][q] = wh[k * h4 + q * H];
  }
  // the blocks whose units are the warp's rows of k
  const int src_lo = KW * warp / 32, src_hi = (KW * warp + KW - 1) / 32;
  // h_{-1} = 0 (parity 0)
  for (int i = tid; i < kHElems / 4; i += S::kThreads) {
    reinterpret_cast<float4*>(h_s)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // parity 1 takes h_0 (sent in step 0, read in step 1), parity 0 h_1
  if (tid == 0) {
    for (int src = 0; src < NT; ++src) {
      if (src == rank) continue;
      mbar_init(&bar[src], 1);
      mbar_init(&bar[NT + src], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int src = 0; src < NT; ++src) {
      if (src == rank) continue;
      mbar_expect_tx(&bar[NT + src], kSlice);
      mbar_expect_tx(&bar[src], kSlice);
    }
  }

  // the thread's items: rows warp + 8 i (< R) of the tile, unit u0 + lane,
  // its four gates; xv holds their pre-activations for the coming step,
  // loaded before the step's wait (rows past B read as zero and store
  // nothing)
  float xv[ITEMS][4], c[ITEMS];
  auto load_step = [&](int s) {
    const int t = backwards ? a.T - 1 - s : s;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int r = warp + W * i, b = b0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < R && b < a.B) {
        if constexpr (kChainOrder) {
          const F32ChainXw order{H, a.T, R, tiles};
          v = *reinterpret_cast<const float4*>(a.xw + order.at(dir, b, t,
                                                               rank) +
                                               lane * 4);
        } else {
          const float* p = a.xw +
                           ((static_cast<long long>(dir) * a.B + b) * a.T +
                            t) * h4 + u0 + lane;
          v = make_float4(p[0], p[H], p[2 * H], p[3 * H]);
        }
      }
      xv[i][0] = v.x;
      xv[i][1] = v.y;
      xv[i][2] = v.z;
      xv[i][3] = v.w;
    }
  };
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) c[i] = 0.0f;

  load_step(0);
  // every block of the cluster runs and has its mbarriers set up; h_s is
  // zeroed
  cluster.sync();
  // bit p: the next phase of this warp's barrier of parity p to wait for
  int phases = 0;
#ifdef LSTM_CHAIN_PHASES
  long long phase_acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  long long phase_at = 0;
#endif
  for (int s = 0; s < a.T; ++s) {
    const int t = backwards ? a.T - 1 - s : s;
    const int par = s & 1;
    const bool last = s + 1 == a.T;
    if (s > 0) {
      // the warp's k are the units of blocks src_lo .. src_hi: each peer's
      // slice of h_{t-1} is in parity par (the own slice needs no wait: the
      // step's last block barrier gave it); the first warp to read a peer's
      // slice then arms its barrier for the slice of h_{t+1}, which goes to
      // the same parity (no peer sends it before this block's slice of h_t,
      // sent after every warp's wait)
      for (int src = src_lo; src <= src_hi; ++src) {
        if (src == rank) continue;
        uint64_t* from = &bar[par * NT + src];
        mbar_wait(from, (phases >> par) & 1);
        if (lane == 0 && 32 * src / KW == warp && s + 2 < a.T) {
          mbar_expect_tx(from, kSlice);
        }
      }
      phases ^= 1 << par;
    }
    CHAIN_PHASE(0)
    const float* hp = h_s + par * kHElems;  // h_{t-1}
    float* hn = h_s + (par ^ 1) * kHElems;  // h_t

    // the warp's partial sums over its KW k: rows four at a time, h read as
    // broadcast 16-byte loads, each sum in k order
#pragma unroll 1
    for (int rg = 0; rg < R; rg += 4) {
      float acc[4][4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[rr][q] = 0.0f;
#pragma unroll
      for (int k4 = 0; k4 < KW / 4; ++k4) {
        float hk[4][4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const float4 v = *reinterpret_cast<const float4*>(
              hp + (rg + rr) * H + KW * warp + 4 * k4);
          hk[rr][0] = v.x;
          hk[rr][1] = v.y;
          hk[rr][2] = v.z;
          hk[rr][3] = v.w;
        }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[rr][q] = fmaf(hk[rr][kk], w[4 * k4 + kk][q], acc[rr][q]);
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        part[(warp * R + rg + rr) * 32 + lane] =
            make_float4(acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]);
      }
    }
    CHAIN_PHASE(1)
    __syncthreads();  // every warp's partial sums are in shared memory
    CHAIN_PHASE(2)

    // the cell update of the warp's rows: g = xw + the warps' partials in
    // warp order, c in f32 registers, h_t into hn, y and cs
    const long long out_t = static_cast<long long>(t) * width + dir * H +
                            u0 + lane;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int r = warp + W * i;
      if (r >= R) break;
      float g[4] = {xv[i][0], xv[i][1], xv[i][2], xv[i][3]};
#pragma unroll
      for (int src = 0; src < W; ++src) {
        const float4 p = part[(src * R + r) * 32 + lane];
        g[0] += p.x;
        g[1] += p.y;
        g[2] += p.z;
        g[3] += p.w;
      }
      const float ig = sigmoid_f32(g[0]);
      const float fg = sigmoid_f32(g[1]);
      const float gg = tanhf(g[2]);
      const float og = sigmoid_f32(g[3]);
      c[i] = fg * c[i] + ig * gg;
      const float hv = og * tanhf(c[i]);
      hn[r * H + u0 + lane] = hv;
      const int b = b0 + r;
      if (b < a.B) {
        const long long at =
            static_cast<long long>(b) * a.T * width + out_t;
        a.y[at] = hv;
        if (a.cs != nullptr) a.cs[at] = c[i];
      }
    }
    CHAIN_PHASE(3)
    if (last) break;
    // the warp's rows of h_t's slice, 16 bytes at a time, into the same
    // place of every peer's hn, counted on the peer's barrier of parity
    // par ^ 1 for this block
    __syncwarp();
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int r = warp + W * i;
      if (r >= R) break;
      for (int p = lane; p < 8 * (NT - 1); p += 32) {
        const int peer = (rank + 1 + (p >> 3)) % NT;
        const float* src = hn + r * H + u0 + (p & 7) * 4;
        const float4 v = *reinterpret_cast<const float4*>(src);
        st_async16(peer_addr(src, peer),
                   make_uint4(__float_as_uint(v.x), __float_as_uint(v.y),
                              __float_as_uint(v.z), __float_as_uint(v.w)),
                   peer_addr(&bar[(par ^ 1) * NT + rank], peer));
      }
    }
    CHAIN_PHASE(4)
    load_step(s + 1);
    CHAIN_PHASE(5)
    // the own slice of h_t is in hn for every warp's next product, and no
    // warp still reads the partial sums
    __syncthreads();
    CHAIN_PHASE(6)
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
}

template <int NT, int R, bool kChainOrder>
cudaError_t launch_chain(const ChainArgs& a, cudaStream_t stream) {
  auto kernel = f32_chain_kernel<NT, R, kChainOrder>;
  const size_t smem = F32Shape<NT, R>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (a.B + R - 1) / R;
  kernel<<<dim3(tiles * NT, a.dirs), F32Shape<NT, R>::kThreads, smem,
           stream>>>(a);
  return cudaGetLastError();
}

template <int NT, int R>
cudaError_t chain_rows(const ChainArgs& a, int chain_order, cudaStream_t s) {
  return chain_order ? launch_chain<NT, R, true>(a, s)
                     : launch_chain<NT, R, false>(a, s);
}

// Rows a cluster the chain takes: 8, 12, 16, 20 and 32.
template <int NT>
cudaError_t chain_nt(const ChainArgs& a, int rows, int chain_order,
                     cudaStream_t s) {
  switch (rows) {
    case 8: return chain_rows<NT, 8>(a, chain_order, s);
    case 12: return chain_rows<NT, 12>(a, chain_order, s);
    case 16: return chain_rows<NT, 16>(a, chain_order, s);
    case 20: return chain_rows<NT, 20>(a, chain_order, s);
    case 32: return chain_rows<NT, 32>(a, chain_order, s);
    default: return cudaErrorInvalidValue;
  }
}

// How many clusters of the chain the card runs at once
// (cudaOccupancyMaxActiveClusters).
template <int NT, int R>
cudaError_t clusters_at_once(int* out) {
  auto kernel = f32_chain_kernel<NT, R, true>;
  const size_t smem = F32Shape<NT, R>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NT * 1024, 1, 1);
  cfg.blockDim = dim3(F32Shape<NT, R>::kThreads, 1, 1);
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

}  // namespace lstm_f32

using namespace lstm_f32;

// Plain C entry points, bound with ctypes by
// wesep_tpu_torch/ops/cuda_lstm_f32.py. Tensors contiguous f32; each
// returns the CUDA error code of its launch (0 on success) and never
// synchronises.

// xw = A @ Wx + b per direction, f32, in the chain's order for `rows` rows
// a cluster (F32ChainXw: dirs * ceil(B / rows) * T * rows * 4H values). x
// as `kind` says (0: rows of x [B, T, D]; 1: frames of unfold(D / C, hs)
// over x [B, L, C], k-major); wx_* [D, 4H] (k-major rows for kind 1) and
// b_* [4H]; the _b operands null when dirs is 1. D (and C for kind 1)
// multiples of 8, H one of 64, 128, 192, 256.
extern "C" int lstm_f32_project(const void* x, const void* wx_f,
                                const void* wx_b, const void* b_f,
                                const void* b_b, void* xw, int kind, int B,
                                int T, int D, int L, int C, int hs, int H,
                                int dirs, int rows, void* stream) {
  if ((kind != kRowX && kind != kRowUnfold) || dirs < 1 || dirs > 2 ||
      B <= 0 || T <= 0 || D <= 0 || D % 8 != 0 || bad_hidden(H) ||
      bad_rows(rows) ||
      static_cast<long long>(B) * T >= (1LL << 31) ||
      (dirs == 2) != (wx_b != nullptr && b_b != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kind == kRowUnfold &&
      (C <= 0 || C % 8 != 0 || D % C != 0 || hs <= 0 || L < D / C ||
       (L - D / C) / hs + 1 != T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ProjectArgs p{static_cast<const float*>(x),
                      {static_cast<const float*>(wx_f),
                       static_cast<const float*>(wx_b)},
                      {static_cast<const float*>(b_f),
                       static_cast<const float*>(b_b)},
                      static_cast<float*>(xw),
                      kind, B, T, D, L, C, hs,
                      F32ChainXw{H, T, rows, (B + rows - 1) / rows}};
  const long long m = static_cast<long long>(B) * T;
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM), 4 * H / kBN,
                  dirs);
  f32_project_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The recurrence over clusters of H / 32 blocks, `rows` (8, 16 or 32)
// batch rows a cluster. xw f32 in the chain's order for those rows
// (chain_order 1: from lstm_f32_project) or [dirs, B, T, 4H] (0: the
// two-kernel layers' projection); wh_* [H, 4H] (wh_b null when dirs is 1).
// Writes y [B, T, dirs * H] and, unless cs is null, cs [B, T, dirs * H].
// dirs and reverse as the layer walks (the bidirectional layers: 2, 0).
extern "C" int lstm_f32_forward(const void* xw, const void* wh_f,
                                const void* wh_b, void* y, void* cs, int B,
                                int T, int H, int dirs, int reverse,
                                int chain_order, int rows, void* stream) {
  if (B <= 0 || T <= 0 || bad_hidden(H) || dirs < 1 || dirs > 2 ||
      reverse < 0 || reverse > 1 || (dirs == 2 && reverse) ||
      (dirs == 2) != (wh_b != nullptr) || chain_order < 0 ||
      chain_order > 1 || bad_rows(rows) ||
      static_cast<long long>(B) * T >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ChainArgs a{static_cast<const float*>(xw),
                    {static_cast<const float*>(wh_f),
                     static_cast<const float*>(wh_b)},
                    static_cast<float*>(y),
                    static_cast<float*>(cs),
                    B,
                    T,
                    dirs,
                    reverse};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H / 32) {
    case 2: return static_cast<int>(chain_nt<2>(a, rows, chain_order, s));
    case 4: return static_cast<int>(chain_nt<4>(a, rows, chain_order, s));
    case 6: return static_cast<int>(chain_nt<6>(a, rows, chain_order, s));
    case 8: return static_cast<int>(chain_nt<8>(a, rows, chain_order, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out[0] = how many clusters of the recurrence at hidden size H over
// `rows` rows the card runs at once.
extern "C" int lstm_f32_forward_clusters(void* out, int H, int rows,
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

#ifdef LSTM_CHAIN_PHASES
// The chain's phase cycles (lstm_tc.cuh, LSTM_CHAIN_PHASES): 256 values.
extern "C" int lstm_tc_read_phase_cycles(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, lstm_tc::g_phase_cycles, sizeof(lstm_tc::g_phase_cycles)));
}
#endif
