// Device helpers shared by the fused gLN TCN block kernels
// (tcn_block.cu, tcn_block_bwd.cu): a tiled matrix product whose epilogue
// the caller gives; the column walk of the epilogues and elementwise
// passes that sum per channel; block sums that do not depend on the run;
// the ordered sums of per-block partials.
//
// The stream tensors ([B, T, C] and [B, T, H]) are in the stream's dtype
// T (float or __nv_bfloat16); every sum and every accumulator is f32.
// `rnd<T>` rounds an f32 value through the stream's dtype: the identity for
// float, and for bf16 the rounding points of the TPU kernel.
//
// The product (`launch_product`): one block of 8 warps per 128 x 128 tile
// of the output, a 4-stage ring of cp.async copies (16 bytes each) into
// shared memory. bf16 operands go to the tensor cores (mma.sync.m16n8k16
// through ldmatrix, f32 sums), each warp a 64 x 32 piece of the tile. f32
// operands go to the FMA units, each thread an 8 x 8 piece: the tensor
// cores' TF32 paths add into their accumulator with truncation, and even
// split three ways (3xTF32) that moved the block's f32 results ~10x
// further from an f32 product than FMA sums do, enough to flip PReLU
// branches the f32 gradient limits do not allow (PERF.md, PR 10). A is
// either the rows of one sample ([M, K], the grid's z the sample) or, for
// a weight gradient, a [K, M] matrix whose K rows are split over the
// grid's z (the caller sums the splits' partials in order). B is always
// [K, N]. Ragged edges are zero-filled copies: M, N and K multiples of 8
// (K any length for a weight gradient).

#pragma once

#include "bilstm_common.cuh"
#include "tc_common.cuh"

namespace tcn {

using bilstm::from_f32;
using bilstm::to_f32;

constexpr int kMaxTaps = 8;       // most taps of the depthwise conv

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
}

// A pair rounded through the stream's dtype (for bf16 one paired
// conversion, the same bits as two).
template <typename T>
__device__ __forceinline__ float2 rnd2(float2 v);
template <>
__device__ __forceinline__ float2 rnd2<float>(float2 v) {
  return v;
}
template <>
__device__ __forceinline__ float2 rnd2<__nv_bfloat16>(float2 v) {
  return __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
}

// Eight consecutive elements, 16-byte aligned, as f32.
__device__ __forceinline__ void load8(const float* __restrict__ p,
                                      float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p,
                                      float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Sums of a and b over the block, in an order fixed by the thread layout;
// valid in thread 0. blockDim.x a multiple of 32, at most 1024.
template <typename V>
__device__ __forceinline__ void block_sum2(V& a, V& b) {
  __shared__ V red[2][32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int warps = (blockDim.x + 31) >> 5;
    a = red[0][0];
    b = red[1][0];
    for (int w = 1; w < warps; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
  }
}

// out[g][w] = sum_p in[(g * P + p) * S + w], p in order: the per-block
// partial sums of a reduction, added the same way in every run.
__global__ void tcn_sum_partials_kernel(const float* __restrict__ in,
                                        float* __restrict__ out, int P, int S,
                                        int W) {
  const int g = blockIdx.y;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const float* p = in + static_cast<size_t>(g) * P * S + w;
  float acc = 0.0f;
#pragma unroll 8
  for (int i = 0; i < P; ++i) acc += p[static_cast<size_t>(i) * S];
  out[static_cast<size_t>(g) * W + w] = acc;
}

inline cudaError_t sum_partials(const float* in, float* out, int G, int P,
                                int S, int W, cudaStream_t stream) {
  const int threads = 128;
  const dim3 grid((W + threads - 1) / threads, G);
  tcn_sum_partials_kernel<<<grid, threads, 0, stream>>>(in, out, P, S, W);
  return cudaGetLastError();
}

// out[g][w] = sum_p in[(g * P + p) * S + w] in an order fixed by the
// shapes: 32 warps of a block each add every 32nd p in order for 32 w,
// then the 32 sums are added in order; summed in In, written as Out. More
// loads in flight than one thread a w (tcn_sum_partials_kernel), for the
// long sums of the TCN kernels.
constexpr int kSlices = 32;
template <typename In, typename Out>
__global__ void __launch_bounds__(kSlices * 32)
    tcn_sum_slices_kernel(const In* __restrict__ in, Out* __restrict__ out,
                          int P, int S, int W) {
  __shared__ In red[kSlices][32];
  const int g = blockIdx.y;
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int w = blockIdx.x * 32 + lane;
  In acc = 0;
  if (w < W) {
    const In* p = in + static_cast<size_t>(g) * P * S + w;
#pragma unroll 4
    for (int i = slice; i < P; i += kSlices) {
      acc += p[static_cast<size_t>(i) * S];
    }
  }
  red[slice][lane] = acc;
  __syncthreads();
  if (slice == 0 && w < W) {
    In total = red[0][lane];
    for (int sl = 1; sl < kSlices; ++sl) total += red[sl][lane];
    out[static_cast<size_t>(g) * W + w] = static_cast<Out>(total);
  }
}

template <typename In, typename Out>
cudaError_t sum_slices(const In* in, Out* out, int G, int P, int S, int W,
                       cudaStream_t stream) {
  const dim3 grid((W + 31) / 32, G);
  tcn_sum_slices_kernel<In, Out>
      <<<grid, kSlices * 32, 0, stream>>>(in, out, P, S, W);
  return cudaGetLastError();
}

inline bool bad_shape(int B, int T_len, int C, int H, int k, int dilation,
                      int pad_lo) {
  return B <= 0 || T_len <= 0 || C <= 0 || H <= 0 || C % 8 != 0 ||
         H % 8 != 0 || k <= 0 || k > kMaxTaps || dilation <= 0 ||
         pad_lo < 0 || pad_lo > (k - 1) * dilation || B > 65535;
}

#define TCN_CHECK(expr)                         \
  do {                                          \
    const cudaError_t err_ = (expr);            \
    if (err_ != cudaSuccess) return err_;       \
  } while (0)

// ---- the product ------------------------------------------------------------

constexpr int kTile = 128;        // rows and columns of a product's tile
constexpr int kShortTile = 64;    // rows of an f32 tile where blocks are few
constexpr int kStages = 4;        // depth of the copy ring
constexpr int kThreads = 256;     // 8 warps
constexpr int kLdMN = kTile + 8;  // row of a [k][m] or [k][n] stage (bf16 or
                                  // f32) and of the staged f32 tile: no bank
                                  // meets itself in a warp's fragment reads

// Spare floats of a column walk: the per-column sums (at most 1 + kMaxTaps
// vectors) of its row groups 1..3.
constexpr int kSpare = 3 * (1 + kMaxTaps) * kTile;

template <typename T>
struct Stage;
template <>
struct Stage<__nv_bfloat16> {
  static constexpr int kK = 32;        // depth of a stage
  static constexpr int kVec = 8;       // elements of a 16-byte copy
  static constexpr int kLdK = kK + 8;  // row of an [m][k] stage
};
template <>
struct Stage<float> {
  static constexpr int kK = 16;
  static constexpr int kVec = 4;
  static constexpr int kLdK = kK + 4;
};

// The copy ring of a product's block of kBM rows: kStages stages of A and
// B (elements of T).
template <typename T, bool kATrans, int kBM = kTile>
struct Ring {
  using S = Stage<T>;
  static constexpr int kSizeA = kATrans ? S::kK * kLdMN : kBM * S::kLdK;
  static constexpr int kSizeB = S::kK * kLdMN;
  static constexpr int kStage = kSizeA + kSizeB;
  static constexpr size_t kRing = sizeof(T) * kStage * kStages;
};

// Shared memory of a product's block: its ring, or after the last stage
// the staged f32 tile followed by the spare floats of a column walk or,
// for an epilogue that reads taps (Epi::kTaps), one tap buffer
// ([kTile][kTile] of T) that the spare floats share.
template <typename T, bool kATrans, class Epi>
constexpr size_t product_smem() {
  constexpr size_t spare = sizeof(float) * kSpare;
  constexpr size_t tap = sizeof(T) * kTile * kTile;
  constexpr size_t tile = sizeof(float) * Epi::kBM * kLdMN +
                          (Epi::kTaps && tap > spare ? tap : spare);
  constexpr size_t ring = Ring<T, kATrans, Epi::kBM>::kRing;
  return ring > tile ? ring : tile;
}

template <typename T>
struct Operands {
  const T* a;          // [M, K] of sample z at a + z * a_batch; kATrans:
  long long a_batch;   // [K, M], K split over z
  int lda;
  const T* b;          // [K, N]
  int ldb;
  int M, N;
  long long K;
  long long k_split;   // kATrans: rows of K per split, a multiple of 32
};

template <typename T, bool kATrans, int kBM>
__device__ __forceinline__ void load_stage(T* sa, T* sb, const T* a,
                                           const Operands<T>& op, int m0,
                                           int n0, long long k0,
                                           long long k_end) {
  using S = Stage<T>;
#pragma unroll
  for (int i = 0; i < kBM * S::kK / S::kVec / kThreads; ++i) {  // A
    const int idx = threadIdx.x + i * kThreads;
    if constexpr (kATrans) {  // [k][m]
      const int kk = idx / (kTile / S::kVec), mc = idx % (kTile / S::kVec);
      const long long k = k0 + kk;
      const int m = m0 + mc * S::kVec;
      tc::cp_async16(sa + kk * kLdMN + mc * S::kVec,
                     k < k_end && m < op.M ? a + k * op.lda + m : nullptr,
                     op.b);
    } else {  // [m][k]
      const int mm = idx / (S::kK / S::kVec), kc = idx % (S::kK / S::kVec);
      const int m = m0 + mm;
      const long long k = k0 + kc * S::kVec;
      tc::cp_async16(
          sa + mm * S::kLdK + kc * S::kVec,
          m < op.M && k < k_end
              ? a + static_cast<long long>(m) * op.lda + k
              : nullptr,
          op.b);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // B, [k][n]
    const int idx = threadIdx.x + i * kThreads;
    const int kk = idx / (kTile / S::kVec), nc = idx % (kTile / S::kVec);
    const long long k = k0 + kk;
    const int n = n0 + nc * S::kVec;
    tc::cp_async16(sb + kk * kLdMN + nc * S::kVec,
                   k < k_end && n < op.N ? op.b + k * op.ldb + n : nullptr,
                   op.b);
  }
}

// bf16: the warp's 64 x 32 piece of one stage on the tensor cores, its
// 16 x 8 tile (mi, ni) in acc[(mi * 4 + ni) * 4 ..] (the m16n8k16
// fragment: rows gid and gid + 8, columns 2q and 2q + 1).
template <bool kATrans, int kBM>
__device__ __forceinline__ void mma_stage(float (&acc)[64],
                                          const __nv_bfloat16* sa,
                                          const __nv_bfloat16* sb) {
  static_assert(kBM == kTile, "bf16 products: 128 rows");
  using S = Stage<__nv_bfloat16>;
  constexpr int kLdA = kATrans ? kLdMN : S::kLdK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
#pragma unroll
  for (int ks = 0; ks < S::kK; ks += 16) {
    uint32_t af[4][4];
    uint32_t bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      tc::ldsm_x4<kATrans>(
          af[mi], tc::a_frag<kATrans>(sa, kLdA, wm + mi * 16, ks, lane));
    }
#pragma unroll
    for (int ni = 0; ni < 4; ni += 2) {
      tc::b_load2<true>(bf[ni], bf[ni + 1], sb, kLdMN, ks, wn + ni * 8, lane);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        tc::mma_bf16(*reinterpret_cast<float(*)[4]>(acc + (mi * 4 + ni) * 4),
                     af[mi], bf[ni]);
      }
  }
}

// The i-th of an FMA thread's 8 rows (or columns) of the tile: two runs of
// four, 64 apart, so that a warp's float4 reads of a stage row do not
// meet in a bank.
__device__ __forceinline__ int tile_index(int t16, int i) {
  return i < 4 ? 4 * t16 + i : 64 + 4 * t16 + (i - 4);
}

// Rows of an FMA thread in a tile of kBM rows: 8 (tile_index) or, in a
// tile of 64, the 4 rows 4 ty ..
template <int kBM>
constexpr int kFmaRows = kBM / 16;
template <int kBM>
__device__ __forceinline__ int fma_row(int ty, int i) {
  return kBM == kTile ? tile_index(ty, i) : 4 * ty + i;
}

// f32: acc[i * 8 + j] += the stage's A row fma_row(ty, i) times B column
// tile_index(tx, j), thread (ty, tx) = (tid / 16, tid % 16), on the FMA
// units. A [m][k] is read a value at a time (the 16 threads of a ty read
// the same one), A [k][m] and B [k][n] as float4.
template <bool kATrans, int kBM>
__device__ __forceinline__ void mma_stage(float (&acc)[64], const float* sa,
                                          const float* sb) {
  using S = Stage<float>;
  constexpr int kR = kFmaRows<kBM>;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int kk = 0; kk < S::kK; ++kk) {
    float av[kR];
    if constexpr (kATrans) {
      static_assert(!kATrans || kBM == kTile, "weight gradients: 128 rows");
      const float4 a0 = *reinterpret_cast<const float4*>(sa + kk * kLdMN +
                                                         4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(sa + kk * kLdMN +
                                                         64 + 4 * ty);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
    } else {
#pragma unroll
      for (int i = 0; i < kR; ++i) av[i] = sa[fma_row<kBM>(ty, i) * S::kLdK + kk];
    }
    const float4 b0 = *reinterpret_cast<const float4*>(sb + kk * kLdMN +
                                                       4 * tx);
    const float4 b1 = *reinterpret_cast<const float4*>(sb + kk * kLdMN + 64 +
                                                       4 * tx);
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < kR; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i * 8 + j] = fmaf(av[i], bv[j], acc[i * 8 + j]);
      }
    }
  }
}

// acc = the block's tile of A @ B over k in [k_begin, k_end).
template <typename T, bool kATrans, int kBM>
__device__ __forceinline__ void product(float (&acc)[64], T* smem,
                                        const Operands<T>& op, const T* a,
                                        int m0, int n0, long long k_begin,
                                        long long k_end) {
  using S = Stage<T>;
  using R = Ring<T, kATrans, kBM>;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  const long long n_k =
      k_end > k_begin ? (k_end - k_begin + S::kK - 1) / S::kK : 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) {
      T* st = smem + s * R::kStage;
      load_stage<T, kATrans, kBM>(st, st + R::kSizeA, a, op, m0, n0,
                                  k_begin + s * S::kK, k_end);
    }
    tc::cp_async_commit();
  }
  for (long long kt = 0; kt < n_k; ++kt) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free again
    const long long next = kt + kStages - 1;
    if (next < n_k) {
      T* st = smem + (next % kStages) * R::kStage;
      load_stage<T, kATrans, kBM>(st, st + R::kSizeA, a, op, m0, n0,
                                  k_begin + next * S::kK, k_end);
    }
    tc::cp_async_commit();
    const T* st = smem + (kt % kStages) * R::kStage;
    mma_stage<kATrans, kBM>(acc, st, st + R::kSizeA);
  }
  tc::cp_async_wait<0>();
}

// f(row, col, v0, v1) for each pair of columns (col, col + 1) a thread
// holds in a row of its accumulators; row and col within the block's
// tile. bf16: the mma fragments (warp (wm, wn), lane (gid, q)); f32: the
// FMA thread's 8 x 8 (mma_stage).
template <typename T, int kBM, class F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[64],
                                              F&& f) {
  if constexpr (sizeof(T) == 2) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
    const int gid = lane >> 2, q = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* c = acc + (mi * 4 + ni) * 4 + 2 * half;
          f(wm + mi * 16 + gid + half * 8, wn + ni * 8 + 2 * q, c[0], c[1]);
        }
  } else {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < kFmaRows<kBM>; ++i)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        f(fma_row<kBM>(ty, i), tile_index(tx, 2 * jp), acc[i * 8 + 2 * jp],
          acc[i * 8 + 2 * jp + 1]);
      }
  }
}

// The block's tile as f32 [kBM][kLdMN] in shared memory (the ring is free
// once every warp is past its last stage), for an epilogue that walks it
// by rows (for_each_row8) or by columns (Walk).
template <typename T, int kBM = kTile>
__device__ __forceinline__ void stage_tile(const float (&acc)[64],
                                           float* tile) {
  __syncthreads();
  for_each_pair<T, kBM>(acc, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<float2*>(tile + r * kLdMN + c) = make_float2(v0, v1);
  });
  __syncthreads();
}

// f(row, col, v) for the staged tile's rows, 8 columns col .. col + 7 at
// a time (v, f32): thread tid takes col = 8 (tid % 16) and the rows
// tid / 16 + 16 j, so that a row's 128 values go out as 16 vectors of 8.
template <int kBM, class F>
__device__ __forceinline__ void for_each_row8(const float* tile, F&& f) {
  const int c = 8 * (threadIdx.x % 16);
  for (int r = threadIdx.x / 16; r < kBM; r += kThreads / 16) {
    float v[8];
    const float4 a = *reinterpret_cast<const float4*>(tile + r * kLdMN + c);
    const float4 b =
        *reinterpret_cast<const float4*>(tile + r * kLdMN + c + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    f(r, c, v);
  }
}

// Eight consecutive elements of the stream's dtype from f32, 16-byte
// aligned.
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pairs[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

// A thread of a column walk over a block's 128 rows x 128 channels (a
// product's staged tile, or an elementwise pass): the pair of channels
// c, c + 1 with c = 2 (tid % 64), rows [kRows g, kRows g + kRows) with
// g = tid / 64, fewer where the sample ends. Pairs are read and written as
// one vector; a walk unrolls its kRows rows, so that the loads of one tap
// for all of them are in flight together, and takes the taps as its outer
// loop, which keeps each element's sums in the order of the taps.
constexpr int kRows = 32;
struct Walk {
  int c, r0, r1;
  __device__ explicit Walk(int rows_left) {
    c = 2 * (threadIdx.x % 64);
    r0 = kRows * (threadIdx.x / 64);
    r1 = min(r0 + kRows, rows_left);
  }
};

// The walk's per-channel sums v[i] (vector i, the pair's two channels) of
// the four row groups, added in order (group 0 + 1 + 2 + 3) and valid in
// group 0's threads, through `spare` (kSpare floats).
template <int N>
__device__ __forceinline__ void add_groups(float2 (&v)[N], float* spare) {
  static_assert(N <= 1 + kMaxTaps, "spare floats of a column walk");
  const int c = 2 * (threadIdx.x % 64), g = threadIdx.x / 64;
  if (g > 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      *reinterpret_cast<float2*>(spare + ((g - 1) * N + i) * kTile + c) =
          v[i];
    }
  }
  __syncthreads();
  if (g == 0) {
    for (int gg = 0; gg < 3; ++gg) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float2 o = *reinterpret_cast<const float2*>(
            spare + (gg * N + i) * kTile + c);
        v[i].x += o.x;
        v[i].y += o.y;
      }
    }
  }
}

// Taps through shared memory. A walk reads each tap of its block, the
// rows [t_first, t_first + kTile) of the block's 128 channels n0.., from a
// copy in `buf` ([kTile][kTile] of T) that cp.async makes: the copies of
// a whole tap are in flight at once and cost no registers. Rows outside
// [0, T) and channels past H are copied as zeros (the walk masks them).
template <typename T>
__device__ __forceinline__ void stage_tap(T* buf, const T* __restrict__ src,
                                          int z, int t_first, int T_len,
                                          int H, int n0) {
  constexpr int kVec = 16 / sizeof(T);  // elements of a copy
  constexpr int kPerRow = kTile / kVec;
  for (int idx = threadIdx.x; idx < kTile * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, cc = (idx % kPerRow) * kVec;
    const int t = t_first + r;
    const bool ok = t >= 0 && t < T_len && n0 + cc < H;
    tc::cp_async16(
        buf + r * kTile + cc,
        ok ? src + (static_cast<size_t>(z) * T_len + t) * H + n0 + cc
           : nullptr,
        src);
  }
  tc::cp_async_commit();
}

// Bytes of shared memory of a walk kernel with two tap buffers.
template <typename T>
constexpr size_t tap_bytes() {
  return 2 * sizeof(T) * kTile * kTile;
}

// Where the per-channel partials of vector `vec` of `nvec` lie for chunk
// cy (128 rows) of nc of sample b.
__device__ __forceinline__ size_t vec_at(int b, int cy, int nc, int nvec,
                                         int vec, int H, int h) {
  return ((static_cast<size_t>(b) * nc + cy) * nvec + vec) * H + h;
}

// The block's two scalar partials at ((z * gridDim.x + blockIdx.x) *
// gridDim.y + blockIdx.y) * 2: gridDim.x * gridDim.y partials a sample.
// Scalar sums (the gLN statistics, their adjoints' means, the PReLU
// slopes' gradients) run over every element of a sample and nearly cancel:
// they are summed in f64 from each thread's terms on, and kept in f64.
__device__ __forceinline__ void block_scalars(double* __restrict__ spart,
                                              int z, double s0, double s1) {
  block_sum2(s0, s1);
  if (threadIdx.x == 0) {
    const size_t at = ((static_cast<size_t>(z) * gridDim.x + blockIdx.x) *
                           gridDim.y + blockIdx.y) * 2;
    spart[at] = s0;
    spart[at + 1] = s1;
  }
}

// A block of Epi::kBM rows (128, or 64 for an f32 product where blocks of
// 128 would fill fewer than two waves: three of its blocks fit an SM).
template <typename T, bool kATrans, class Epi>
__global__ void __launch_bounds__(kThreads, Epi::kBM == kTile ? 2 : 3)
    tcn_product_kernel(Operands<T> op, Epi epi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.x * Epi::kBM, n0 = blockIdx.y * kTile;
  const int z = blockIdx.z;
  long long k_begin = 0, k_end = op.K;
  const T* a = op.a;
  if constexpr (kATrans) {
    k_begin = z * op.k_split;
    k_end = k_begin + op.k_split < op.K ? k_begin + op.k_split : op.K;
  } else {
    a += z * op.a_batch;
  }
  float acc[64];
  product<T, kATrans, Epi::kBM>(acc, reinterpret_cast<T*>(smem_raw), op, a,
                                m0, n0, k_begin, k_end);
  epi(acc, z, m0, n0, reinterpret_cast<float*>(smem_raw));
}

// One launch: tiles of op's M x N, and z the sample (or, kATrans, the
// split of K).
template <typename T, bool kATrans, class Epi>
cudaError_t launch_product(const Operands<T>& op, const Epi& epi, int z,
                           cudaStream_t stream) {
  constexpr size_t kSmem = product_smem<T, kATrans, Epi>();
  auto kernel = tcn_product_kernel<T, kATrans, Epi>;
  TCN_CHECK(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem)));
  const dim3 grid((op.M + Epi::kBM - 1) / Epi::kBM,
                  (op.N + kTile - 1) / kTile, z);
  kernel<<<grid, kThreads, kSmem, stream>>>(op, epi);
  return cudaGetLastError();
}

// Blocks of a product per sample, tiles of bm rows: its partials per
// sample.
inline int product_blocks(int T_len, int N, int bm = kTile) {
  return ((T_len + bm - 1) / bm) * ((N + kTile - 1) / kTile);
}

// Whether an f32 product over B samples takes tiles of kShortTile rows:
// where tiles of 128 would make fewer than two waves of two blocks on the
// H100's 132 SMs (SpEx+'s serving batch). Decided from the shapes alone.
template <typename T>
inline bool short_tiles(int B, int T_len, int N) {
  return sizeof(T) == 4 &&
         static_cast<long long>(B) * product_blocks(T_len, N) < 2 * 2 * 132;
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                     float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float prelu(float s, float p) {
  return s >= 0.0f ? s : p * s;
}

// Epilogue of the u product, tile of s = x @ W1 for sample z, staged and
// written by rows: u = round(PReLU(s + b1_eff[z])); with `part`, also the
// block's sums of u and u^2 over the rounded u (f64) at (z * blocks +
// blockIdx.y * gridDim.x + blockIdx.x) * 2.
template <typename T, int kRowsTile = kTile>
struct EpiU {
  static constexpr bool kTaps = false;
  static constexpr int kBM = kRowsTile;
  T* u;
  const float* b1_eff;
  const float* p0;
  double* part;
  int T_len, H;
  __device__ void operator()(const float (&acc)[64], int z, int m0, int n0,
                             float* tile) const {
    stage_tile<T, kBM>(acc, tile);
    const float p = *p0;
    const float* be = b1_eff + static_cast<size_t>(z) * H + n0;
    double sum = 0.0, sq = 0.0;
    for_each_row8<kBM>(tile, [&](int r, int c, float (&v)[8]) {
      if (m0 + r >= T_len || n0 + c >= H) return;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = rnd<T>(prelu(v[j] + be[c + j], p));
        sum += v[j];
        sq += v[j] * v[j];
      }
      store8(u + (static_cast<size_t>(z) * T_len + m0 + r) * H + n0 + c, v);
    });
    if (part != nullptr) {
      block_sum2(sum, sq);
      if (threadIdx.x == 0) {
        const size_t blocks = static_cast<size_t>(gridDim.x) * gridDim.y;
        const size_t at = (z * blocks + static_cast<size_t>(blockIdx.y) *
                                            gridDim.x + blockIdx.x) * 2;
        part[at] = sum;
        part[at + 1] = sq;
      }
    }
  }
};

// The u product, in tiles of kShortTile rows where short_tiles says so
// (then product_blocks(T_len, H, kShortTile) partials a sample).
template <typename T>
cudaError_t launch_u(const T* x, const T* w1, const float* b1_eff,
                     const float* p0, T* u, double* part, int B, int T_len,
                     int C, int H, cudaStream_t stream) {
  const Operands<T> op{x, static_cast<long long>(T_len) * C, C, w1, H,
                       T_len, H, C, 0};
  if constexpr (sizeof(T) == 4) {
    if (short_tiles<T>(B, T_len, H)) {
      return launch_product<T, false>(
          op, EpiU<T, kShortTile>{u, b1_eff, p0, part, T_len, H}, B, stream);
    }
  }
  return launch_product<T, false>(op, EpiU<T>{u, b1_eff, p0, part, T_len, H},
                                  B, stream);
}

// CUDA events recorded after each launch of a pass, for its per-launch
// times (`events` null: none): event 0 by `done(cudaSuccess, ..)` before
// the first launch, then one after each; `done` passes a launch's error
// on.
struct Marks {
  void* const* events;
  int n;
  int i;
  cudaError_t done(cudaError_t err, cudaStream_t stream) {
    if (err != cudaSuccess || events == nullptr) return err;
    if (i < n) {
      err = cudaEventRecord(static_cast<cudaEvent_t>(events[i]), stream);
    }
    ++i;
    return err;
  }
};

}  // namespace tcn
