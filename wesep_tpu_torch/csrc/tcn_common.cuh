// Device helpers shared by the fused gLN TCN block kernels
// (tcn_block.cu, tcn_block_bwd.cu): a shared-memory tiled matrix product
// with f32 accumulation, block sums that do not depend on the run, and the
// small kernels both passes use (the u product, the statistics, the ordered
// sum of per-block partials).
//
// The stream tensors ([B, T, C] and [B, T, H]) are in the stream's dtype
// T (float or __nv_bfloat16); every sum and every accumulator is f32.
// `rnd<T>` rounds an f32 value through the stream's dtype: the identity for
// float, and for bf16 the rounding points of the TPU kernel.

#pragma once

#include "bilstm_common.cuh"

namespace tcn {

using bilstm::from_f32;
using bilstm::to_f32;

constexpr int kBM = 128;          // rows of a product's block tile
constexpr int kBN = 128;          // columns of a product's block tile
constexpr int kBK = 16;           // depth staged per iteration
constexpr int kPadA = 4;          // padding of the transposed A tile
constexpr int kGemmThreads = 256;  // 16 x 16 threads, 8 x 8 sums each
constexpr int kChunkRows = 128;   // rows per block of an elementwise kernel
constexpr int kEwThreads = 256;   // most threads of an elementwise kernel
constexpr int kMaxTaps = 8;       // most taps of the depthwise conv
static_assert(kBM == kBN, "the row-split product stages both operands alike");

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
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

// as[kk][m] = a[(m0 + m) * lda + k0 + kk] for a row-major [M, K] matrix,
// zero outside it: thread t loads 8 consecutive k of row t / 2.
template <typename T>
__device__ __forceinline__ void stage_a_rows(float (*as)[kBM + kPadA],
                                             const T* __restrict__ a, int lda,
                                             int M, int K, int m0, int k0) {
  const int m = threadIdx.x >> 1;
  const int kh = (threadIdx.x & 1) * 8;
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (m0 + m < M && k0 + kh < K) {
    load8(a + static_cast<size_t>(m0 + m) * lda + k0 + kh, v);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) as[kh + j][m] = v[j];
}

// bs[kk][n] = b[(k0 + kk) * ldb + n0 + n] for a row-major [K, N] matrix,
// zero outside it: thread t loads 8 consecutive n of row t / 16.
template <typename T>
__device__ __forceinline__ void stage_b_rows(float (*bs)[kBN],
                                             const T* __restrict__ b, int ldb,
                                             int K, int N, int k0, int n0) {
  const int kk = threadIdx.x >> 4;
  const int n = (threadIdx.x & 15) * 8;
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (k0 + kk < K && n0 + n < N) {
    load8(b + static_cast<size_t>(k0 + kk) * ldb + n0 + n, v);
  }
  *reinterpret_cast<float4*>(&bs[kk][n]) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(&bs[kk][n + 4]) =
      make_float4(v[4], v[5], v[6], v[7]);
}

// The i-th of a thread's 8 rows (or columns) of the block tile: two runs of
// four, 64 apart, so that a warp's float4 reads of a tile row do not meet
// in a bank.
__device__ __forceinline__ int tile_index(int t16, int i) {
  return i < 4 ? 4 * t16 + i : 64 + 4 * t16 + (i - 4);
}

// acc[i][j] += sum_kk as[kk][row i] * bs[kk][column j] over one staged depth.
template <int LDA>
__device__ __forceinline__ void mma_tile(float (&acc)[8][8],
                                         float (*as)[LDA],
                                         float (*bs)[kBN], int ty,
                                         int tx) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][4 * ty]);
    const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + 4 * ty]);
    const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][4 * tx]);
    const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + 4 * tx]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// acc = a[m0 : m0 + 128, :] @ b[:, n0 : n0 + 128] for row-major a [M, K]
// and b [K, N] in the stream's dtype; K and N multiples of 8. Thread
// (ty, tx) = (t / 16, t % 16) holds rows tile_index(ty, i) and columns
// tile_index(tx, j).
template <typename T>
__device__ __forceinline__ void gemm_nn(float (&acc)[8][8],
                                        const T* __restrict__ a, int lda,
                                        int M, int K,
                                        const T* __restrict__ b, int ldb,
                                        int N, int m0, int n0) {
  __shared__ __align__(16) float as[kBK][kBM + kPadA];
  __shared__ __align__(16) float bs[kBK][kBN];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    stage_a_rows<T>(as, a, lda, M, K, m0, k0);
    stage_b_rows<T>(bs, b, ldb, K, N, k0, n0);
    __syncthreads();
    mma_tile<kBM + kPadA>(acc, as, bs, ty, tx);
    __syncthreads();
  }
}

// Sums of a and b over the block, in an order fixed by the thread layout;
// valid in thread 0. blockDim.x a multiple of 32, at most 1024.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float red[2][32];
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

// u = PReLU(x @ w1 + b1_eff) rounded to the stream's dtype, one block per
// (128 rows of one sample, 128 channels). Optionally also the unrounded
// pre-activation s (f32) and, per block, the sums of u and u^2 taken over
// the rounded u: part[(b * blocks + block) * 2 + {0, 1}].
template <typename T>
__global__ void __launch_bounds__(kGemmThreads, 2)
    tcn_u_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                 const float* __restrict__ b1_eff,
                 const float* __restrict__ p0_ptr, T* __restrict__ u,
                 float* __restrict__ s_out, float* __restrict__ part,
                 int T_len, int C, int H) {
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  float acc[8][8];
  gemm_nn<T>(acc, x + static_cast<size_t>(b) * T_len * C, C, T_len, C, w1, H,
             H, m0, n0);
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const float p0 = *p0_ptr;
  float sum = 0.0f;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + tile_index(ty, i);
    if (row >= T_len) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tile_index(tx, j);
      if (col >= H) continue;
      const float s = acc[i][j] + b1_eff[static_cast<size_t>(b) * H + col];
      const float uu = rnd<T>(s >= 0.0f ? s : p0 * s);
      const size_t idx = (static_cast<size_t>(b) * T_len + row) * H + col;
      u[idx] = from_f32<T>(uu);
      if (s_out != nullptr) s_out[idx] = s;
      sum += uu;
      sq += uu * uu;
    }
  }
  if (part != nullptr) {
    block_sum2(sum, sq);
    if (threadIdx.x == 0) {
      const size_t blocks = static_cast<size_t>(gridDim.x) * gridDim.y;
      const size_t at =
          (b * blocks + static_cast<size_t>(blockIdx.y) * gridDim.x +
           blockIdx.x) * 2;
      part[at] = sum;
      part[at + 1] = sq;
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

template <typename T>
cudaError_t launch_u(const T* x, const T* w1, const float* b1_eff,
                     const float* p0, T* u, float* s_out, float* part, int B,
                     int T_len, int C, int H, cudaStream_t stream) {
  const dim3 grid((T_len + kBM - 1) / kBM, (H + kBN - 1) / kBN, B);
  tcn_u_kernel<T><<<grid, kGemmThreads, 0, stream>>>(x, w1, b1_eff, p0, u,
                                                      s_out, part, T_len, C, H);
  return cudaGetLastError();
}

// Blocks of tcn_u_kernel per sample: the partial sums it writes per sample.
inline int u_blocks(int T_len, int H) {
  return ((T_len + kBM - 1) / kBM) * ((H + kBN - 1) / kBN);
}

// Launch shape of the elementwise kernels: one thread per channel of a
// slice of at most kEwThreads channels, kChunkRows rows of one sample.
inline int ew_threads(int H) {
  const int t = (H + 31) / 32 * 32;
  return t < kEwThreads ? t : kEwThreads;
}
// The chunks of kChunkRows rows of a sample, and the most blocks a grid's y
// dimension takes: an elementwise kernel's blocks loop over the chunks
// blockIdx.y, blockIdx.y + gridDim.y, ... and index their partials by
// chunk, so a T of more than 65535 chunks gives the same partials.
constexpr int kMaxGridY = 65535;
__host__ __device__ inline int ew_chunks(int T_len) {
  return (T_len + kChunkRows - 1) / kChunkRows;
}
inline dim3 ew_grid(int B, int T_len, int H) {
  const int threads = ew_threads(H);
  const int chunks = ew_chunks(T_len);
  return dim3((H + threads - 1) / threads,
              chunks < kMaxGridY ? chunks : kMaxGridY, B);
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

}  // namespace tcn
