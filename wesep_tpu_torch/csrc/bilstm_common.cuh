// Device code shared by the fused BiLSTM layer kernels: the plain layer
// (bilstm_layer.cu, bilstm_layer_bwd.cu) and the unfold-fused layer
// (bilstm_unfold.cu, bilstm_unfold_bwd.cu). Helpers, the two sources of a
// step's input row, and the forward kernel; the backward kernels are in
// bilstm_backward.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace bilstm {

constexpr int kMaxThreads = 256;  // one thread per hidden unit, H <= 256
constexpr int kTile = 8;          // batch rows per block of a serial kernel
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic smem without opt-in

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Where the input row of step t comes from. The kernels below take the
// stream x as their own `const T* __restrict__` argument and read a row
// only through the source's `width()` (K, the row's length, K % 4 == 0),
// `load(x, b, t, k)` and `load_row(x, n, k)` (row n = b * T + t of the
// [B * T, K] stream); the source holds only the geometry.
//
// RowSource: the row is x_t of a [B, T, D] stream (the plain layer).
struct RowSource {
  int T_len;
  int D;
  __host__ __device__ int width() const { return D; }
  template <typename T>
  __device__ __forceinline__ float load_row(const T* __restrict__ x,
                                            long long n, int k) const {
    return to_f32(x[n * D + k]);
  }
  template <typename T>
  __device__ __forceinline__ float load(const T* __restrict__ x, int b,
                                        int t, int k) const {
    return load_row(x, static_cast<long long>(b) * T_len + t, k);
  }
};

// UnfoldSource: the row is frame t of unfold(ks, hs) over a raw [B, L, C]
// stream, read in place: element c * ks + k (channel-major, the order of
// torch's F.unfold and of the checkpoint's input weight rows) is
// x[b, t * hs + k, c]. The unfolded [B, T', ks * C] stream never exists.
struct UnfoldSource {
  int L;
  int C;
  int ks;
  int hs;
  int frames;  // T' = (L - ks) / hs + 1
  __host__ __device__ int width() const { return ks * C; }
  template <typename T>
  __device__ __forceinline__ float load(const T* __restrict__ x, int b,
                                        int t, int m) const {
    const int c = m / ks;
    const int k = m - c * ks;
    return to_f32(x[(static_cast<size_t>(b) * L + t * hs + k) * C + c]);
  }
  // 32-bit division: the entry points require B * T' < 2^31
  template <typename T>
  __device__ __forceinline__ float load_row(const T* __restrict__ x,
                                            long long n, int m) const {
    const unsigned row = static_cast<unsigned>(n);
    const int b = static_cast<int>(row / static_cast<unsigned>(frames));
    return load(x, b, static_cast<int>(row) - b * frames, m);
  }
};

// The shapes every kernel takes: rows of width D % 4 == 0, H % 4 == 0,
// H <= 256.
inline bool bad_shape(int B, int T_len, int D, int H) {
  return B <= 0 || T_len <= 0 || D <= 0 || H <= 0 || D % 4 != 0 ||
         H % 4 != 0 || H > kMaxThreads;
}

// The source of unfold(ks, hs) over x [B, L, C], or false when the shapes
// are out of range (no frame, ks * C % 4 != 0, B * T' >= 2^31).
inline bool unfold_source(int B, int L, int C, int ks, int hs, int H,
                          UnfoldSource* src) {
  if (C <= 0 || ks <= 0 || hs <= 0 || L < ks) return false;
  const int frames = (L - ks) / hs + 1;
  if (bad_shape(B, frames, ks * C, H) ||
      static_cast<long long>(B) * frames >= (1LL << 31)) {
    return false;
  }
  *src = UnfoldSource{L, C, ks, hs, frames};
  return true;
}

// acc[r][g] += sum_k src[r][k] * w[k][g*H + j], src an f32 smem tile
// [BT][K] (K % 4 == 0), w a row-major [K][4H] matrix in global memory.
template <typename T, int BT>
__device__ __forceinline__ void accumulate(float (&acc)[BT][4],
                                           const float* __restrict__ src,
                                           const T* __restrict__ w, int K,
                                           int H, int j) {
  const int h4 = 4 * H;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float wv[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const T* row = w + static_cast<size_t>(k + kk) * h4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) wv[kk][g] = to_f32(row[g * H]);
    }
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(src + r * K + k);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float a = acc[r][g];
        a = fmaf(v.x, wv[0][g], a);
        a = fmaf(v.y, wv[1][g], a);
        a = fmaf(v.z, wv[2][g], a);
        a = fmaf(v.w, wv[3][g], a);
        acc[r][g] = a;
      }
    }
  }
}

// Stage the input rows of step t into an f32 smem tile [BT][K]:
// tile[r][k] = row (b0 + r, t) of x through `src`, zero for rows past B.
template <int BT, typename T, typename XS>
__device__ __forceinline__ void stage_x(float* __restrict__ tile,
                                        const T* __restrict__ x,
                                        const XS& src, int b0, int B,
                                        int t) {
  const int K = src.width();
  for (int i = threadIdx.x; i < BT * K; i += blockDim.x) {
    const int r = i / K;
    const int k = i - r * K;
    const int b = b0 + r;
    tile[i] = b < B ? src.load(x, b, t, k) : 0.0f;
  }
}

// Stage one time step of a [B, T, width]-strided tensor into an f32 smem
// tile [BT][K]: tile[r][k] = src[((b0 + r) * T_len + t) * stride + offset
// + k], zero for rows past B or when `live` is false.
template <typename T, int BT>
__device__ __forceinline__ void stage_rows(float* __restrict__ tile,
                                           const T* __restrict__ src, int K,
                                           int stride, int offset, int b0,
                                           int B, int T_len, int t,
                                           bool live) {
  for (int i = threadIdx.x; i < BT * K; i += blockDim.x) {
    const int r = i / K;
    const int k = i - r * K;
    const int b = b0 + r;
    tile[i] = (live && b < B)
                  ? to_f32(src[(static_cast<size_t>(b) * T_len + t) * stride +
                               offset + k])
                  : 0.0f;
  }
}

// The forward kernel (its design is described in bilstm_layer.cu). One
// block per (batch tile of BT rows, direction), the time loop inside the
// block, thread j owning hidden unit j; the step's input row is read from
// x through XS.
template <typename T, int BT, typename XS>
__global__ void __launch_bounds__(kMaxThreads)
    bilstm_fwd_kernel(const T* __restrict__ x, XS src,
                      const T* __restrict__ wx_f,
                      const float* __restrict__ b_f,
                      const T* __restrict__ wh_f, const T* __restrict__ wx_b,
                      const float* __restrict__ b_b,
                      const T* __restrict__ wh_b, T* __restrict__ y,
                      float* __restrict__ cs, int B, int T_len, int H) {
  extern __shared__ float4 smem4[];
  const int D = src.width();
  float* xs = reinterpret_cast<float*>(smem4);  // [BT][D]
  float* hs = xs + BT * D;                      // [BT][H]

  const int dir = blockIdx.y;
  const T* __restrict__ wx = dir ? wx_b : wx_f;
  const T* __restrict__ wh = dir ? wh_b : wh_f;
  const float* __restrict__ bias = dir ? b_b : b_f;
  const int b0 = blockIdx.x * BT;
  const int j = threadIdx.x;
  const bool active = j < H;

  float bj[4];
  float c[BT];
  float h_new[BT];
#pragma unroll
  for (int g = 0; g < 4; ++g) bj[g] = active ? bias[g * H + j] : 0.0f;
#pragma unroll
  for (int r = 0; r < BT; ++r) c[r] = 0.0f;
  for (int i = threadIdx.x; i < BT * H; i += blockDim.x) hs[i] = 0.0f;

  for (int s = 0; s < T_len; ++s) {
    const int t = dir ? T_len - 1 - s : s;
    stage_x<BT>(xs, x, src, b0, B, t);
    __syncthreads();  // x_t staged; h_{t-1} written by the previous step

    if (active) {
      float acc[BT][4];
#pragma unroll
      for (int r = 0; r < BT; ++r) {
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = bj[g];
      }
      accumulate<T, BT>(acc, xs, wx, D, H, j);
      accumulate<T, BT>(acc, hs, wh, H, H, j);
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float ig = sigmoidf(acc[r][0]);
        const float fg = sigmoidf(acc[r][1]);
        const float gg = tanhf(acc[r][2]);
        const float og = sigmoidf(acc[r][3]);
        c[r] = fg * c[r] + ig * gg;
        // h enters the next Wh product rounded to the input dtype
        h_new[r] = to_f32(from_f32<T>(og * tanhf(c[r])));
      }
    }
    __syncthreads();  // every thread is done reading x_t and h_{t-1}

    if (active) {
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        hs[r * H + j] = h_new[r];
        const int b = b0 + r;
        if (b < B) {
          const size_t at =
              (static_cast<size_t>(b) * T_len + t) * (2 * H) + dir * H + j;
          y[at] = from_f32<T>(h_new[r]);
          if (cs != nullptr) cs[at] = c[r];
        }
      }
    }
  }
}

// Launch the forward kernel over x (rows through `src`): y [B, T, 2H] in
// T, cs [B, T, 2H] f32 or null; weights wx_* [K, 4H], wh_* [H, 4H] in T,
// biases [4H] f32.
template <typename T, typename XS>
cudaError_t launch_forward(const void* x, const XS& src, const void* wx_f,
                           const void* b_f,
                           const void* wh_f, const void* wx_b,
                           const void* b_b, const void* wh_b, void* y,
                           void* cs, int B, int T_len, int H,
                           cudaStream_t stream) {
  auto kernel = bilstm_fwd_kernel<T, kTile, XS>;
  const size_t smem =
      static_cast<size_t>(kTile) * (src.width() + H) * sizeof(float);
  if (smem > kDefaultSmem) {  // only very wide inputs need the opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((B + kTile - 1) / kTile, 2);
  const int threads = (H + 31) / 32 * 32;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), src, static_cast<const T*>(wx_f),
      static_cast<const float*>(b_f),
      static_cast<const T*>(wh_f), static_cast<const T*>(wx_b),
      static_cast<const float*>(b_b), static_cast<const T*>(wh_b),
      static_cast<T*>(y), static_cast<float*>(cs), B, T_len, H);
  return cudaGetLastError();
}

}  // namespace bilstm
