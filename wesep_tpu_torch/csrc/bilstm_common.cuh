// Device helpers shared by the fused BiLSTM layer kernels
// (bilstm_layer.cu, bilstm_layer_bwd.cu).

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

}  // namespace bilstm
