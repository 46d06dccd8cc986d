// Fused DPCCN Conv2dBlock, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel wesep_tpu/ops/pallas_conv2d.py
// `_fwd_kernel` (`_fwd_call`, the forward of `conv2d_block_in`). Per sample
// b and output channel c, with N = T * F positions:
//
//   e   = ELU(conv3x3(x) + bias)         x, K in the stream's dtype, f32
//                                        sums; bias and e f32
//   mu  = sum(round(e)) / N,  var = max(sum(round(e * e)) / N - mu^2, 0)
//   rs  = 1 / sqrt(var + eps)
//   y   = round((e - mu) * rs)           from the unrounded e
//
// round() is to the stream's dtype (the identity for f32). Outputs: y
// [B, T, F, Co] and stats [B, 2, Co] f32 = (mu, rs), which the backward
// takes instead of e.
//
// The TPU kernel packs F into the 128 lanes as a block-Toeplitz product
// (16-channel operands waste the TPU's lanes) and walks a sequential grid
// twice, recomputing e. Here the conv runs channels-last, three launches on
// one stream:
//
//   1. conv3x3_kernel<kForward>  tiles of 4-16 rows x 32 columns x 16-64
//                                channels: the x halo and K staged in
//                                shared memory, 4 x 8 f32 sums per thread;
//                                e to an f32 scratch, per-tile sums
//   2. conv_reduce_kernel        the per-tile sums in a fixed order -> stats
//   3. conv_norm_kernel          y from e and the statistics
//
// What bounds it on this card. 2 * 9 * Ci * Co operations per output
// against x read and y written once: at DPCCN's widest gated shape
// (enc0.conv2: B 8, T 376, F 257, Ci 32, Co 16, bf16) 7.1e9 operations,
// 7 us at 989 TFLOP/s, against 74 MB, 22 us at 3.35 TB/s: bytes bound it.
// The products run on the f32 FMA units (~0.1 ms at that shape at 67
// TFLOP/s), and e makes one round trip through device memory in f32
// (2 x 50 MB there) instead of being recomputed: at f32 FMA rates a second
// conv costs more than the round trip.

#include "conv2d_common.cuh"

namespace {

using namespace conv2d;

// y = round((e - mu) * rs), eight channels per thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_norm_kernel(const float* __restrict__ e,
                     const float* __restrict__ stats, T* __restrict__ y,
                     long long n8, long long positions, int Co) {
  const int groups = Co / 8;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n8; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long pos = i / groups;
    const int c0 = static_cast<int>(i % groups) * 8;
    const long long b = pos / positions;
    const float* st = stats + b * 2 * Co + c0;
    float v[8];
    load8(e + pos * Co + c0, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (v[j] - st[j]) * st[Co + j];
    store8(y + pos * Co + c0, v);
  }
}

template <typename T>
cudaError_t forward(const void* x, const void* w, const void* bias, void* y,
                    void* stats, void* f32_ws, int B, int T_len, int F_len,
                    int Ci, int Co, float eps, cudaStream_t stream) {
  float* e = static_cast<float*>(f32_ws);
  float* part = e + stream_elems(B, T_len, F_len, Co);
  float* st = static_cast<float*>(stats);
  TCN_CHECK((launch_conv<T, kForward>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), nullptr, nullptr, e, nullptr, part, B,
      T_len, F_len, Ci, Co, stream)));
  const float n = static_cast<float>(T_len) * static_cast<float>(F_len);
  TCN_CHECK(reduce_tiles(part, st, B, conv_tiles(T_len, F_len, Co), Co, n,
                         eps, 1, stream));
  const long long positions = static_cast<long long>(T_len) * F_len;
  const long long n8 = B * positions * (Co / 8);
  const long long blocks = (n8 + kThreads - 1) / kThreads;
  conv_norm_kernel<T><<<static_cast<int>(blocks < 65536 ? blocks : 65536),
                        kThreads, 0, stream>>>(e, st, static_cast<T*>(y), n8,
                                               positions, Co);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes by
// wesep_tpu_torch/ops/cuda_conv2d.py. dtype: 0 = f32, 1 = bf16.

// Elements of the two scratch buffers the forward needs: none of the
// stream's dtype (n_stream = 0) and n_f32 floats (e and the per-tile sums).
extern "C" void conv2d_block_forward_scratch(int B, int T_len, int F_len,
                                             int Ci, int Co,
                                             long long* n_stream,
                                             long long* n_f32) {
  (void)Ci;
  *n_stream = 0;
  *n_f32 = static_cast<long long>(
      conv2d::stream_elems(B, T_len, F_len, Co) +
      2ULL * B * conv2d::conv_tiles(T_len, F_len, Co) * Co);
}

// x [B, T, F, Ci] and w [3, 3, Ci, Co] (HWIO) in the stream's dtype, bias
// [Co] f32. Writes y [B, T, F, Co] in the stream's dtype and stats
// [B, 2, Co] f32 = (mu, rs). All contiguous and 16-byte aligned; Ci and Co
// multiples of 8, at most 256. Returns the CUDA error code of the first
// launch that failed (0 on success) and never synchronises.
extern "C" int conv2d_block_forward(const void* x, const void* w,
                                    const void* bias, void* y, void* stats,
                                    void* f32_ws, int B, int T_len, int F_len,
                                    int Ci, int Co, int dtype, float eps,
                                    void* stream) {
  if (conv2d::bad_shape(B, T_len, F_len, Ci, Co)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = forward<float>(x, w, bias, y, stats, f32_ws, B, T_len, F_len, Ci,
                         Co, eps, s);
  } else if (dtype == 1) {
    err = forward<__nv_bfloat16>(x, w, bias, y, stats, f32_ws, B, T_len,
                                 F_len, Ci, Co, eps, s);
  }
  return static_cast<int>(err);
}
