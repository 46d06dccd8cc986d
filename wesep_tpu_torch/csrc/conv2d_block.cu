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
// What bounds it on this card. 2 * 9 * Ci * Co operations per output
// against x read and y written once: at DPCCN's widest gated shape
// (enc0.conv2: B 8, T 376, F 257, Ci 32, Co 16, bf16) 7.1e9 operations,
// 7 us at 989 TFLOP/s, against 74 MB, 22 us at 3.35 TB/s: bytes bound it.
//
// bf16: three launches (conv2d_tc.cuh), as the TPU kernel's two phases
// over x with e recomputed:
//   1. conv_tc_kernel<kStats>  the conv on the tensor cores, e, f64 sums
//                              of round(e), round(e * e) per warp of a
//                              tile
//   2. conv_reduce64_kernel    the sums in a fixed order -> stats
//   3. conv_tc_kernel<kNorm>   the conv again, y written once
// Recomputing e costs a second read of x (Ci x 2 bytes a position) and a
// second product on the tensor cores, where keeping it would write and read
// Co x 4 bytes a position.
//
// f32: three launches on the FMA units (conv2d_common.cuh), where a second
// conv would cost more than e's round trip through device memory (on an
// H100, the norm launch 0.012 ms against 0.133 ms for the conv at
// enc0.conv2, B 2; PERF.md):
//   1. conv3x3_kernel<kForward>  tiles of 4-16 rows x 32 columns x 16-64
//                                channels, 4 x 8 f32 sums per thread; e to
//                                an f32 scratch, per-tile sums
//   2. conv_reduce_kernel        the per-tile sums in a fixed order -> stats
//   3. conv_norm_kernel          y from e and the statistics

#include "conv2d_tc.cuh"

namespace {

using namespace conv2d;

// y = (e - mu) * rs, eight channels per thread.
__global__ void __launch_bounds__(kThreads)
    conv_norm_kernel(const float* __restrict__ e,
                     const float* __restrict__ stats, float* __restrict__ y,
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

// Floats of the f32 scratch: f32, e and the per-tile sums; bf16, the f64
// sums of each warp of each tile (two floats each).
long long scratch_f32(int B, int T_len, int F_len, int Co, int dtype) {
  if (dtype == 0) {
    return static_cast<long long>(stream_elems(B, T_len, F_len, Co) +
                                  2ULL * B * conv_tiles(T_len, F_len, Co) *
                                      Co);
  }
  return 2LL * B * tc_tiles(T_len, F_len) * kTcWarps * 2 * Co;
}

cudaError_t forward_f32(const float* x, const float* w, const float* bias,
                        float* y, float* st, float* f32_ws, int B, int T_len,
                        int F_len, int Ci, int Co, float eps, tcn::Marks& mk,
                        cudaStream_t stream) {
  float* e = f32_ws;
  float* part = e + stream_elems(B, T_len, F_len, Co);
  TCN_CHECK(mk.done(cudaSuccess, stream));
  TCN_CHECK(mk.done(launch_conv<kForward>(x, w, bias, nullptr, nullptr, e,
                                          nullptr, part, B, T_len, F_len, Ci,
                                          Co, stream),
                    stream));
  const float n = static_cast<float>(T_len) * static_cast<float>(F_len);
  TCN_CHECK(mk.done(reduce_tiles(part, st, B, conv_tiles(T_len, F_len, Co),
                                 Co, n, eps, 1, stream),
                    stream));
  const long long positions = static_cast<long long>(T_len) * F_len;
  const long long n8 = B * positions * (Co / 8);
  const long long blocks = (n8 + kThreads - 1) / kThreads;
  conv_norm_kernel<<<static_cast<int>(blocks < 65536 ? blocks : 65536),
                     kThreads, 0, stream>>>(e, st, y, n8, positions, Co);
  return mk.done(cudaGetLastError(), stream);
}

cudaError_t forward_bf16(const __nv_bfloat16* x, const float* w,
                         const float* bias, __nv_bfloat16* y, float* st,
                         float* f32_ws, int B, int T_len, int F_len, int Ci,
                         int Co, float eps, tcn::Marks& mk,
                         cudaStream_t stream) {
  double* part = reinterpret_cast<double*>(f32_ws);
  TcArgs a{x, w, bias, st, nullptr, nullptr, y, part, nullptr,
           B, T_len, F_len, Ci, Co};
  TCN_CHECK(mk.done(cudaSuccess, stream));
  TCN_CHECK(mk.done(launch_tc<kStats>(a, 0, stream), stream));
  const double n = static_cast<double>(T_len) * F_len;
  TCN_CHECK(mk.done(reduce64(part, st, nullptr, B,
                             tc_tiles(T_len, F_len) * kTcWarps, Co, n, eps,
                             stream),
                    stream));
  return mk.done(launch_tc<kNorm>(a, 0, stream), stream);
}

}  // namespace

// Plain C entry points, bound with ctypes by
// wesep_tpu_torch/ops/cuda_conv2d.py. dtype: 0 = f32, 1 = bf16.

// Elements of the two scratch buffers the forward needs: none of the
// stream's dtype (n_stream = 0) and n_f32 floats (see scratch_f32).
extern "C" void conv2d_block_forward_scratch(int B, int T_len, int F_len,
                                             int Ci, int Co, int dtype,
                                             long long* n_stream,
                                             long long* n_f32) {
  (void)Ci;
  *n_stream = 0;
  *n_f32 = scratch_f32(B, T_len, F_len, Co, dtype);
}

// x [B, T, F, Ci] in the stream's dtype, w [3, 3, Ci, Co] (HWIO) and bias
// [Co] f32 (a bf16 stream rounds w as it reads it). Writes y [B, T, F, Co]
// in the stream's dtype and stats [B, 2, Co] f32 = (mu, rs). f32_ws holds
// n_f32 floats, at least what conv2d_block_forward_scratch asks. All
// contiguous and 16-byte aligned; Ci and Co multiples of 8, at most 256. events: null, or n_events CUDA
// events, recorded before the first of the three launches and after each
// in turn. Returns the CUDA error code of the first launch that failed (0
// on success) and never synchronises.
extern "C" int conv2d_block_forward(const void* x, const void* w,
                                    const void* bias, void* y, void* stats,
                                    void* f32_ws, void* events, int B,
                                    int T_len, int F_len, int Ci, int Co,
                                    int dtype, int n_events, long long n_f32,
                                    float eps, void* stream) {
  if (conv2d::bad_shape(B, T_len, F_len, Ci, Co) || (dtype != 0 && dtype != 1)
      || n_f32 < scratch_f32(B, T_len, F_len, Co, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tcn::Marks mk{static_cast<void* const*>(events), n_events, 0};
  cudaError_t err;
  if (dtype == 0) {
    err = forward_f32(static_cast<const float*>(x),
                      static_cast<const float*>(w),
                      static_cast<const float*>(bias), static_cast<float*>(y),
                      static_cast<float*>(stats),
                      static_cast<float*>(f32_ws), B, T_len, F_len, Ci, Co,
                      eps, mk, s);
  } else {
    err = forward_bf16(static_cast<const __nv_bfloat16*>(x),
                       static_cast<const float*>(w),
                       static_cast<const float*>(bias),
                       static_cast<__nv_bfloat16*>(y),
                       static_cast<float*>(stats), static_cast<float*>(f32_ws),
                       B, T_len, F_len, Ci, Co, eps, mk, s);
  }
  return static_cast<int>(err);
}
