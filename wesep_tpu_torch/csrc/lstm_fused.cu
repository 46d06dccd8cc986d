// Two-kernel LSTM layers, forward, for Hopper (sm_90a): the recurrence
// over a precomputed gate projection.
//
// Replaces two Pallas TPU kernels of wesep_tpu/ops/pallas_lstm.py:
// `_bi_forward` (reached through `bilstm_fused`: both directions of a
// bidirectional layer in one kernel) and `_forward` (reached through
// `lstm_fused`: one direction, with `reverse`). In both the input
// projection is done outside the kernel, by a library product, as XLA does
// it in the JAX package:
//
//   xw  = x @ Wx + b           f32 sums, rounded to the stream's dtype
//   g_t = xw_t + h_{t-1} @ Wh  gate order i, f, g, o
//   c_t = f * c_{t-1} + i * g,  h_t = o * tanh(c_t)
//
// and the kernel runs only the recurrence. h is rounded to the stream's
// dtype before it enters the Wh product and when it is stored; c and the
// gates stay in f32.
//
// What bounds it on this card. Per layer and direction 2 x T x B x H x 4H
// operations against the xw stream (T x B x 4H in the stream's dtype) and
// the y and cs outputs: at the pBSRNN's training band shape (T 376, B 512,
// H 256, bf16, both directions) 2.0e11 operations (0.20 ms on the tensor
// cores) against 1.38 GB (0.41 ms), so bytes bound it on paper. In fact,
// like the plain layer's forward (bilstm_layer.cu), it is bound by each
// step's wait on its Wh reads from L2 with few warps per SM in flight; it
// drops that kernel's x @ Wx work (D x 4H of the (D + H) x 4H weights a
// step reads) and reads the 4H-wide xw row instead.
//
// Design. The kernel is `bilstm_fwd_kernel` of bilstm_common.cuh, shared
// with the plain and unfold-fused layers, with `XwSource`: a step's gates
// start from the xw row (loaded before the step's barrier, so the loads
// overlap the wait) instead of from the bias plus an in-kernel x_t @ Wx.
// One block per (batch tile of 8 rows, direction), the time loop inside
// the block, thread j owning hidden unit j. The number of directions (2
// for `_bi_forward`, 1 for `_forward`) and `reverse` are template
// arguments of the kernel: with two directions the second walks time
// backwards; with one, `reverse` says which way it walks. y and cs rows
// hold dirs * H values, so the bidirectional layer writes [B, T, 2H]
// (forward then backward features) and the JAX package's concatenation
// is never made.

#include "bilstm_common.cuh"

namespace {

using bilstm::XwSource;
using bilstm::launch_forward;

// The forward over xw for `dirs` directions walked as `reverse` says; the
// layout is a template argument of the kernel.
template <typename T>
cudaError_t forward(const void* xw, const void* wh_f, const void* wh_b,
                    void* y, void* cs, int B, int T_len, int H, int dirs,
                    int reverse, cudaStream_t s) {
  const XwSource src{B, T_len, H};
  if (dirs == 2) {
    return launch_forward<T, XwSource, 2, false>(xw, src, nullptr, nullptr,
                                                 wh_f, nullptr, nullptr, wh_b,
                                                 y, cs, B, T_len, H, s);
  }
  if (reverse) {
    return launch_forward<T, XwSource, 1, true>(xw, src, nullptr, nullptr,
                                                wh_f, nullptr, nullptr,
                                                nullptr, y, cs, B, T_len, H,
                                                s);
  }
  return launch_forward<T, XwSource, 1, false>(xw, src, nullptr, nullptr,
                                               wh_f, nullptr, nullptr,
                                               nullptr, y, cs, B, T_len, H,
                                               s);
}

}  // namespace

// Plain C entry point, bound with ctypes by
// wesep_tpu_torch/ops/cuda_lstm_fused.py. Shapes: xw [dirs, B, T, 4H] and
// wh_* [H, 4H] in the stream's dtype (wh_b null when dirs is 1); y [B, T,
// dirs * H] in the stream's dtype; cs [B, T, dirs * H] f32 or null (the
// cell states, written only when a backward pass will need them); all
// contiguous. dirs 2 with reverse 0 (the second direction walks time
// backwards), or dirs 1 with reverse 0 or 1 (1: the direction walks time
// backwards). dtype: 0 = f32, 1 = bf16. Requires H % 4 == 0, H <= 256.
// Returns the CUDA error code of the launch (0 on success); never
// synchronises.
extern "C" int lstm_fused_forward(const void* xw, const void* wh_f,
                                  const void* wh_b, void* y, void* cs, int B,
                                  int T_len, int H, int dirs, int reverse,
                                  int dtype, void* stream) {
  if (B <= 0 || T_len <= 0) return 0;
  if (H <= 0 || H % 4 != 0 || H > bilstm::kMaxThreads || dirs < 1 ||
      dirs > 2 || reverse < 0 || reverse > 1 || (dirs == 2 && reverse)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = forward<float>(xw, wh_f, wh_b, y, cs, B, T_len, H, dirs, reverse,
                         s);
  } else if (dtype == 1) {
    err = forward<__nv_bfloat16>(xw, wh_f, wh_b, y, cs, B, T_len, H, dirs,
                                 reverse, s);
  }
  return static_cast<int>(err);
}
