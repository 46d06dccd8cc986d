// Two-kernel LSTM layers, backward, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of wesep_tpu/ops/pallas_lstm.py:
// `_bi_backward` (the custom VJP of `bilstm_fused`) and `_bwd_impl` (that
// of `lstm_fused`): the adjoint of the recurrence in lstm_fused.cu. Per
// direction and reversed step, with h_{t-1} and c_{t-1} zero at the scan's
// first step:
//
//   g       = xw_t + h_{t-1} @ Wh          (recomputed from xw, f32 sums)
//   i,f,o   = sigmoid(g[..]); gg = tanh(g[..]); tc = tanh(c_t)
//   dh_tot  = dy_t + dh;  do = dh_tot * tc
//   dct     = dh_tot * o * (1 - tc^2) + dc
//   dgates  = [dct*gg*i*(1-i), dct*c_{t-1}*f*(1-f), dct*i*(1-gg^2),
//              do*o*(1-o)]                  (f32)
//   dxw_t   = dgates rounded to the stream's dtype
//   dh      = dxw_t @ Wh^T (f32);  dc = dct * f
//   dWh    += h_{t-1}^T @ dxw_t;  db += sum_rows(dgates)   (unrounded)
//
// The gradients of x and Wx (dx = dxw @ Wx^T, dWx = x^T @ dxw) lie outside
// the TPU kernel, and the wrapper forms them with library products.
//
// Two kernels, those of the plain layer (bilstm_layer_bwd.cu, whose
// header describes their design) in bilstm_backward.cuh, with `XwSource`:
//
// 1. `bilstm_bwd_kernel`, the serial adjoint, without the x half: a step
//    recomputes the gates from the xw row and h_{t-1} @ Wh, writes the
//    rounded dgates to dxw (both the result and the weight-gradient
//    kernel's input) and keeps dh for the next step; no dx product runs
//    inside it. db is summed in registers over a tile's rows and steps
//    and written once per block and direction; the wrapper adds the tiles
//    in a fixed order.
// 2. `bilstm_wgrad_kernel`, the weight gradients over the h half only
//    (A = h_{t-1}, read in place from y shifted one step, zero at the
//    boundary; K = H): dWh[dir] = A^T @ dxw[dir] over the B * T rows in
//    64 x 128 tiles, one slice of the rows per block, the slices' partial
//    tiles added by the wrapper in a fixed order, no atomics, so a run
//    repeats bit for bit.
//
// What bounds them on this card. The adjoint does 2 x 2 x T x B x H x 4H
// operations per direction (gate recompute and dh) against the xw, y, cs,
// dy and dxw streams: at the pBSRNN's training band shape (bf16, both
// directions) 4.0e11 operations (0.41 ms on the tensor cores) against
// 2.4 GB (0.71 ms), bytes on paper; in fact each step's wait on its Wh
// and Wh^T reads from L2, as in the plain layer. The weight-gradient
// product, 2.0e11 operations, runs on the f32 FMA units of plain CUDA
// cores (about 3 ms at 67 TFLOP/s): neither uses the tensor cores yet.

#include "bilstm_backward.cuh"

using namespace bilstm;

namespace {

bool bad_fused(int B, int T_len, int H, int dirs, int reverse) {
  return B <= 0 || T_len <= 0 || H <= 0 || H % 4 != 0 || H > kMaxThreads ||
         dirs < 1 || dirs > 2 || reverse < 0 || reverse > 1 ||
         (dirs == 2 && reverse);
}

// The serial adjoint for `dirs` directions walked as `reverse` says; the
// layout is a template argument of the kernel.
template <typename T>
cudaError_t backward(const void* const* p, int B, int T_len, int H, int dirs,
                     int reverse, cudaStream_t s) {
  const XwSource src{B, T_len, H};
  if (dirs == 2) {
    return launch_backward<T, XwSource, 2, false>(src, p, B, T_len, H, s);
  }
  if (reverse) {
    return launch_backward<T, XwSource, 1, true>(src, p, B, T_len, H, s);
  }
  return launch_backward<T, XwSource, 1, false>(src, p, B, T_len, H, s);
}

template <typename T>
cudaError_t wgrad(const void* y, const void* dxw, void* dw_part, int B,
                  int T_len, int H, int splits, int dirs, int reverse,
                  cudaStream_t s) {
  const XwSource src{B, T_len, H};
  if (dirs == 2) {
    return launch_wgrad<T, XwSource, 2, false>(nullptr, src, y, dxw, dw_part,
                                               B, T_len, H, splits, s);
  }
  if (reverse) {
    return launch_wgrad<T, XwSource, 1, true>(nullptr, src, y, dxw, dw_part,
                                              B, T_len, H, splits, s);
  }
  return launch_wgrad<T, XwSource, 1, false>(nullptr, src, y, dxw, dw_part,
                                             B, T_len, H, splits, s);
}

}  // namespace

// Plain C entry points, bound with ctypes by
// wesep_tpu_torch/ops/cuda_lstm_fused.py. dirs and reverse as the forward
// was launched (lstm_fused.cu). dtype: 0 = f32, 1 = bf16. All tensors are
// contiguous; H % 4 == 0, H <= 256. Both return the CUDA error code of the
// launch (0 on success) and never synchronise.

// The serial adjoint. xw [dirs, B, T, 4H], wh_* [H, 4H] and their
// transposes wht_* [4H, H] in the stream's dtype (the _b ones null when
// dirs is 1); y [B, T, dirs * H] in the stream's dtype and cs [B, T,
// dirs * H] f32 from the forward; dy [B, T, dirs * H] in the stream's
// dtype. Writes dxw [dirs, B, T, 4H] in the stream's dtype and db_part
// [ceil(B / 8), dirs, 4H] f32 (one bias sum per batch tile and direction).
extern "C" int lstm_fused_backward(const void* xw, const void* wh_f,
                                   const void* wh_b, const void* wht_f,
                                   const void* wht_b, const void* y,
                                   const void* cs, const void* dy, void* dxw,
                                   void* db_part, int B, int T_len, int H,
                                   int dirs, int reverse, int dtype,
                                   void* stream) {
  if (bad_fused(B, T_len, H, dirs, reverse)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* const p[17] = {xw,      nullptr, nullptr, wh_f,  nullptr,
                             nullptr, wh_b,    nullptr, wht_f, nullptr,
                             wht_b,   y,       cs,      dy,    nullptr,
                             dxw,     db_part};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = backward<float>(p, B, T_len, H, dirs, reverse, s);
  } else if (dtype == 1) {
    err = backward<__nv_bfloat16>(p, B, T_len, H, dirs, reverse, s);
  }
  return static_cast<int>(err);
}

// The weight gradients. y [B, T, dirs * H], dxw [dirs, B, T, 4H] in the
// stream's dtype; writes dw_part [splits, dirs, H, 4H] f32: each slice of
// the B * T rows' dWh for each direction.
extern "C" int lstm_fused_wgrad(const void* y, const void* dxw,
                                void* dw_part, int B, int T_len, int H,
                                int splits, int dirs, int reverse, int dtype,
                                void* stream) {
  if (bad_fused(B, T_len, H, dirs, reverse) || splits <= 0 ||
      splits > 32767) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = wgrad<float>(y, dxw, dw_part, B, T_len, H, splits, dirs, reverse,
                       s);
  } else if (dtype == 1) {
    err = wgrad<__nv_bfloat16>(y, dxw, dw_part, B, T_len, H, splits, dirs,
                               reverse, s);
  }
  return static_cast<int>(err);
}
