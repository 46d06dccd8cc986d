// Unfold-fused bidirectional LSTM layer, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel wesep_tpu/ops/pallas_lstm.py
// `_bi_unfold_backward` (the custom VJP of `bilstm_layer_unfold`): the
// adjoint of bilstm_unfold.cu. With u_t the frame of step t (see there),
// per direction and reversed step the same equations as the plain layer's
// adjoint (bilstm_layer_bwd.cu): gates recomputed from (u_t, h_{t-1}),
// dgates in f32, rounded to the input dtype as dg before every product (db
// sums the unrounded ones), dh = dg @ Wh^T, du_t = dg @ Wx^T,
// dWx += u_t^T @ dg, dWh += h_{t-1}^T @ dg.
//
// Two kernels, the plain layer's with another x source (`UnfoldSource`):
//
// 1. `bilstm_unfold_backward`, the serial adjoint: stages u_t straight from
//    the raw x, and writes du [2, B, T', ks * C] per direction, rounded to
//    the input dtype, beside the dg scratch [2, B, T', 4H] and the bias
//    sums per batch tile. The wrapper adds the two directions' du in the
//    input dtype and folds the sum back onto x's rows with ks shift-adds in
//    tap order, as the JAX package does outside its kernel, so the rounding
//    points are the JAX package's; rows of x in no frame (hs > 1, or the
//    tail past (T' - 1) * hs + ks) get zero.
// 2. `bilstm_unfold_wgrad`, the weight gradients: dW[dir] = A^T @ dg[dir]
//    with A[n] = [u_t ; h_{t-1}] gathered by index from x and y in place,
//    so the unfolded stream is not materialised here either; one partial
//    per slice of the B * T' rows, added by the wrapper in a fixed order:
//    the same bits from run to run.
//
// What bounds them on this card. The model backward is 2 dirs x 4 x T' x
// B x (ks*C + H) x 4H operations (3.3e11 at the training intra shape, 0.33
// ms at 989 TFLOP/s in bf16, 4.9 ms at 67 TFLOP/s in f32), and the serial
// kernel adds the gate recompute. As for the plain layer, the serial kernel
// is bound by each step's wait on its weight reads from L2 and the
// weight-gradient kernel by the f32 FMA rate: neither uses the tensor
// cores yet.

#include "bilstm_backward.cuh"

using namespace bilstm;

// Plain C entry points, bound with ctypes by
// wesep_tpu_torch/ops/cuda_lstm_unfold.py. dtype: 0 = f32, 1 = bf16. Both
// return the CUDA error code of the launch (0 on success) and never
// synchronise. All tensors are contiguous; L >= ks, ks * C % 4 == 0,
// H % 4 == 0, H <= 256, B * T' < 2^31.

// The serial adjoint. x [B, L, C]; wx_* [ks * C, 4H], wh_* [H, 4H] and
// their transposes wxt_* [4H, ks * C], wht_* [4H, H] in x's dtype; b_*
// [4H] f32; y [B, T', 2H] in x's dtype and cs [B, T', 2H] f32 from the
// forward; dy [B, T', 2H] in x's dtype. Writes du2 [2, B, T', ks * C] (one
// du per direction) and dg [2, B, T', 4H] in x's dtype, and db_part
// [ceil(B / 8), 2, 4H] f32 (one bias sum per batch tile and direction).
extern "C" int bilstm_unfold_backward(
    const void* x, const void* wx_f, const void* b_f, const void* wh_f,
    const void* wx_b, const void* b_b, const void* wh_b, const void* wxt_f,
    const void* wht_f, const void* wxt_b, const void* wht_b, const void* y,
    const void* cs, const void* dy, void* du2, void* dg, void* db_part, int B,
    int L, int C, int ks, int hs, int H, int dtype, void* stream) {
  const void* const p[17] = {x,     wx_f,  b_f,   wh_f,  wx_b, b_b,
                             wh_b,  wxt_f, wht_f, wxt_b, wht_b, y,
                             cs,    dy,    du2,   dg,    db_part};
  UnfoldSource src;
  if (!unfold_source(B, L, C, ks, hs, H, &src)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = launch_backward<float>(src, p, B, src.frames, H, s);
  } else if (dtype == 1) {
    err = launch_backward<__nv_bfloat16>(src, p, B, src.frames, H, s);
  }
  return static_cast<int>(err);
}

// The weight gradients. x [B, L, C], y [B, T', 2H], dg [2, B, T', 4H] in
// x's dtype; writes dw_part [splits, 2, ks * C + H, 4H] f32: for each slice
// of the B * T' rows and each direction, rows :ks*C are that slice's dWx
// (rows c * ks + k) and rows ks*C: its dWh.
extern "C" int bilstm_unfold_wgrad(const void* x, const void* y,
                                   const void* dg, void* dw_part, int B,
                                   int L, int C, int ks, int hs, int H,
                                   int splits, int dtype, void* stream) {
  UnfoldSource src;
  if (splits <= 0 || splits > 32767 ||
      !unfold_source(B, L, C, ks, hs, H, &src)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = launch_wgrad<float>(x, src, y, dg, dw_part, B, src.frames, H,
                              splits, s);
  } else if (dtype == 1) {
    err = launch_wgrad<__nv_bfloat16>(x, src, y, dg, dw_part, B, src.frames,
                                      H, splits, s);
  }
  return static_cast<int>(err);
}
