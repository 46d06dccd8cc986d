// Unfold-fused bidirectional LSTM layer, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel wesep_tpu/ops/pallas_lstm.py
// `_bi_unfold_forward` (reached through `bilstm_layer_unfold`): unfold(ks,
// hs) of a raw [B, L, C] stream followed by both directions of one LSTM
// layer, TF-GridNet's intra- and inter-frame RNNs. Frame t of direction
// "forward" is the row x[b, t*hs : t*hs + ks, :] read channel-major,
//
//   u_t[c * ks + k] = x[b, t * hs + k, c],      T' = (L - ks) / hs + 1,
//
// and the layer is the plain fused layer (bilstm_layer.cu) on u: the
// backward direction walks frames T'-1 down to 0. Rounding as there: h is
// rounded to the input dtype before the Wh product, c, the gates and the
// bias stay f32, y is stored in the input dtype.
//
// What it keeps out of device memory. Feeding the plain layer would
// materialise u, a [B, T', ks * C] stream ks times wider than x (at
// TF-GridNet's training intra shape, B 2056, L 71, C 48, ks 4: 107 MB in
// bf16 against x's 14 MB). Here the kernel stages each step's frame straight
// from x into shared memory (`UnfoldSource`, bilstm_common.cuh), so u never
// exists; the input weight stays in the checkpoint's channel-major row
// order [ks * C, 4H] and needs no permutation either way.
//
// What bounds it on this card. The work is 2 dirs x 2 x T' x B x (ks*C +
// H) x 4H operations, 1.65e11 at that shape (0.17 ms at 989 TFLOP/s in
// bf16, 2.5 ms at 67 TFLOP/s in f32) against ~0.34 GB of x, y and cs
// (0.1 ms at 3.35 TB/s): operations bound it on paper. In fact it is bound
// like the plain layer's kernel, by each step's wait on its Wx and Wh reads
// from L2 with 6 warps per block and few blocks where rows are few (the
// inter RNN at serving: 142 rows, 18 tiles x 2 directions on 132 SMs).
//
// Design. The kernel is the plain layer's (`bilstm_fwd_kernel`,
// bilstm_common.cuh) with another x source: one block per (batch tile of 8
// rows, direction), the frame loop inside the block, thread j owning hidden
// unit j; the staged frame gathers ks rows of x that lie next to each other
// in memory, so a warp's loads stay within one contiguous ks * C window.
// The TPU kernel's tap-major weight permutation, its 2 * ks shifted block
// specs and its lane concatenation of taps have no counterpart here.

#include "bilstm_common.cuh"

// Plain C entry point, bound with ctypes by
// wesep_tpu_torch/ops/cuda_lstm_unfold.py. Shapes: x [B, L, C]; wx_*
// [ks * C, 4H] (rows c * ks + k), wh_* [H, 4H] in x's dtype; b_* [4H] f32;
// y [B, T', 2H] in x's dtype; cs [B, T', 2H] f32 or null (the cell states,
// written only when a backward pass will need them); all contiguous.
// dtype: 0 = f32, 1 = bf16. Requires L >= ks, ks * C % 4 == 0, H % 4 == 0,
// H <= 256 and B * T' < 2^31. Returns the CUDA error code of the launch (0
// on success); never synchronises.
extern "C" int bilstm_unfold_forward(const void* x, const void* wx_f,
                                     const void* b_f, const void* wh_f,
                                     const void* wx_b, const void* b_b,
                                     const void* wh_b, void* y, void* cs,
                                     int B, int L, int C, int ks, int hs,
                                     int H, int dtype, void* stream) {
  if (B <= 0) return 0;
  bilstm::UnfoldSource src;
  if (!bilstm::unfold_source(B, L, C, ks, hs, H, &src)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = bilstm::launch_forward<float>(x, src, wx_f, b_f, wh_f, wx_b, b_b,
                                        wh_b, y, cs, B, src.frames, H, s);
  } else if (dtype == 1) {
    err = bilstm::launch_forward<__nv_bfloat16>(x, src, wx_f, b_f, wh_f,
                                                wx_b, b_b, wh_b, y, cs, B,
                                                src.frames, H, s);
  }
  return static_cast<int>(err);
}
