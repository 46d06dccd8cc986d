// Fused bidirectional LSTM layer, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel wesep_tpu/ops/pallas_lstm.py
// `_bi_layer_backward` (the custom VJP of `bilstm_layer`): the adjoint of
// the forward kernel in bilstm_layer.cu. Per direction and per reversed
// time step, with h_{t-1} and c_{t-1} zero at the sequence boundary:
//
//   g       = x_t @ Wx + b + h_{t-1} @ Wh          (recomputed, f32 sums)
//   i,f,o   = sigmoid(g[..]); gg = tanh(g[..]); tc = tanh(c_t)
//   dh_tot  = dy_t + dh;  do = dh_tot * tc
//   dct     = dh_tot * o * (1 - tc^2) + dc
//   dgates  = [dct*gg*i*(1-i), dct*c_{t-1}*f*(1-f), dct*i*(1-gg^2),
//              do*o*(1-o)]                          (f32)
//   dg      = dgates rounded to x's dtype
//   dh      = dg @ Wh^T;  dx_t = dg @ Wx^T;  dc = dct * f
//   dWx    += x_t^T @ dg;  dWh += h_{t-1}^T @ dg;  db += sum_rows(dgates)
//
// Two kernels do it.
//
// 1. `bilstm_bwd_kernel`, the serial adjoint. Same layout as the
//    forward: one block per (batch tile of kTile rows, direction), the time
//    loop inside the block, thread j owning hidden unit j. A step stages x_t
//    and h_{t-1} in shared memory, recomputes the four gate columns of unit
//    j for every row (the forward's `accumulate`), forms dgates in
//    registers, and writes them, rounded, to shared memory and to the dg
//    scratch in device memory. Then dh[r][j] = sum_k dg[r][k] Wh^T[k][j]
//    stays in thread j's registers for the next step, and dx_t = dg @ Wx^T
//    is split in two halves of the 4H axis over the threads, summed through
//    shared memory and stored per direction. Wx^T and Wh^T are read from
//    transposed copies the wrapper makes once per call, so that both
//    products read global memory coalesced like the forward's. db is summed
//    in registers over the tile's rows and steps and written once per
//    block; the wrapper adds the tiles' sums and the two directions' dx in
//    a fixed order, as the JAX package adds its per-tile sums outside its
//    kernel. Rows past B load x, h, c, dy as zero, so their dgates are zero.
//    Three __syncthreads() per step. The launch bounds ask for two blocks
//    per SM (at most 128 registers a thread, a few spilled): measured on an
//    H100 the bf16 build, 166 registers and one block per SM without them,
//    then takes 28.8 ms instead of 40.3 ms at the shape with many tiles
//    (T = 32, B = 6016) and 41.9 instead of 40.3 ms at the one-wave shape
//    (T = 376, B = 512).
//
// 2. `bilstm_wgrad_kernel`, the weight gradients. The TPU kernel
//    keeps dWx and dWh ((D + H) x 4H f32, 1.5 MB per direction at D = 128,
//    H = 256) in VMEM across its sequential grid; a Hopper block has 227 KB
//    of shared memory, and thread j of the layout above would need
//    (D + H) * 4 registers. So the serial kernel only streams dg, and this
//    kernel contracts it afterwards: dW[dir] = A^T @ dg[dir] over the
//    N = B * T rows, A[n] = [x_t ; h_{t-1}] read in place from x and y
//    (shifted one step, zero at the boundary). A tiled product: a block
//    owns a 64 x 128 tile of dW for one slice of the N axis, stages 16 rows
//    of A and dg at a time in shared memory as f32, and each of 256 threads
//    keeps a 4 x 8 tile of f32 sums. The slices' partial tiles go to device
//    memory and the wrapper adds them in a fixed order, so the result does
//    not change from run to run.
//
// The kernels are `bilstm_bwd_kernel` and `bilstm_wgrad_kernel` in
// bilstm_backward.cuh, shared with the unfold-fused layer
// (bilstm_unfold_bwd.cu), which differs only in where a step's input row
// comes from (`RowSource` here).
//
// Scratch. dg holds 2 * B * T * 4H elements in x's dtype: at the training
// band shape (B = 512, T = 376, H = 256) 0.79 GB in bf16 and 1.58 GB in
// f32; it lives only from the first kernel to the second.
//
// What bounds them on this card. With the recompute the layer's backward is
// 2 * 6 * T * B * (D + H) * 4H operations, 9.1e11 at the training band
// shape: 0.92 ms at 989 TFLOP/s in bf16, 13.6 ms at 67 TFLOP/s in f32,
// against 0.26 ms for its bytes (x, ys, cs, dys, dx), so operations bound
// it on paper. In fact the serial kernel is bound like the forward, by each
// step's wait on its weight reads from L2 (twice the forward's per step),
// and the weight-gradient kernel by the f32 FMA rate of plain CUDA cores:
// neither uses the tensor cores yet.

#include "bilstm_backward.cuh"

using namespace bilstm;

// Plain C entry points, bound with ctypes by
// wesep_tpu_torch/ops/cuda_lstm.py. dtype: 0 = f32, 1 = bf16. Both return
// the CUDA error code of the launch (0 on success) and never synchronise.
// All tensors are contiguous; D % 4 == 0, H % 4 == 0, H <= 256.

// The serial adjoint. x [B, T, D]; wx_* [D, 4H], wh_* [H, 4H] and their
// transposes wxt_* [4H, D], wht_* [4H, H] in x's dtype; b_* [4H] f32;
// y [B, T, 2H] in x's dtype and cs [B, T, 2H] f32 from the forward;
// dy [B, T, 2H] in x's dtype. Writes dx2 [2, B, T, D] (one dx per
// direction) and dg [2, B, T, 4H] in x's dtype, and db_part
// [ceil(B / 8), 2, 4H] f32 (one bias sum per batch tile and direction).
extern "C" int bilstm_layer_backward(
    const void* x, const void* wx_f, const void* b_f, const void* wh_f,
    const void* wx_b, const void* b_b, const void* wh_b, const void* wxt_f,
    const void* wht_f, const void* wxt_b, const void* wht_b, const void* y,
    const void* cs, const void* dy, void* dx2, void* dg, void* db_part, int B,
    int T_len, int D, int H, int dtype, void* stream) {
  if (bad_shape(B, T_len, D, H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* const p[17] = {x,     wx_f,  b_f,   wh_f,  wx_b, b_b,
                             wh_b,  wxt_f, wht_f, wxt_b, wht_b, y,
                             cs,    dy,    dx2,   dg,    db_part};
  const RowSource src{T_len, D};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = launch_backward<float>(src, p, B, T_len, H, s);
  } else if (dtype == 1) {
    err = launch_backward<__nv_bfloat16>(src, p, B, T_len, H, s);
  }
  return static_cast<int>(err);
}

// The weight gradients. x [B, T, D], y [B, T, 2H], dg [2, B, T, 4H] in x's
// dtype; writes dw_part [splits, 2, D + H, 4H] f32: for each slice of the
// B * T rows and each direction, rows :D are that slice's dWx and rows D:
// its dWh.
extern "C" int bilstm_layer_wgrad(const void* x, const void* y,
                                  const void* dg, void* dw_part, int B,
                                  int T_len, int D, int H, int splits,
                                  int dtype, void* stream) {
  if (bad_shape(B, T_len, D, H) || splits <= 0 || splits > 32767) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  const RowSource src{T_len, D};
  if (dtype == 0) {
    err = launch_wgrad<float>(x, src, y, dg, dw_part, B, T_len, H, splits,
                              s);
  } else if (dtype == 1) {
    err = launch_wgrad<__nv_bfloat16>(x, src, y, dg, dw_part, B, T_len, H,
                                      splits, s);
  }
  return static_cast<int>(err);
}
