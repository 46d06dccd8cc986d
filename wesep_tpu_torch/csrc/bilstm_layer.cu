// Fused bidirectional LSTM layer, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel wesep_tpu/ops/pallas_lstm.py
// `_bi_layer_forward` (reached through `bilstm_layer`): both directions of
// one LSTM layer, with the input projection x_t @ Wx computed inside the
// kernel so the [T, B, 4H] gate stream never reaches device memory.
//
//   g_t = x_t @ Wx + b + h_{t-1} @ Wh        gate order i, f, g, o
//   c_t = f * c_{t-1} + i * g,  h_t = o * tanh(c_t)
//
// h is rounded to the input dtype before it enters the Wh product; c, the
// gates and the bias stay in f32; y is stored in the input dtype. The
// backward direction walks time from T-1 down to 0. Output [B, T, 2H] is
// forward and backward concatenated on the last axis.
//
// What bounds it on this card. Per layer the work is 2 dirs x 2 x T x B x
// (D + H) x 4H operations against a few tens of MB of x, y and weights, so
// the function is compute-bound on paper (at BSRNN shapes ~38 GFLOP). The
// recurrence is serial in T, and at the band RNN's shape (B = 64 rows, T =
// 376) only a handful of batch tiles exist, so few SMs have work: the real
// limit is each step's wait on its Wx and Wh reads (1.5 MB per direction
// in f32) from L2 with only 8 warps per SM in flight. On an H100 the bf16
// kernel, with half those bytes, runs no faster than the f32 one, so it is
// this latency, not bandwidth or arithmetic, that sets the time.
//
// Design (simple first version). One block per (batch tile of kTile rows,
// direction); the time loop runs inside the block, in place of the TPU's
// sequential grid axis. Thread j owns hidden unit j: it computes gate
// columns j, H+j, 2H+j, 3H+j for all kTile rows, keeping c in registers.
// The x_t and h_{t-1} tiles sit in shared memory as f32 and are read as
// broadcast float4s; Wx and Wh are read straight from global memory,
// coalesced across threads, and stay resident in the 50 MB L2. Two
// __syncthreads() per step separate the reads of h_{t-1} from the writes of
// h_t. The tile of 8 rows spreads the serving batch (64 rows in the band
// RNN) over 16 SMs. Rows past B in the last tile are computed on zeros and
// never stored. When a backward pass will follow, the cell states c_t are
// written beside y in f32 (the adjoint kernel in bilstm_layer_bwd.cu reads
// them); serving passes no buffer and writes nothing more. Shapes the
// route gates of ops/cuda_lstm_tc.py (bf16: lstm_forward_tc.cu) and
// ops/cuda_lstm_f32.py (f32: lstm_forward_f32.cu, Wh held on chip over a
// thread-block cluster) take no longer reach this kernel; it runs the
// shapes they refuse.
//
// The kernel is `bilstm_fwd_kernel` in bilstm_common.cuh, shared with the
// unfold-fused layer (bilstm_unfold.cu), which differs only in where a
// step's input row comes from (`RowSource` here).

#include "bilstm_common.cuh"

// Plain C entry point, bound with ctypes by wesep_tpu_torch/ops/cuda_lstm.py.
// Shapes: x [B, T, D]; wx_* [D, 4H], wh_* [H, 4H] in x's dtype; b_* [4H]
// f32; y [B, T, 2H] in x's dtype; cs [B, T, 2H] f32 or null (the cell
// states, written only when a backward pass will need them); all
// contiguous. dtype: 0 = f32, 1 = bf16. Requires D % 4 == 0, H % 4 == 0, H <= 256. Returns the CUDA
// error code of the launch (0 on success); never synchronises.
extern "C" int bilstm_layer_forward(const void* x, const void* wx_f,
                                    const void* b_f, const void* wh_f,
                                    const void* wx_b, const void* b_b,
                                    const void* wh_b, void* y, void* cs,
                                    int B, int T_len, int D, int H,
                                    int dtype, void* stream) {
  if (B <= 0 || T_len <= 0) return 0;
  if (D % 4 != 0 || H % 4 != 0 || H > bilstm::kMaxThreads || D <= 0 || H <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  const bilstm::RowSource src{T_len, D};
  if (dtype == 0) {
    err = bilstm::launch_forward<float>(x, src, wx_f, b_f, wh_f, wx_b, b_b,
                                        wh_b, y, cs, B, T_len, H, s);
  } else if (dtype == 1) {
    err = bilstm::launch_forward<__nv_bfloat16>(x, src, wx_f, b_f, wh_f,
                                                wx_b, b_b, wh_b, y, cs, B,
                                                T_len, H, s);
  }
  return static_cast<int>(err);
}
