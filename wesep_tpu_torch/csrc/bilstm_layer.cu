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
// them); serving passes no buffer and writes nothing more. Keeping Wh
// resident on chip (split over a thread-block cluster) and running the
// products on the tensor cores is later work.

#include "bilstm_common.cuh"

namespace {

using namespace bilstm;

template <typename T, int BT>
__global__ void __launch_bounds__(kMaxThreads)
    bilstm_layer_fwd_kernel(const T* __restrict__ x,
                            const T* __restrict__ wx_f,
                            const float* __restrict__ b_f,
                            const T* __restrict__ wh_f,
                            const T* __restrict__ wx_b,
                            const float* __restrict__ b_b,
                            const T* __restrict__ wh_b, T* __restrict__ y,
                            float* __restrict__ cs, int B, int T_len, int D,
                            int H) {
  extern __shared__ float4 smem4[];
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
    stage_rows<T, BT>(xs, x, D, D, 0, b0, B, T_len, t, true);
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

template <typename T>
cudaError_t launch(const void* x, const void* wx_f, const void* b_f,
                   const void* wh_f, const void* wx_b, const void* b_b,
                   const void* wh_b, void* y, void* cs, int B, int T_len,
                   int D, int H, cudaStream_t stream) {
  auto kernel = bilstm_layer_fwd_kernel<T, kTile>;
  const size_t smem = static_cast<size_t>(kTile) * (D + H) * sizeof(float);
  if (smem > kDefaultSmem) {  // only very wide inputs need the opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((B + kTile - 1) / kTile, 2);
  const int threads = (H + 31) / 32 * 32;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wx_f),
      static_cast<const float*>(b_f), static_cast<const T*>(wh_f),
      static_cast<const T*>(wx_b), static_cast<const float*>(b_b),
      static_cast<const T*>(wh_b), static_cast<T*>(y),
      static_cast<float*>(cs), B, T_len, D, H);
  return cudaGetLastError();
}

}  // namespace

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
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, y, cs, B, T_len,
                        D, H, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, y, cs,
                                B, T_len, D, H, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
