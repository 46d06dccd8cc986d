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
// 1. `bilstm_layer_bwd_kernel`, the serial adjoint. Same layout as the
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
// 2. `bilstm_layer_wgrad_kernel`, the weight gradients. The TPU kernel
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

#include "bilstm_common.cuh"

namespace {

using namespace bilstm;

// out[r] += sum_{k0 <= k < k1} src[r * ld + k] * wt[k * ncol + col], src an
// f32 smem tile, wt a row-major [*, ncol] matrix in global memory;
// k0 and k1 multiples of 4.
template <typename T, int BT>
__device__ __forceinline__ void accumulate_t(float (&out)[BT],
                                             const float* __restrict__ src,
                                             int ld,
                                             const T* __restrict__ wt,
                                             int ncol, int col, int k0,
                                             int k1) {
#pragma unroll 2
  for (int k = k0; k < k1; k += 4) {
    float wv[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wv[kk] = to_f32(wt[static_cast<size_t>(k + kk) * ncol + col]);
    }
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(src + r * ld + k);
      float a = out[r];
      a = fmaf(v.x, wv[0], a);
      a = fmaf(v.y, wv[1], a);
      a = fmaf(v.z, wv[2], a);
      a = fmaf(v.w, wv[3], a);
      out[r] = a;
    }
  }
}

template <typename T, int BT>
__global__ void __launch_bounds__(kMaxThreads, 2)
    bilstm_layer_bwd_kernel(const T* __restrict__ x,
                            const T* __restrict__ wx_f,
                            const float* __restrict__ b_f,
                            const T* __restrict__ wh_f,
                            const T* __restrict__ wx_b,
                            const float* __restrict__ b_b,
                            const T* __restrict__ wh_b,
                            const T* __restrict__ wxt_f,
                            const T* __restrict__ wht_f,
                            const T* __restrict__ wxt_b,
                            const T* __restrict__ wht_b,
                            const T* __restrict__ y,
                            const float* __restrict__ cs,
                            const T* __restrict__ dy, T* __restrict__ dx2,
                            T* __restrict__ dg, float* __restrict__ db_part,
                            int B, int T_len, int D, int H) {
  extern __shared__ float4 smem4[];
  const int h4 = 4 * H;
  float* xs = reinterpret_cast<float*>(smem4);  // [BT][D]   x_t
  float* hs = xs + BT * D;                      // [BT][H]   h_{t-1}
  float* dgs = hs + BT * H;                     // [BT][4H]  rounded dgates
  float* dxp = dgs + BT * h4;                   // [2][BT][D] halves of dx_t

  const int dir = blockIdx.y;
  const T* __restrict__ wx = dir ? wx_b : wx_f;
  const T* __restrict__ wh = dir ? wh_b : wh_f;
  const T* __restrict__ wxt = dir ? wxt_b : wxt_f;  // [4H][D]
  const T* __restrict__ wht = dir ? wht_b : wht_f;  // [4H][H]
  const float* __restrict__ bias = dir ? b_b : b_f;
  const int b0 = blockIdx.x * BT;
  const int j = threadIdx.x;
  const bool active = j < H;

  float bj[4];
  float db[4];
  float dh[BT];
  float dc[BT];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    bj[g] = active ? bias[g * H + j] : 0.0f;
    db[g] = 0.0f;
  }
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    dh[r] = 0.0f;
    dc[r] = 0.0f;
  }

  for (int s = 0; s < T_len; ++s) {
    // the adjoint walks the forward's steps backwards: the forward
    // direction from T-1 down, the backward direction from 0 up
    const int t = dir ? s : T_len - 1 - s;
    const int tp = dir ? t + 1 : t - 1;  // the forward's previous step
    const bool has_prev = tp >= 0 && tp < T_len;
    stage_rows<T, BT>(xs, x, D, D, 0, b0, B, T_len, t, true);
    stage_rows<T, BT>(hs, y, H, 2 * H, dir * H, b0, B, T_len,
                      has_prev ? tp : t, has_prev);
    __syncthreads();  // (1) x_t and h_{t-1} staged

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
        const int b = b0 + r;
        const bool valid = b < B;
        const size_t row = static_cast<size_t>(valid ? b : 0) * T_len;
        const size_t at = (row + t) * (2 * H) + dir * H + j;
        const float c_t = valid ? cs[at] : 0.0f;
        const float c_prev =
            (valid && has_prev) ? cs[(row + tp) * (2 * H) + dir * H + j]
                                : 0.0f;
        const float dy_t = valid ? to_f32(dy[at]) : 0.0f;
        const float ig = sigmoidf(acc[r][0]);
        const float fg = sigmoidf(acc[r][1]);
        const float gg = tanhf(acc[r][2]);
        const float og = sigmoidf(acc[r][3]);
        const float tc = tanhf(c_t);
        const float dh_total = dy_t + dh[r];
        const float d_o = dh_total * tc;
        const float dct = dh_total * og * (1.0f - tc * tc) + dc[r];
        float d[4];
        d[0] = (dct * gg) * ig * (1.0f - ig);
        d[1] = (dct * c_prev) * fg * (1.0f - fg);
        d[2] = (dct * ig) * (1.0f - gg * gg);
        d[3] = d_o * og * (1.0f - og);
        dc[r] = dct * fg;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          db[g] += d[g];  // the bias sums the unrounded dgates
          const T lp = from_f32<T>(d[g]);
          dgs[r * h4 + g * H + j] = to_f32(lp);
          if (valid) {
            dg[((static_cast<size_t>(dir) * B + b) * T_len + t) * h4 +
               g * H + j] = lp;
          }
        }
      }
    }
    __syncthreads();  // (2) the tile's rounded dgates are in shared memory

    if (active) {
#pragma unroll
      for (int r = 0; r < BT; ++r) dh[r] = 0.0f;
      accumulate_t<T, BT>(dh, dgs, h4, wht, H, j, 0, h4);
    }
    // dx_t = dg @ Wx^T: item w sums half w / D of the 4H axis for column
    // w % D; the two halves meet in shared memory
    for (int w = threadIdx.x; w < 2 * D; w += blockDim.x) {
      const int half = w / D;
      const int col = w - half * D;
      float part[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) part[r] = 0.0f;
      accumulate_t<T, BT>(part, dgs, h4, wxt, D, col, half * 2 * H,
                          (half + 1) * 2 * H);
#pragma unroll
      for (int r = 0; r < BT; ++r) dxp[(half * BT + r) * D + col] = part[r];
    }
    __syncthreads();  // (3) both halves of dx_t are in shared memory

    for (int i = threadIdx.x; i < BT * D; i += blockDim.x) {
      const int r = i / D;
      const int k = i - r * D;
      const int b = b0 + r;
      if (b < B) {
        dx2[((static_cast<size_t>(dir) * B + b) * T_len + t) * D + k] =
            from_f32<T>(dxp[i] + dxp[BT * D + i]);
      }
    }
  }

  if (active) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      db_part[(static_cast<size_t>(blockIdx.x) * 2 + dir) * h4 + g * H + j] =
          db[g];
    }
  }
}

constexpr int kWgM = 64;    // rows of dW (of [x ; h]) per block
constexpr int kWgN = 128;   // columns of dW (of dg) per block
constexpr int kWgK = 16;    // (batch, time) rows staged per iteration
constexpr int kWgThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kWgThreads)
    bilstm_layer_wgrad_kernel(const T* __restrict__ x,
                              const T* __restrict__ y,
                              const T* __restrict__ dg,
                              float* __restrict__ dw_part, int B, int T_len,
                              int D, int H, int rows_per_split) {
  __shared__ __align__(16) float a_s[kWgK][kWgM];
  __shared__ __align__(16) float b_s[kWgK][kWgN];

  const int M = D + H;
  const int h4 = 4 * H;
  const long long rows = static_cast<long long>(B) * T_len;
  const int m0 = blockIdx.x * kWgM;
  const int c0 = blockIdx.y * kWgN;
  const int dir = blockIdx.z & 1;
  const int split = blockIdx.z >> 1;
  const long long n_begin = static_cast<long long>(split) * rows_per_split;
  const long long n_end =
      n_begin + rows_per_split < rows ? n_begin + rows_per_split : rows;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows m0 + 4 ty .. + 3
  const int tx = tid % 16;  // columns c0 + 4 tx .. + 3 and c0 + 64 + 4 tx ..
  const T* __restrict__ dg_dir = dg + static_cast<size_t>(dir) * rows * h4;
  const int step = dir ? 1 : -1;  // where h_{t-1} lies, in rows of y

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
  }

  for (long long n0 = n_begin; n0 < n_end; n0 += kWgK) {
#pragma unroll
    for (int q = 0; q < kWgK * kWgM / kWgThreads; ++q) {
      const int idx = tid + q * kWgThreads;
      const int kk = idx / kWgM;
      const int m = m0 + idx % kWgM;
      const long long n = n0 + kk;
      float v = 0.0f;
      if (n < n_end && m < M) {
        if (m < D) {
          v = to_f32(x[n * D + m]);
        } else {
          const int tp = static_cast<int>(n % T_len) + step;
          if (tp >= 0 && tp < T_len) {
            v = to_f32(y[(n + step) * (2 * H) + dir * H + (m - D)]);
          }
        }
      }
      a_s[kk][idx % kWgM] = v;
    }
#pragma unroll
    for (int q = 0; q < kWgK * kWgN / kWgThreads; ++q) {
      const int idx = tid + q * kWgThreads;
      const int kk = idx / kWgN;
      const int c = c0 + idx % kWgN;
      const long long n = n0 + kk;
      b_s[kk][idx % kWgN] =
          (n < n_end && c < h4) ? to_f32(dg_dir[n * h4 + c]) : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kWgK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[kk][4 * ty]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&b_s[kk][4 * tx]);
      const float4 b_hi =
          *reinterpret_cast<const float4*>(&b_s[kk][64 + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                           b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
      }
    }
    __syncthreads();
  }

  float* out = dw_part + (static_cast<size_t>(split) * 2 + dir) * M * h4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = c0 + (c < 4 ? 4 * tx + c : 64 + 4 * tx + c - 4);
      if (col < h4) out[static_cast<size_t>(m) * h4 + col] = acc[i][c];
    }
  }
}

template <typename T>
cudaError_t launch_backward(const void* const* p, int B, int T_len, int D,
                            int H, cudaStream_t stream) {
  auto kernel = bilstm_layer_bwd_kernel<T, kTile>;
  const size_t smem =
      static_cast<size_t>(kTile) * (3 * D + 5 * H) * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((B + kTile - 1) / kTile, 2);
  const int threads = (H + 31) / 32 * 32;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const float*>(p[2]), static_cast<const T*>(p[3]),
      static_cast<const T*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<const T*>(p[6]), static_cast<const T*>(p[7]),
      static_cast<const T*>(p[8]), static_cast<const T*>(p[9]),
      static_cast<const T*>(p[10]), static_cast<const T*>(p[11]),
      static_cast<const float*>(p[12]), static_cast<const T*>(p[13]),
      static_cast<T*>(const_cast<void*>(p[14])),
      static_cast<T*>(const_cast<void*>(p[15])),
      static_cast<float*>(const_cast<void*>(p[16])), B, T_len, D, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgrad(const void* x, const void* y, const void* dg,
                         void* dw_part, int B, int T_len, int D, int H,
                         int splits, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * T_len;
  const int rows_per_split = static_cast<int>((rows + splits - 1) / splits);
  const dim3 grid((D + H + kWgM - 1) / kWgM, (4 * H + kWgN - 1) / kWgN,
                  2 * splits);
  bilstm_layer_wgrad_kernel<T><<<grid, kWgThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(dg), static_cast<float*>(dw_part), B, T_len, D, H,
      rows_per_split);
  return cudaGetLastError();
}

bool bad_shape(int B, int T_len, int D, int H) {
  return B <= 0 || T_len <= 0 || D <= 0 || H <= 0 || D % 4 != 0 ||
         H % 4 != 0 || H > kMaxThreads;
}

}  // namespace

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
  const void* const p[17] = {x,     wx_f,  b_f,   wh_f, wx_b, b_b,
                             wh_b,  wxt_f, wht_f, wxt_b, wht_b, y,
                             cs,    dy,    dx2,   dg,   db_part};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = launch_backward<float>(p, B, T_len, D, H, s);
  } else if (dtype == 1) {
    err = launch_backward<__nv_bfloat16>(p, B, T_len, D, H, s);
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
  if (dtype == 0) {
    err = launch_wgrad<float>(x, y, dg, dw_part, B, T_len, D, H, splits, s);
  } else if (dtype == 1) {
    err = launch_wgrad<__nv_bfloat16>(x, y, dg, dw_part, B, T_len, D, H,
                                      splits, s);
  }
  return static_cast<int>(err);
}
