// Fused gLN TCN block of SpEx+ / ConvTasNet, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel wesep_tpu/ops/pallas_tcn.py `_fwd_kernel`
// (`_fwd_call`, the forward of `tcn_block_gln`). Per sample b, with x
// [T, C], H bottleneck channels and a depthwise conv of k taps at
// `dilation`:
//
//   u   = PReLU_p0(x @ W1 + b1_eff[b])              rounded to x's dtype
//   mu0, rs0 = mean and 1 / sqrt(var + eps) of u over (T, H)   (f32 sums
//              of the rounded u; var = max(E[u^2] - mu0^2, 0))
//   n0  = a0 * u + c0,  a0 = g0w * rs0, c0 = g0b - mu0 * a0    zero outside
//         [0, T)
//   v   = bd + sum_kk kd[kk] * n0[t + kk * dilation - pad_lo]
//   w   = PReLU_p1(v)                    (n0, v, w in x's dtype, op by op)
//   mu1, rs1 = the same statistics of w
//   q   = (g1w * w) @ W2                             rounded to x's dtype
//   y   = x + rs1 * q + (c1 @ W2 + b2),  c1 = g1b - mu1 * g1w * rs1
//
// The TPU kernel keeps one sample's whole [T, H] stream in VMEM and walks
// a sequential grid; here the two global statistics are the boundaries
// between launches on one stream, and u and g1w * w pass through device
// memory once each (scratch from the wrapper):
//
//   1. tcn_u_kernel      tiled product -> u, per-block sums of u, u^2
//   2. tcn_stats_kernel  the partial sums in order -> mu0, rs0
//   3. tcn_dconv_kernel  taps of n0 -> v -> w; writes g1w * w and the
//                        per-block sums of w, w^2
//   4. tcn_stats_kernel  -> mu1, rs1
//   5. tcn_corr_kernel   c1 @ W2 + b2 per sample
//   6. tcn_out_kernel    tiled product (g1w * w) @ W2 with the combine
//                        y = x + rs1 * q + corr in its epilogue
//
// Both products are shared-memory tiled (128 x 128 x 16, 8 x 8 sums per
// thread) on the f32 FMA units with f32 accumulation: bf16 inputs are
// widened when staged, which is exact. Every sum over blocks is added in a
// fixed order, so a run repeats bit for bit.
//
// What bounds it on this card. 4 * B * T * C * H + 2 * B * T * H * k
// operations against x read and y written once: at B = 16, T = 4799,
// C = 256, H = 512 that is 4.0e10 operations, 0.04 ms at 989 TFLOP/s in
// bf16 and 0.6 ms at 67 TFLOP/s in f32, against 0.02 to 0.05 ms for the
// bytes: operations bound it. The products here run at the f32 FMA rate in
// both dtypes and do not use the tensor cores yet.

#include "tcn_common.cuh"

namespace {

using namespace tcn;

// stats[b * 4 + slot] = mean, stats[b * 4 + slot + 1] = 1 / sqrt(var + eps)
// from the per-block sums part[b][P][2]; one block per sample.
__global__ void tcn_stats_kernel(const float* __restrict__ part,
                                 float* __restrict__ stats, int P, float nhw,
                                 float eps, int slot) {
  const int b = blockIdx.x;
  const float* p = part + static_cast<size_t>(b) * P * 2;
  float s0 = 0.0f;
  float s1 = 0.0f;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    s0 += p[2 * i];
    s1 += p[2 * i + 1];
  }
  block_sum2(s0, s1);
  if (threadIdx.x == 0) {
    const float mu = s0 / nhw;
    const float var = fmaxf(s1 / nhw - mu * mu, 0.0f);
    stats[b * 4 + slot] = mu;
    stats[b * 4 + slot + 1] = 1.0f / sqrtf(var + eps);
  }
}

// v and w from the taps of u in the stream's dtype, op by op; writes
// gw = g1w * w and the block's sums of w and w^2.
template <typename T>
__global__ void __launch_bounds__(kEwThreads)
    tcn_dconv_kernel(const T* __restrict__ u, const float* __restrict__ stats,
                     const float* __restrict__ g0w,
                     const float* __restrict__ g0b, const T* __restrict__ kd,
                     const float* __restrict__ bd,
                     const float* __restrict__ g1w,
                     const float* __restrict__ p1_ptr, T* __restrict__ gw,
                     float* __restrict__ part, int T_len, int H, int k,
                     int dilation, int pad_lo) {
  const int b = blockIdx.z;
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  const int nc = ew_chunks(T_len);
  for (int cy = blockIdx.y; cy < nc; cy += gridDim.y) {
  const int t0 = cy * kChunkRows;
  const int t1 = min(t0 + kChunkRows, T_len);
  float sum = 0.0f;
  float sq = 0.0f;
  if (h < H) {
    const float mu0 = stats[b * 4];
    const float rs0 = stats[b * 4 + 1];
    const float a0 = g0w[h] * rs0;
    const float c0 = g0b[h] - mu0 * a0;
    const float a0c = rnd<T>(a0);
    const float c0c = rnd<T>(c0);
    const float bdc = rnd<T>(bd[h]);
    const float p1c = rnd<T>(*p1_ptr);
    const float g1c = rnd<T>(g1w[h]);
    float kdc[kMaxTaps];
#pragma unroll
    for (int kk = 0; kk < kMaxTaps; ++kk) {
      kdc[kk] = kk < k ? to_f32(kd[static_cast<size_t>(kk) * H + h]) : 0.0f;
    }
    const size_t base = static_cast<size_t>(b) * T_len * H + h;
    for (int t = t0; t < t1; ++t) {
      float v = bdc;
#pragma unroll
      for (int kk = 0; kk < kMaxTaps; ++kk) {
        if (kk < k) {
          const int tt = t + kk * dilation - pad_lo;
          float n0 = 0.0f;
          if (tt >= 0 && tt < T_len) {
            const float uu = to_f32(u[base + static_cast<size_t>(tt) * H]);
            n0 = rnd<T>(rnd<T>(a0c * uu) + c0c);
          }
          v = rnd<T>(v + rnd<T>(kdc[kk] * n0));
        }
      }
      const float w = v >= 0.0f ? v : rnd<T>(p1c * v);
      sum += w;
      sq += w * w;
      gw[base + static_cast<size_t>(t) * H] = from_f32<T>(g1c * w);
    }
  }
  block_sum2(sum, sq);
  if (threadIdx.x == 0) {
    const size_t blocks = static_cast<size_t>(gridDim.x) * nc;
    const size_t at =
        (b * blocks + static_cast<size_t>(cy) * gridDim.x + blockIdx.x) * 2;
    part[at] = sum;
    part[at + 1] = sq;
  }
  __syncthreads();  // block_sum2's scratch is read before the next chunk
  }
}

// corr[b][c] = sum_h c1[b][h] * W2[h][c] + b2[c], c1 rounded to the
// stream's dtype, f32 sums.
template <typename T>
__global__ void tcn_corr_kernel(const float* __restrict__ stats,
                                const float* __restrict__ g1w,
                                const float* __restrict__ g1b,
                                const T* __restrict__ w2,
                                const float* __restrict__ b2,
                                float* __restrict__ corr, int H, int C) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float mu1 = stats[b * 4 + 2];
  const float rs1 = stats[b * 4 + 3];
  float acc = 0.0f;
  for (int h = 0; h < H; ++h) {
    const float c1 = g1b[h] - mu1 * g1w[h] * rs1;
    acc = fmaf(rnd<T>(c1), to_f32(w2[static_cast<size_t>(h) * C + c]), acc);
  }
  corr[static_cast<size_t>(b) * C + c] = acc + b2[c];
}

// y = x + rs1 * round(gw @ W2) + corr, one block per (128 rows of one
// sample, 128 output channels).
template <typename T>
__global__ void __launch_bounds__(kGemmThreads, 2)
    tcn_out_kernel(const T* __restrict__ gw, const T* __restrict__ w2,
                   const T* __restrict__ x, const float* __restrict__ stats,
                   const float* __restrict__ corr, T* __restrict__ y,
                   int T_len, int H, int C) {
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  float acc[8][8];
  gemm_nn<T>(acc, gw + static_cast<size_t>(b) * T_len * H, H, T_len, H, w2, C,
             C, m0, n0);
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const float rs1 = stats[b * 4 + 3];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + tile_index(ty, i);
    if (row >= T_len) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tile_index(tx, j);
      if (col >= C) continue;
      const size_t idx = (static_cast<size_t>(b) * T_len + row) * C + col;
      const float q = rnd<T>(acc[i][j]);
      y[idx] = from_f32<T>(to_f32(x[idx]) + rs1 * q +
                           corr[static_cast<size_t>(b) * C + col]);
    }
  }
}

template <typename T>
cudaError_t forward(const void* x, const void* b1_eff, const void* w1,
                    const void* p0, const void* kd, const void* bd,
                    const void* g0w, const void* g0b, const void* p1,
                    const void* w2, const void* b2, const void* g1w,
                    const void* g1b, void* y, void* stats, void* stream_ws,
                    void* f32_ws, int B, int T_len, int C, int H, int k,
                    int dilation, int pad_lo, float eps, cudaStream_t stream) {
  const size_t n_stream = static_cast<size_t>(B) * T_len * H;
  T* u = static_cast<T*>(stream_ws);
  T* gw = u + n_stream;
  const dim3 ew = ew_grid(B, T_len, H);
  const int p_u = u_blocks(T_len, H);
  const int p_w = static_cast<int>(ew.x) * ew_chunks(T_len);
  float* part_u = static_cast<float*>(f32_ws);
  float* part_w = part_u + static_cast<size_t>(B) * p_u * 2;
  float* corr = part_w + static_cast<size_t>(B) * p_w * 2;
  float* st = static_cast<float*>(stats);
  const float nhw = static_cast<float>(T_len) * static_cast<float>(H);

  TCN_CHECK(launch_u<T>(static_cast<const T*>(x), static_cast<const T*>(w1),
                        static_cast<const float*>(b1_eff),
                        static_cast<const float*>(p0), u, nullptr, part_u, B,
                        T_len, C, H, stream));
  tcn_stats_kernel<<<B, 128, 0, stream>>>(part_u, st, p_u, nhw, eps, 0);
  TCN_CHECK(cudaGetLastError());
  tcn_dconv_kernel<T><<<ew, ew_threads(H), 0, stream>>>(
      u, st, static_cast<const float*>(g0w), static_cast<const float*>(g0b),
      static_cast<const T*>(kd), static_cast<const float*>(bd),
      static_cast<const float*>(g1w), static_cast<const float*>(p1), gw,
      part_w, T_len, H, k, dilation, pad_lo);
  TCN_CHECK(cudaGetLastError());
  tcn_stats_kernel<<<B, 128, 0, stream>>>(part_w, st, p_w, nhw, eps, 2);
  TCN_CHECK(cudaGetLastError());
  tcn_corr_kernel<T><<<dim3((C + 127) / 128, B), 128, 0, stream>>>(
      st, static_cast<const float*>(g1w), static_cast<const float*>(g1b),
      static_cast<const T*>(w2), static_cast<const float*>(b2), corr, H, C);
  TCN_CHECK(cudaGetLastError());
  const dim3 grid((T_len + kBM - 1) / kBM, (C + kBN - 1) / kBN, B);
  tcn_out_kernel<T><<<grid, kGemmThreads, 0, stream>>>(
      gw, static_cast<const T*>(w2), static_cast<const T*>(x), st, corr,
      static_cast<T*>(y), T_len, H, C);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes by
// wesep_tpu_torch/ops/cuda_tcn.py. dtype: 0 = f32, 1 = bf16.

// Elements of the two scratch buffers the forward needs: n_stream of the
// stream's dtype and n_f32 floats.
extern "C" void tcn_block_forward_scratch(int B, int T_len, int C, int H,
                                          long long* n_stream,
                                          long long* n_f32) {
  const dim3 ew = tcn::ew_grid(B, T_len, H);
  *n_stream = 2LL * B * T_len * H;
  *n_f32 = 2LL * B * tcn::u_blocks(T_len, H) +
           2LL * B * ew.x * tcn::ew_chunks(T_len) + 1LL * B * C;
}

// x [B, T, C], w1 [C, H], kd [k, H], w2 [H, C] in the stream's dtype;
// b1_eff [B, H], bd, g0w, g0b, g1w, g1b [H], b2 [C], p0, p1 [1] f32. Writes
// y [B, T, C] in the stream's dtype and stats [B, 4] f32 = (mu0, rs0, mu1,
// rs1). All contiguous and 16-byte aligned; C % 8 == 0, H % 8 == 0,
// k <= 8. Returns the CUDA error code of the first launch that failed
// (0 on success) and never synchronises.
extern "C" int tcn_block_forward(
    const void* x, const void* b1_eff, const void* w1, const void* p0,
    const void* kd, const void* bd, const void* g0w, const void* g0b,
    const void* p1, const void* w2, const void* b2, const void* g1w,
    const void* g1b, void* y, void* stats, void* stream_ws, void* f32_ws,
    int B, int T_len, int C, int H, int k, int dilation, int pad_lo,
    int dtype, float eps, void* stream) {
  if (tcn::bad_shape(B, T_len, C, H, k, dilation, pad_lo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = forward<float>(x, b1_eff, w1, p0, kd, bd, g0w, g0b, p1, w2, b2, g1w,
                         g1b, y, stats, stream_ws, f32_ws, B, T_len, C, H, k,
                         dilation, pad_lo, eps, s);
  } else if (dtype == 1) {
    err = forward<__nv_bfloat16>(x, b1_eff, w1, p0, kd, bd, g0w, g0b, p1, w2,
                                 b2, g1w, g1b, y, stats, stream_ws, f32_ws, B,
                                 T_len, C, H, k, dilation, pad_lo, eps, s);
  }
  return static_cast<int>(err);
}
