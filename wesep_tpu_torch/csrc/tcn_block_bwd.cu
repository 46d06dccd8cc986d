// Fused gLN TCN block of SpEx+ / ConvTasNet, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel wesep_tpu/ops/pallas_tcn.py `_bwd_kernel`
// (`_bwd_call`, the custom VJP of `tcn_block_gln`): the adjoint of the
// forward in tcn_block.cu, from x, dy and the saved statistics (mu0, rs0,
// mu1, rs1). Nothing else is saved: u is recomputed, as on the TPU. With
// nhw = T * H and every sum below per sample unless it is a parameter's:
//
//   s    = x @ W1 + b1_eff;  u = round(PReLU_p0(s))           (recomputed)
//   n0   = a0 * u + c0 (f32), zero outside [0, T);  v = bd + sum kd * taps
//   w    = round(PReLU_p1(v));  s1hat = (w - mu1) * rs1
//   n1   = g1w * s1hat + g1b
//   dn1  = dy @ W2^T;  dW2 = round(n1)^T @ dy;  db2 = sum dy
//   dg1  = sum dn1 * s1hat;  dbe1 = sum dn1
//   m0   = sum(g1w * dn1) / nhw;  m1 = sum(g1w * dn1 * s1hat) / nhw
//   dw   = rs1 * (g1w * dn1 - m0 - s1hat * m1)
//   dp1  = sum dw * min(v, 0);  dv = dw * (v >= 0 ? 1 : p1)
//   dbd  = sum dv;  dkd[kk] = sum dv * tap_kk
//   dn0[t] = sum_kk kd[kk] * round(dv)[t - kk * dilation + pad_lo]
//            (a gather at the mirrored shifts, in the stream's dtype)
//   s0hat = (u - mu0) * rs0;  dg0 = sum dn0 * s0hat;  dbe0 = sum dn0
//   m2, m3 likewise from g0w * dn0;  du = rs0 * (g0w * dn0 - m2 - s0hat * m3)
//   dp0  = sum du * min(s, 0);  ds = du * (s >= 0 ? 1 : p0)
//   db1_eff[b] = sum_t ds;  dx = dy + round(ds) @ W1^T;  dW1 = x^T @ round(ds)
//
// The TPU kernel walks three sequential sweeps over VMEM-resident scratch
// and scatters dn0; here each global sum is a boundary between launches on
// one stream, the streams between them (u, s, dn1, round(n1), round(dv),
// dn0, round(ds)) pass through scratch in device memory, and dn0 is
// gathered, so nothing is atomic:
//
//   tcn_u_kernel          u, s                      (product 1)
//   tcn_dn1_kernel        dn1 = dy @ W2^T           (product 2)
//   tcn_colsum_kernel     db2
//   tcn_gln1_kernel       round(n1); dg1, dbe1; sums for m0, m1
//   tcn_dv_kernel         round(dv); dbd, dkd, dp1
//   tcn_wgrad_kernel      dW2 = round(n1)^T @ dy    (product 3, split rows)
//   tcn_dn0_kernel        dn0; dg0, dbe0; sums for m2, m3
//   tcn_ds_kernel         round(ds); db1_eff, dp0
//   tcn_dx_kernel         dx = dy + round(ds) @ W1^T  (product 4)
//   tcn_wgrad_kernel      dW1 = x^T @ round(ds)     (product 5, split rows)
//
// Every sum over rows is written as per-block partials and added by
// tcn_sum_partials_kernel in a fixed order, so the gradients repeat bit
// for bit from run to run. The products are the 128 x 128 x 16 tiles of
// tcn_common.cuh on the f32 FMA units.
//
// What bounds it on this card. The model's count is 8 * B * T * C * H +
// 4 * B * T * H * k operations (10 * B * T * C * H executed with the
// recompute) against x and dy read and dx written once: at B = 16,
// T = 4799, C = 256, H = 512, 8.1e10 operations, 0.08 ms at 989 TFLOP/s in
// bf16 and 1.2 ms at 67 TFLOP/s in f32, against 0.04 to 0.07 ms for the
// bytes: operations bound it. The tensor cores are not used yet.

#include "tcn_common.cuh"

namespace {

using namespace tcn;

// dn1 = dy @ W2^T (f32), w2t = W2^T [C, H].
template <typename T>
__global__ void __launch_bounds__(kGemmThreads, 2)
    tcn_dn1_kernel(const T* __restrict__ dy, const T* __restrict__ w2t,
                   float* __restrict__ dn1, int T_len, int C, int H) {
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  float acc[8][8];
  gemm_nn<T>(acc, dy + static_cast<size_t>(b) * T_len * C, C, T_len, C, w2t,
             H, H, m0, n0);
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + tile_index(ty, i);
    if (row >= T_len) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tile_index(tx, j);
      if (col >= H) continue;
      dn1[(static_cast<size_t>(b) * T_len + row) * H + col] = acc[i][j];
    }
  }
}

// dx = dy + round(ds) @ W1^T, w1t = W1^T [H, C].
template <typename T>
__global__ void __launch_bounds__(kGemmThreads, 2)
    tcn_dx_kernel(const T* __restrict__ dsc, const T* __restrict__ w1t,
                  const T* __restrict__ dy, T* __restrict__ dx, int T_len,
                  int H, int C) {
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  float acc[8][8];
  gemm_nn<T>(acc, dsc + static_cast<size_t>(b) * T_len * H, H, T_len, H, w1t,
             C, C, m0, n0);
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + tile_index(ty, i);
    if (row >= T_len) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tile_index(tx, j);
      if (col >= C) continue;
      const size_t idx = (static_cast<size_t>(b) * T_len + row) * C + col;
      dx[idx] = from_f32<T>(to_f32(dy[idx]) + acc[i][j]);
    }
  }
}

// part[split] = a[rows of the split]^T @ b[rows of the split] for row-major
// a [R, M] and b [R, N]: one block per (128 x 128 tile, split of the rows).
template <typename T>
__global__ void __launch_bounds__(kGemmThreads, 2)
    tcn_wgrad_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     float* __restrict__ part, long long R, int M, int N,
                     int rows_per_split) {
  __shared__ __align__(16) float as[kBK][kBM];
  __shared__ __align__(16) float bs[kBK][kBN];
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const long long r_begin =
      static_cast<long long>(blockIdx.z) * rows_per_split;
  const long long r_end =
      r_begin + rows_per_split < R ? r_begin + rows_per_split : R;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  for (long long r0 = r_begin; r0 < r_end; r0 += kBK) {
    const int left = static_cast<int>(r_end - r0);
    stage_b_rows<T>(as, a + static_cast<size_t>(r0) * M, M, left, M, 0, m0);
    stage_b_rows<T>(bs, b + static_cast<size_t>(r0) * N, N, left, N, 0, n0);
    __syncthreads();
    mma_tile<kBM>(acc, as, bs, ty, tx);
    __syncthreads();
  }
  float* out = part + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + tile_index(ty, i);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tile_index(tx, j);
      if (col >= N) continue;
      out[static_cast<size_t>(row) * N + col] = acc[i][j];
    }
  }
}

// part[(b * chunks + chunk) * C + c] = sum over the chunk's rows of dy.
template <typename T>
__global__ void __launch_bounds__(kEwThreads)
    tcn_colsum_kernel(const T* __restrict__ dy, float* __restrict__ part,
                      int T_len, int C) {
  const int b = blockIdx.z;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int nc = ew_chunks(T_len);
  for (int cy = blockIdx.y; cy < nc; cy += gridDim.y) {
    const int t0 = cy * kChunkRows;
    const int t1 = min(t0 + kChunkRows, T_len);
    const size_t base = static_cast<size_t>(b) * T_len * C + c;
    float acc = 0.0f;
    for (int t = t0; t < t1; ++t) {
      acc += to_f32(dy[base + static_cast<size_t>(t) * C]);
    }
    part[(static_cast<size_t>(b) * nc + cy) * C + c] = acc;
  }
}

// What one thread (channel h of sample b) needs to recompute v in f32.
struct Taps {
  float a0, c0, bd;
  float kd[kMaxTaps];
};

template <typename T>
__device__ __forceinline__ Taps load_taps(const float* __restrict__ stats,
                                          const float* __restrict__ g0w,
                                          const float* __restrict__ g0b,
                                          const T* __restrict__ kd,
                                          const float* __restrict__ bd, int b,
                                          int h, int H, int k) {
  Taps tp;
  const float mu0 = stats[b * 4];
  const float rs0 = stats[b * 4 + 1];
  tp.a0 = g0w[h] * rs0;
  tp.c0 = g0b[h] - mu0 * tp.a0;
  tp.bd = bd[h];
#pragma unroll
  for (int kk = 0; kk < kMaxTaps; ++kk) {
    tp.kd[kk] = kk < k ? to_f32(kd[static_cast<size_t>(kk) * H + h]) : 0.0f;
  }
  return tp;
}

// v[t] in f32 from the taps of u (ub = u + b * T * H + h); the masked taps
// of n0 are left in `taps`.
template <typename T>
__device__ __forceinline__ float recompute_v(const T* __restrict__ ub,
                                             const Taps& tp, int t, int T_len,
                                             int H, int k, int dilation,
                                             int pad_lo,
                                             float (&taps)[kMaxTaps]) {
  float v = tp.bd;
#pragma unroll
  for (int kk = 0; kk < kMaxTaps; ++kk) {
    taps[kk] = 0.0f;
    if (kk < k) {
      const int tt = t + kk * dilation - pad_lo;
      if (tt >= 0 && tt < T_len) {
        taps[kk] = tp.a0 * to_f32(ub[static_cast<size_t>(tt) * H]) + tp.c0;
      }
      v = v + tp.kd[kk] * taps[kk];
    }
  }
  return v;
}

// Where a block of an elementwise kernel puts the per-channel partials of
// chunk cy of nc (`nvec` vectors of H) and its two scalar partials.
__device__ __forceinline__ size_t vec_at(int b, int cy, int nc, int nvec,
                                         int vec, int H, int h) {
  return ((static_cast<size_t>(b) * nc + cy) * nvec + vec) * H + h;
}
__device__ __forceinline__ void write_scalars(float* __restrict__ spart,
                                              int b, int cy, int nc, float s0,
                                              float s1) {
  block_sum2(s0, s1);
  if (threadIdx.x == 0) {
    const size_t blocks = static_cast<size_t>(gridDim.x) * nc;
    const size_t at =
        (b * blocks + static_cast<size_t>(cy) * gridDim.x + blockIdx.x) * 2;
    spart[at] = s0;
    spart[at + 1] = s1;
  }
  __syncthreads();  // block_sum2's scratch is read before the next chunk
}

// round(n1) for the dW2 product; partials of dg1, dbe1 (vpart, 2 vectors)
// and of sum(g1w * dn1), sum(g1w * dn1 * s1hat) per sample (spart).
template <typename T>
__global__ void __launch_bounds__(kEwThreads)
    tcn_gln1_kernel(const T* __restrict__ u, const float* __restrict__ dn1,
                    const float* __restrict__ stats,
                    const float* __restrict__ g0w,
                    const float* __restrict__ g0b, const T* __restrict__ kd,
                    const float* __restrict__ bd,
                    const float* __restrict__ g1w,
                    const float* __restrict__ g1b,
                    const float* __restrict__ p1_ptr, T* __restrict__ n1c,
                    float* __restrict__ vpart, float* __restrict__ spart,
                    int T_len, int H, int k, int dilation, int pad_lo) {
  const int b = blockIdx.z;
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  const int nc = ew_chunks(T_len);
  for (int cy = blockIdx.y; cy < nc; cy += gridDim.y) {
  const int t0 = cy * kChunkRows;
  const int t1 = min(t0 + kChunkRows, T_len);
  float acc0 = 0.0f;
  float acc1 = 0.0f;
  if (h < H) {
    const Taps tp = load_taps<T>(stats, g0w, g0b, kd, bd, b, h, H, k);
    const float mu1 = stats[b * 4 + 2];
    const float rs1 = stats[b * 4 + 3];
    const float p1 = *p1_ptr;
    const float gw = g1w[h];
    const float gb = g1b[h];
    const size_t base = static_cast<size_t>(b) * T_len * H + h;
    float dg1 = 0.0f;
    float dbe1 = 0.0f;
    float taps[kMaxTaps];
    for (int t = t0; t < t1; ++t) {
      const float v =
          recompute_v<T>(u + base, tp, t, T_len, H, k, dilation, pad_lo, taps);
      const float w = rnd<T>(v >= 0.0f ? v : p1 * v);
      const float s1hat = (w - mu1) * rs1;
      const size_t idx = base + static_cast<size_t>(t) * H;
      n1c[idx] = from_f32<T>(gw * s1hat + gb);
      const float d = dn1[idx];
      dg1 += d * s1hat;
      dbe1 += d;
      acc0 += gw * d;
      acc1 += gw * d * s1hat;
    }
    vpart[vec_at(b, cy, nc, 2, 0, H, h)] = dg1;
    vpart[vec_at(b, cy, nc, 2, 1, H, h)] = dbe1;
  }
  write_scalars(spart, b, cy, nc, acc0, acc1);
  }
}

// round(dv) for the gather; partials of dbd and dkd (vpart, 1 + k vectors)
// and of dp1 (spart, first of two). acc01[b] = the two sums of
// tcn_gln1_kernel.
template <typename T>
__global__ void __launch_bounds__(kEwThreads)
    tcn_dv_kernel(const T* __restrict__ u, const float* __restrict__ dn1,
                  const float* __restrict__ stats,
                  const float* __restrict__ acc01,
                  const float* __restrict__ g0w,
                  const float* __restrict__ g0b, const T* __restrict__ kd,
                  const float* __restrict__ bd, const float* __restrict__ g1w,
                  const float* __restrict__ p1_ptr, T* __restrict__ dvc,
                  float* __restrict__ vpart, float* __restrict__ spart,
                  int T_len, int H, int k, int dilation, int pad_lo,
                  float nhw) {
  const int b = blockIdx.z;
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  const int nc = ew_chunks(T_len);
  for (int cy = blockIdx.y; cy < nc; cy += gridDim.y) {
  const int t0 = cy * kChunkRows;
  const int t1 = min(t0 + kChunkRows, T_len);
  float dp1 = 0.0f;
  if (h < H) {
    const Taps tp = load_taps<T>(stats, g0w, g0b, kd, bd, b, h, H, k);
    const float mu1 = stats[b * 4 + 2];
    const float rs1 = stats[b * 4 + 3];
    const float m0 = acc01[b * 2] / nhw;
    const float m1 = acc01[b * 2 + 1] / nhw;
    const float p1 = *p1_ptr;
    const float gw = g1w[h];
    const size_t base = static_cast<size_t>(b) * T_len * H + h;
    float dbd = 0.0f;
    float dkd[kMaxTaps];
    float taps[kMaxTaps];
#pragma unroll
    for (int kk = 0; kk < kMaxTaps; ++kk) dkd[kk] = 0.0f;
    for (int t = t0; t < t1; ++t) {
      const float v =
          recompute_v<T>(u + base, tp, t, T_len, H, k, dilation, pad_lo, taps);
      const float w = rnd<T>(v >= 0.0f ? v : p1 * v);
      const float s1hat = (w - mu1) * rs1;
      const size_t idx = base + static_cast<size_t>(t) * H;
      const float dw = rs1 * (gw * dn1[idx] - m0 - s1hat * m1);
      dp1 += dw * fminf(v, 0.0f);
      const float dv = dw * (v >= 0.0f ? 1.0f : p1);
      dbd += dv;
#pragma unroll
      for (int kk = 0; kk < kMaxTaps; ++kk) dkd[kk] += dv * taps[kk];
      dvc[idx] = from_f32<T>(dv);
    }
    vpart[vec_at(b, cy, nc, 1 + k, 0, H, h)] = dbd;
#pragma unroll
    for (int kk = 0; kk < kMaxTaps; ++kk) {
      if (kk < k) vpart[vec_at(b, cy, nc, 1 + k, 1 + kk, H, h)] = dkd[kk];
    }
  }
  write_scalars(spart, b, cy, nc, dp1, 0.0f);
  }
}

// dn0 by a gather of round(dv) at the mirrored shifts, accumulated in the
// stream's dtype; partials of dg0, dbe0 (vpart, 2 vectors) and of
// sum(g0w * dn0), sum(g0w * dn0 * s0hat) per sample (spart).
template <typename T>
__global__ void __launch_bounds__(kEwThreads)
    tcn_dn0_kernel(const T* __restrict__ u, const T* __restrict__ dvc,
                   const float* __restrict__ stats,
                   const float* __restrict__ g0w, const T* __restrict__ kd,
                   T* __restrict__ dn0_out, float* __restrict__ vpart,
                   float* __restrict__ spart, int T_len, int H, int k,
                   int dilation, int pad_lo) {
  const int b = blockIdx.z;
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  const int nc = ew_chunks(T_len);
  for (int cy = blockIdx.y; cy < nc; cy += gridDim.y) {
  const int t0 = cy * kChunkRows;
  const int t1 = min(t0 + kChunkRows, T_len);
  float acc2 = 0.0f;
  float acc3 = 0.0f;
  if (h < H) {
    const float mu0 = stats[b * 4];
    const float rs0 = stats[b * 4 + 1];
    const float gw = g0w[h];
    float kdc[kMaxTaps];
#pragma unroll
    for (int kk = 0; kk < kMaxTaps; ++kk) {
      kdc[kk] = kk < k ? to_f32(kd[static_cast<size_t>(kk) * H + h]) : 0.0f;
    }
    const size_t base = static_cast<size_t>(b) * T_len * H + h;
    float dg0 = 0.0f;
    float dbe0 = 0.0f;
    for (int t = t0; t < t1; ++t) {
      float dn0 = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kMaxTaps; ++kk) {
        if (kk < k) {
          // adjoint of v[t'] += kd[kk] * n0[t' + kk * dilation - pad_lo]
          const int src = t - kk * dilation + pad_lo;
          if (src >= 0 && src < T_len) {
            const float d = to_f32(dvc[base + static_cast<size_t>(src) * H]);
            dn0 = rnd<T>(dn0 + rnd<T>(kdc[kk] * d));
          }
        }
      }
      const size_t idx = base + static_cast<size_t>(t) * H;
      dn0_out[idx] = from_f32<T>(dn0);
      const float s0hat = (to_f32(u[idx]) - mu0) * rs0;
      dg0 += dn0 * s0hat;
      dbe0 += dn0;
      acc2 += gw * dn0;
      acc3 += gw * dn0 * s0hat;
    }
    vpart[vec_at(b, cy, nc, 2, 0, H, h)] = dg0;
    vpart[vec_at(b, cy, nc, 2, 1, H, h)] = dbe0;
  }
  write_scalars(spart, b, cy, nc, acc2, acc3);
  }
}

// round(ds) for the last two products; partials of db1_eff (vpart, one
// vector) and of dp0 (spart, first of two). acc23[b] = the two sums of
// tcn_dn0_kernel.
template <typename T>
__global__ void __launch_bounds__(kEwThreads)
    tcn_ds_kernel(const T* __restrict__ u, const float* __restrict__ s,
                  const T* __restrict__ dn0, const float* __restrict__ stats,
                  const float* __restrict__ acc23,
                  const float* __restrict__ g0w,
                  const float* __restrict__ p0_ptr, T* __restrict__ dsc,
                  float* __restrict__ vpart, float* __restrict__ spart,
                  int T_len, int H, float nhw) {
  const int b = blockIdx.z;
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  const int nc = ew_chunks(T_len);
  for (int cy = blockIdx.y; cy < nc; cy += gridDim.y) {
  const int t0 = cy * kChunkRows;
  const int t1 = min(t0 + kChunkRows, T_len);
  float dp0 = 0.0f;
  if (h < H) {
    const float mu0 = stats[b * 4];
    const float rs0 = stats[b * 4 + 1];
    const float m2 = acc23[b * 2] / nhw;
    const float m3 = acc23[b * 2 + 1] / nhw;
    const float p0 = *p0_ptr;
    const float gw = g0w[h];
    const size_t base = static_cast<size_t>(b) * T_len * H + h;
    float db1 = 0.0f;
    for (int t = t0; t < t1; ++t) {
      const size_t idx = base + static_cast<size_t>(t) * H;
      const float s0hat = (to_f32(u[idx]) - mu0) * rs0;
      const float du = rs0 * (gw * to_f32(dn0[idx]) - m2 - s0hat * m3);
      const float sv = s[idx];
      dp0 += du * fminf(sv, 0.0f);
      const float ds = du * (sv >= 0.0f ? 1.0f : p0);
      db1 += ds;
      dsc[idx] = from_f32<T>(ds);
    }
    vpart[vec_at(b, cy, nc, 1, 0, H, h)] = db1;
  }
  write_scalars(spart, b, cy, nc, dp0, 0.0f);
  }
}

constexpr int kSplitRows = 1024;  // rows of (batch, time) per wgrad block
constexpr int kMaxSplits = 256;

int wgrad_splits(long long rows) {
  const long long s = (rows + kSplitRows - 1) / kSplitRows;
  return static_cast<int>(s < 1 ? 1 : (s > kMaxSplits ? kMaxSplits : s));
}

// out [M, N] = a^T @ b over all R rows, through `part` [splits, M, N].
template <typename T>
cudaError_t wgrad(const T* a, const T* b, float* part, float* out,
                  long long R, int M, int N, cudaStream_t stream) {
  const int splits = wgrad_splits(R);
  long long per = (R + splits - 1) / splits;
  per = (per + kBK - 1) / kBK * kBK;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, splits);
  tcn_wgrad_kernel<T><<<grid, kGemmThreads, 0, stream>>>(
      a, b, part, R, M, N, static_cast<int>(per));
  TCN_CHECK(cudaGetLastError());
  return sum_partials(part, out, 1, splits, M * N, M * N, stream);
}

// Floats of the backward's f32 scratch, region by region.
struct Layout {
  size_t s, dn1, vpart, spart, wpart, acc01, acc23, total;
};

Layout layout(int B, int T_len, int C, int H, int k) {
  const dim3 ew = ew_grid(B, T_len, H);
  const size_t n = static_cast<size_t>(B) * T_len * H;
  const size_t chunks = static_cast<size_t>(B) * ew_chunks(T_len);
  const size_t vec_h = chunks * (1 + k) * H;
  const size_t vec_c = chunks * C;
  Layout l;
  l.s = 0;
  l.dn1 = l.s + n;
  l.vpart = l.dn1 + n;
  l.spart = l.vpart + (vec_h > vec_c ? vec_h : vec_c);
  l.wpart = l.spart + chunks * ew.x * 2;
  l.acc01 = l.wpart + static_cast<size_t>(wgrad_splits(
                          static_cast<long long>(B) * T_len)) * H * C;
  l.acc23 = l.acc01 + 2 * static_cast<size_t>(B);
  l.total = l.acc23 + 2 * static_cast<size_t>(B);
  return l;
}

struct Args {
  const void *x, *dy, *stats, *b1_eff, *w1, *w1t, *p0, *kd, *bd, *g0w, *g0b,
      *p1, *w2t, *g1w, *g1b;
  void *dx, *db1e, *dw1, *dw2, *dvec_dv, *dvec_g0, *dvec_g1, *db2, *dscal,
      *stream_ws, *f32_ws;
};

template <typename T>
cudaError_t backward(const Args& a, int B, int T_len, int C, int H, int k,
                     int dilation, int pad_lo, cudaStream_t stream) {
  const size_t n = static_cast<size_t>(B) * T_len * H;
  T* u = static_cast<T*>(a.stream_ws);
  T* n1c = u + n;
  T* dvc = n1c + n;
  T* dn0 = dvc + n;
  T* dsc = dn0 + n;
  const Layout l = layout(B, T_len, C, H, k);
  float* ws = static_cast<float*>(a.f32_ws);
  float* s = ws + l.s;
  float* dn1 = ws + l.dn1;
  float* vpart = ws + l.vpart;
  float* spart = ws + l.spart;
  float* wpart = ws + l.wpart;
  float* acc01 = ws + l.acc01;
  float* acc23 = ws + l.acc23;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const T* kd = static_cast<const T*>(a.kd);
  const float* stats = static_cast<const float*>(a.stats);
  const float* g0w = static_cast<const float*>(a.g0w);
  const float* g0b = static_cast<const float*>(a.g0b);
  const float* g1w = static_cast<const float*>(a.g1w);
  const float* g1b = static_cast<const float*>(a.g1b);
  const float* bd = static_cast<const float*>(a.bd);
  const float* p0 = static_cast<const float*>(a.p0);
  const float* p1 = static_cast<const float*>(a.p1);
  float* dscal = static_cast<float*>(a.dscal);
  const dim3 ew = ew_grid(B, T_len, H);
  const int threads = ew_threads(H);
  const int chunks = ew_chunks(T_len);  // partials per sample
  const int sblocks = static_cast<int>(ew.x) * chunks;
  const float nhw = static_cast<float>(T_len) * static_cast<float>(H);
  const long long rows = static_cast<long long>(B) * T_len;
  const dim3 grid_h((T_len + kBM - 1) / kBM, (H + kBN - 1) / kBN, B);
  const dim3 grid_c((T_len + kBM - 1) / kBM, (C + kBN - 1) / kBN, B);

  TCN_CHECK(launch_u<T>(x, static_cast<const T*>(a.w1),
                        static_cast<const float*>(a.b1_eff), p0, u, s,
                        nullptr, B, T_len, C, H, stream));
  tcn_dn1_kernel<T><<<grid_h, kGemmThreads, 0, stream>>>(
      dy, static_cast<const T*>(a.w2t), dn1, T_len, C, H);
  TCN_CHECK(cudaGetLastError());

  const int cthreads = ew_threads(C);
  tcn_colsum_kernel<T>
      <<<dim3((C + cthreads - 1) / cthreads, ew.y, B), cthreads, 0,
         stream>>>(dy, vpart, T_len, C);
  TCN_CHECK(cudaGetLastError());
  TCN_CHECK(sum_partials(vpart, static_cast<float*>(a.db2), 1, B * chunks, C,
                         C, stream));

  tcn_gln1_kernel<T><<<ew, threads, 0, stream>>>(
      u, dn1, stats, g0w, g0b, kd, bd, g1w, g1b, p1, n1c, vpart, spart, T_len,
      H, k, dilation, pad_lo);
  TCN_CHECK(cudaGetLastError());
  TCN_CHECK(sum_partials(vpart, static_cast<float*>(a.dvec_g1), 1, B * chunks,
                         2 * H, 2 * H, stream));
  TCN_CHECK(sum_partials(spart, acc01, B, sblocks, 2, 2, stream));

  tcn_dv_kernel<T><<<ew, threads, 0, stream>>>(
      u, dn1, stats, acc01, g0w, g0b, kd, bd, g1w, p1, dvc, vpart, spart,
      T_len, H, k, dilation, pad_lo, nhw);
  TCN_CHECK(cudaGetLastError());
  TCN_CHECK(sum_partials(vpart, static_cast<float*>(a.dvec_dv), 1, B * chunks,
                         (1 + k) * H, (1 + k) * H, stream));
  TCN_CHECK(sum_partials(spart, dscal + 1, 1, B * sblocks, 2, 1, stream));

  TCN_CHECK(wgrad<T>(n1c, dy, wpart, static_cast<float*>(a.dw2), rows, H, C,
                     stream));

  tcn_dn0_kernel<T><<<ew, threads, 0, stream>>>(
      u, dvc, stats, g0w, kd, dn0, vpart, spart, T_len, H, k, dilation,
      pad_lo);
  TCN_CHECK(cudaGetLastError());
  TCN_CHECK(sum_partials(vpart, static_cast<float*>(a.dvec_g0), 1, B * chunks,
                         2 * H, 2 * H, stream));
  TCN_CHECK(sum_partials(spart, acc23, B, sblocks, 2, 2, stream));

  tcn_ds_kernel<T><<<ew, threads, 0, stream>>>(
      u, s, dn0, stats, acc23, g0w, p0, dsc, vpart, spart, T_len, H, nhw);
  TCN_CHECK(cudaGetLastError());
  TCN_CHECK(sum_partials(vpart, static_cast<float*>(a.db1e), B, chunks, H, H,
                         stream));
  TCN_CHECK(sum_partials(spart, dscal, 1, B * sblocks, 2, 1, stream));

  tcn_dx_kernel<T><<<grid_c, kGemmThreads, 0, stream>>>(
      dsc, static_cast<const T*>(a.w1t), dy, static_cast<T*>(a.dx), T_len, H,
      C);
  TCN_CHECK(cudaGetLastError());
  return wgrad<T>(x, dsc, wpart, static_cast<float*>(a.dw1), rows, C, H,
                  stream);
}

}  // namespace

// Plain C entry points, bound with ctypes by
// wesep_tpu_torch/ops/cuda_tcn.py. dtype: 0 = f32, 1 = bf16.

// Elements of the two scratch buffers the backward needs: n_stream of the
// stream's dtype and n_f32 floats.
extern "C" void tcn_block_backward_scratch(int B, int T_len, int C, int H,
                                           int k, long long* n_stream,
                                           long long* n_f32) {
  *n_stream = 5LL * B * T_len * H;
  *n_f32 = static_cast<long long>(layout(B, T_len, C, H, k).total);
}

// x, dy [B, T, C], w1 [C, H], w1t = w1^T [H, C], kd [k, H], w2t = w2^T
// [C, H] in the stream's dtype; stats [B, 4], b1_eff [B, H], bd, g0w, g0b,
// g1w, g1b [H], p0, p1 [1] f32. Writes dx [B, T, C] in the stream's dtype
// and, in f32, db1e [B, H], dw1 [C, H], dw2 [H, C], dvec_dv [1 + k, H] =
// (dbd, dkd), dvec_g0 [2, H] = (dg0, dbe0), dvec_g1 [2, H] = (dg1, dbe1),
// db2 [C], dscal [2] = (dp0, dp1). All contiguous and 16-byte aligned;
// C % 8 == 0, H % 8 == 0, k <= 8. Returns the CUDA error code of the first
// launch that failed (0 on success) and never synchronises.
extern "C" int tcn_block_backward(
    const void* x, const void* dy, const void* stats, const void* b1_eff,
    const void* w1, const void* w1t, const void* p0, const void* kd,
    const void* bd, const void* g0w, const void* g0b, const void* p1,
    const void* w2t, const void* g1w, const void* g1b, void* dx, void* db1e,
    void* dw1, void* dw2, void* dvec_dv, void* dvec_g0, void* dvec_g1,
    void* db2, void* dscal, void* stream_ws, void* f32_ws, int B, int T_len,
    int C, int H, int k, int dilation, int pad_lo, int dtype, void* stream) {
  if (tcn::bad_shape(B, T_len, C, H, k, dilation, pad_lo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = {x,   dy,  stats, b1_eff, w1,  w1t,     p0,      kd,      bd,
                  g0w, g0b, p1,    w2t,    g1w, g1b,     dx,      db1e,    dw1,
                  dw2, dvec_dv, dvec_g0, dvec_g1, db2, dscal, stream_ws,
                  f32_ws};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = backward<float>(a, B, T_len, C, H, k, dilation, pad_lo, s);
  } else if (dtype == 1) {
    err = backward<__nv_bfloat16>(a, B, T_len, C, H, k, dilation, pad_lo, s);
  }
  return static_cast<int>(err);
}
