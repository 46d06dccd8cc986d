// The backward kernels of the LSTM layers: the serial adjoint and the
// weight-gradient product, shared by the plain layer (bilstm_layer_bwd.cu,
// whose header describes their design), the unfold-fused layer
// (bilstm_unfold_bwd.cu) and the two-kernel layers (lstm_fused_bwd.cu).
// Both read a step's input from x only through a source
// (bilstm_common.cuh): `RowSource` for the plain layer, `UnfoldSource` for
// the unfold-fused one, `XwSource` (the gate pre-activation itself, no
// input row: no dx and no dWx) for the two-kernel ones.

#pragma once

#include "bilstm_common.cuh"

namespace bilstm {

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

// The serial adjoint. D = src.width() is the input row's length; dx2
// [kDirs, B, T, D] receives each direction's cotangent of the input rows
// (nothing when the source does not project). y, cs and dy rows hold
// kDirs * H values; `walks_back` says which direction walked time
// backwards, as in the forward kernel.
template <typename T, int BT, typename XS, int kDirs, bool kReverse>
__global__ void __launch_bounds__(kMaxThreads, 2)
    bilstm_bwd_kernel(const T* __restrict__ x, XS src,
                      const T* __restrict__ wx_f,
                      const float* __restrict__ b_f,
                      const T* __restrict__ wh_f, const T* __restrict__ wx_b,
                      const float* __restrict__ b_b,
                      const T* __restrict__ wh_b,
                      const T* __restrict__ wxt_f,
                      const T* __restrict__ wht_f,
                      const T* __restrict__ wxt_b,
                      const T* __restrict__ wht_b, const T* __restrict__ y,
                      const float* __restrict__ cs,
                      const T* __restrict__ dy, T* __restrict__ dx2,
                      T* __restrict__ dg, float* __restrict__ db_part, int B,
                      int T_len, int H) {
  extern __shared__ float4 smem4[];
  const int D = src.width();
  const int h4 = 4 * H;
  float* xs = reinterpret_cast<float*>(smem4);  // [BT][D]   x_t
  float* hs = xs + BT * D;                      // [BT][H]   h_{t-1}
  float* dgs = hs + BT * H;                     // [BT][4H]  rounded dgates
  float* dxp = dgs + BT * h4;                   // [2][BT][D] halves of dx_t

  const int dir = blockIdx.y;
  const int width = kDirs * H;  // of a row of y, cs and dy
  const bool backwards = walks_back<kDirs, kReverse>(dir);
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
    bj[g] = (XS::kProjects && active) ? bias[g * H + j] : 0.0f;
    db[g] = 0.0f;
  }
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    dh[r] = 0.0f;
    dc[r] = 0.0f;
  }

  for (int s = 0; s < T_len; ++s) {
    // the adjoint walks the forward's steps backwards: a direction that
    // ran forwards from T-1 down, one that ran backwards from 0 up
    const int t = backwards ? s : T_len - 1 - s;
    const int tp = backwards ? t + 1 : t - 1;  // the forward's previous step
    const bool has_prev = tp >= 0 && tp < T_len;
    float acc[BT][4];
    if constexpr (XS::kProjects) {
      stage_x<BT>(xs, x, src, b0, B, t);
    } else {
      // the gates start from xw, whose loads need not wait for the barrier
#pragma unroll
      for (int r = 0; r < BT; ++r) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[r][g] = (active && b0 + r < B)
                          ? src.gate(x, dir, b0 + r, t, g * H + j)
                          : 0.0f;
        }
      }
    }
    stage_rows<T, BT>(hs, y, H, width, dir * H, b0, B, T_len,
                      has_prev ? tp : t, has_prev);
    __syncthreads();  // (1) x_t and h_{t-1} staged

    if (active) {
      if constexpr (XS::kProjects) {
#pragma unroll
        for (int r = 0; r < BT; ++r) {
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[r][g] = bj[g];
        }
        accumulate<T, BT>(acc, xs, wx, D, H, j);
      }
      accumulate<T, BT>(acc, hs, wh, H, H, j);
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const int b = b0 + r;
        const bool valid = b < B;
        const size_t row = static_cast<size_t>(valid ? b : 0) * T_len;
        const size_t at = (row + t) * width + dir * H + j;
        const float c_t = valid ? cs[at] : 0.0f;
        const float c_prev =
            (valid && has_prev) ? cs[(row + tp) * width + dir * H + j]
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
    if constexpr (XS::kProjects) {
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
  }

  if (active) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      db_part[(static_cast<size_t>(blockIdx.x) * kDirs + dir) * h4 + g * H +
              j] = db[g];
    }
  }
}

constexpr int kWgM = 64;    // rows of dW (of [x ; h]) per block
constexpr int kWgN = 128;   // columns of dW (of dg) per block
constexpr int kWgK = 16;    // (batch, time) rows staged per iteration
constexpr int kWgThreads = 256;

// The weight gradients: dW[dir] = A^T @ dg[dir] over the N = B * T rows,
// A[n] = [input row n ; h_{t-1}] (h_{t-1} alone when the source gives no
// input row), one slice of the N axis per block.z / kDirs; y rows hold
// kDirs * H values and `walks_back` says where h_{t-1} lies, as in the
// serial kernels.
template <typename T, typename XS, int kDirs, bool kReverse>
__global__ void __launch_bounds__(kWgThreads)
    bilstm_wgrad_kernel(const T* __restrict__ x, XS src,
                        const T* __restrict__ y,
                        const T* __restrict__ dg, float* __restrict__ dw_part,
                        int B, int T_len, int H, int rows_per_split) {
  __shared__ __align__(16) float a_s[kWgK][kWgM];
  __shared__ __align__(16) float b_s[kWgK][kWgN];

  const int D = src.width();
  const int M = D + H;
  const int h4 = 4 * H;
  const long long rows = static_cast<long long>(B) * T_len;
  const int m0 = blockIdx.x * kWgM;
  const int c0 = blockIdx.y * kWgN;
  const int dir = blockIdx.z % kDirs;
  const int split = blockIdx.z / kDirs;
  const long long n_begin = static_cast<long long>(split) * rows_per_split;
  const long long n_end =
      n_begin + rows_per_split < rows ? n_begin + rows_per_split : rows;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows m0 + 4 ty .. + 3
  const int tx = tid % 16;  // columns c0 + 4 tx .. + 3 and c0 + 64 + 4 tx ..
  const T* __restrict__ dg_dir = dg + static_cast<size_t>(dir) * rows * h4;
  // where h_{t-1} lies, in rows of y
  const int step = walks_back<kDirs, kReverse>(dir) ? 1 : -1;

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
          v = src.load_row(x, n, m);
        } else {
          const int tp = static_cast<int>(n % T_len) + step;
          if (tp >= 0 && tp < T_len) {
            v = to_f32(y[(n + step) * (kDirs * H) + dir * H + (m - D)]);
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

  float* out = dw_part + (static_cast<size_t>(split) * kDirs + dir) * M * h4;
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

// p: x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, wxt_f, wht_f, wxt_b, wht_b, y,
// cs, dy, dx2, dg, db_part (the serial adjoint's operands; those of x's
// half, and of the _b direction when kDirs is 1, may be null where unread).
template <typename T, typename XS, int kDirs = 2, bool kReverse = false>
cudaError_t launch_backward(const XS& src, const void* const* p, int B,
                            int T_len, int H, cudaStream_t stream) {
  auto kernel = bilstm_bwd_kernel<T, kTile, XS, kDirs, kReverse>;
  const size_t smem =
      static_cast<size_t>(kTile) * (3 * src.width() + 5 * H) * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((B + kTile - 1) / kTile, kDirs);
  const int threads = (H + 31) / 32 * 32;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(p[0]), src, static_cast<const T*>(p[1]),
      static_cast<const float*>(p[2]), static_cast<const T*>(p[3]),
      static_cast<const T*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<const T*>(p[6]), static_cast<const T*>(p[7]),
      static_cast<const T*>(p[8]), static_cast<const T*>(p[9]),
      static_cast<const T*>(p[10]), static_cast<const T*>(p[11]),
      static_cast<const float*>(p[12]), static_cast<const T*>(p[13]),
      static_cast<T*>(const_cast<void*>(p[14])),
      static_cast<T*>(const_cast<void*>(p[15])),
      static_cast<float*>(const_cast<void*>(p[16])), B, T_len, H);
  return cudaGetLastError();
}

template <typename T, typename XS, int kDirs = 2, bool kReverse = false>
cudaError_t launch_wgrad(const void* x, const XS& src, const void* y,
                         const void* dg, void* dw_part, int B, int T_len,
                         int H, int splits, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * T_len;
  const int rows_per_split = static_cast<int>((rows + splits - 1) / splits);
  const dim3 grid((src.width() + H + kWgM - 1) / kWgM,
                  (4 * H + kWgN - 1) / kWgN, kDirs * splits);
  bilstm_wgrad_kernel<T, XS, kDirs, kReverse>
      <<<grid, kWgThreads, 0, stream>>>(
          static_cast<const T*>(x), src, static_cast<const T*>(y),
          static_cast<const T*>(dg), static_cast<float*>(dw_part), B, T_len,
          H, rows_per_split);
  return cudaGetLastError();
}

}  // namespace bilstm
