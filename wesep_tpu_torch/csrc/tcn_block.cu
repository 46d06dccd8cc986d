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
//   1. u product         x @ W1 (tcn_common.cuh), its epilogue
//                        u = PReLU(. + b1_eff) and per-block sums of u, u^2
//   2. tcn_stats_kernel  the partial sums in order -> mu0, rs0
//   3. tcn_dconv_kernel  taps of n0 -> v -> w; writes g1w * w and the
//                        per-block sums of w, w^2
//   4. tcn_stats_kernel  -> mu1, rs1
//   5. tcn_corr_kernel   c1 @ W2 + b2 per sample
//   6. out product       (g1w * w) @ W2, its epilogue
//                        y = x + rs1 * round(q) + corr
//
// The products run bf16 operands on the tensor cores (mma.sync.m16n8k16)
// and f32 operands on the FMA units (tcn_common.cuh says why), f32 sums in
// both; f32 takes tiles of 64 rows where tiles of 128 would leave the card
// short of blocks (2 x 3 s of SpEx+ serving: 152 tiles of 128 for the out
// product). The dconv pass walks 128 rows x 128 channels a block, a thread two
// neighbouring channels over 32 rows with the taps as its outer loop, each
// tap's 128 rows copied into shared memory by cp.async while the previous
// tap is summed.
// Every sum over blocks is added in a fixed order, so a run repeats bit for
// bit.
//
// What bounds it on this card. 4 * B * T * C * H + 2 * B * T * H * k
// operations against x read and y written once: at B = 16, T = 4799,
// C = 256, H = 512 that is 4.0e10 operations, 0.04 ms at 989 TFLOP/s in
// bf16 (0.6 ms at 67 TFLOP/s if f32 is counted at the FMA rate), against
// 0.02 to 0.05 ms for the bytes: operations bound it. The design's own
// floor is higher: u and g1w * w are written and read once each (0.32 GB
// at B = 16 in bf16, ~0.1 ms), mma.sync reaches a part of the rate only
// wgmma reaches in full, and f32 runs at the FMA rate.

#include "tcn_common.cuh"

namespace {

using namespace tcn;

// stats[b * 4 + slot] = mean, stats[b * 4 + slot + 1] = 1 / sqrt(var + eps)
// from the per-block sums part[b][P][2] (f64); one block per sample.
__global__ void tcn_stats_kernel(const double* __restrict__ part,
                                 float* __restrict__ stats, int P, double nhw,
                                 float eps, int slot) {
  const int b = blockIdx.x;
  const double* p = part + static_cast<size_t>(b) * P * 2;
  double s0 = 0.0;
  double s1 = 0.0;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    s0 += p[2 * i];
    s1 += p[2 * i + 1];
  }
  block_sum2(s0, s1);
  if (threadIdx.x == 0) {
    const double mu = s0 / nhw;
    const double var = fmax(s1 / nhw - mu * mu, 0.0);
    stats[b * 4 + slot] = static_cast<float>(mu);
    stats[b * 4 + slot + 1] =
        static_cast<float>(1.0 / sqrt(var + static_cast<double>(eps)));
  }
}

// v and w from the taps of u in the stream's dtype, op by op; writes
// gw = g1w * w and the block's sums of w and w^2 (f64). A block walks 128 rows
// and 128 channels of one sample (Walk), as a product's tile: grid
// (chunks of 128 rows, tiles of 128 channels, B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    tcn_dconv_kernel(const T* __restrict__ u, const float* __restrict__ stats,
                     const float* __restrict__ g0w,
                     const float* __restrict__ g0b, const T* __restrict__ kd,
                     const float* __restrict__ bd,
                     const float* __restrict__ g1w,
                     const float* __restrict__ p1_ptr, T* __restrict__ gw,
                     double* __restrict__ part, int T_len, int H, int k,
                     int dilation, int pad_lo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* taps = reinterpret_cast<T*>(smem_raw);  // two [kTile][kTile] buffers
  const int z = blockIdx.z;
  const int m0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  const Walk wk(T_len - m0);
  const int h = n0 + wk.c;
  const bool live = h < H;
  const int t0 = m0 + wk.r0, rows = wk.r1 - wk.r0;
  const float mu0 = stats[z * 4];
  const float rs0 = stats[z * 4 + 1];
  float2 a0c = make_float2(0.0f, 0.0f), c0c = a0c;
  float2 v[kRows];
  if (live) {
    const float a0x = g0w[h] * rs0, a0y = g0w[h + 1] * rs0;
    a0c = make_float2(rnd<T>(a0x), rnd<T>(a0y));
    c0c = make_float2(rnd<T>(g0b[h] - mu0 * a0x),
                      rnd<T>(g0b[h + 1] - mu0 * a0y));
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    v[i] = live ? make_float2(rnd<T>(bd[h]), rnd<T>(bd[h + 1]))
                : make_float2(0.0f, 0.0f);
  }
  stage_tap(taps, u, z, m0 - pad_lo, T_len, H, n0);
  for (int kk = 0; kk < k; ++kk) {
    if (kk + 1 < k) {
      stage_tap(taps + ((kk + 1) & 1) * kTile * kTile, u, z,
                m0 + (kk + 1) * dilation - pad_lo, T_len, H, n0);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // tap kk landed for every thread
    if (live) {
      const T* tap = taps + (kk & 1) * kTile * kTile;
      const float2 kdk = load2(kd + static_cast<size_t>(kk) * H + h);
      const int shift = kk * dilation - pad_lo;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int tt = t0 + i + shift;
        float2 n0v = make_float2(0.0f, 0.0f);
        if (i < rows && tt >= 0 && tt < T_len) {
          const float2 uu = load2(tap + (wk.r0 + i) * kTile + wk.c);
          const float2 an = rnd2<T>(make_float2(a0c.x * uu.x, a0c.y * uu.y));
          n0v = rnd2<T>(make_float2(an.x + c0c.x, an.y + c0c.y));
        }
        const float2 kn =
            rnd2<T>(make_float2(kdk.x * n0v.x, kdk.y * n0v.y));
        v[i] = rnd2<T>(make_float2(v[i].x + kn.x, v[i].y + kn.y));
      }
    }
    __syncthreads();  // tap kk is read before its buffer is copied over
  }
  double sum = 0.0;
  double sq = 0.0;
  if (live) {
    const float p1c = rnd<T>(*p1_ptr);
    const float2 g1c = make_float2(rnd<T>(g1w[h]), rnd<T>(g1w[h + 1]));
    const size_t base = static_cast<size_t>(z) * T_len * H + h;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i >= rows) break;
      const float wx = v[i].x >= 0.0f ? v[i].x : rnd<T>(p1c * v[i].x);
      const float wy = v[i].y >= 0.0f ? v[i].y : rnd<T>(p1c * v[i].y);
      sum += wx;
      sum += wy;
      sq += wx * wx;
      sq += wy * wy;
      store2<T>(gw + base + static_cast<size_t>(t0 + i) * H, g1c.x * wx,
                g1c.y * wy);
    }
  }
  block_scalars(part, z, sum, sq);
}

// corr[b][c] = sum_h c1[b][h] * W2[h][c] + b2[c], c1 rounded to the
// stream's dtype, f32 sums: a block per (32 channels, sample), its 8 warps
// each summing every 8th h, the 8 sums added in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    tcn_corr_kernel(const float* __restrict__ stats,
                    const float* __restrict__ g1w,
                    const float* __restrict__ g1b, const T* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ corr,
                    int H, int C) {
  __shared__ float red[8][32];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const float mu1 = stats[b * 4 + 2];
  const float rs1 = stats[b * 4 + 3];
  float acc = 0.0f;
  if (c < C) {
    for (int h = warp; h < H; h += 8) {
      const float c1 = g1b[h] - mu1 * g1w[h] * rs1;
      acc = fmaf(rnd<T>(c1), to_f32(w2[static_cast<size_t>(h) * C + c]), acc);
    }
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < C) {
    float total = red[0][lane];
    for (int w = 1; w < 8; ++w) total += red[w][lane];
    corr[static_cast<size_t>(b) * C + c] = total + b2[c];
  }
}

// Epilogue of the out product, tile of q = gw @ W2 for sample z, staged
// and written by rows: y = x + rs1 * round(q) + corr.
template <typename T, int kRowsTile = kTile>
struct EpiOut {
  static constexpr bool kTaps = false;
  static constexpr int kBM = kRowsTile;
  const T* x;
  const float* stats;
  const float* corr;
  T* y;
  int T_len, C;
  __device__ void operator()(const float (&acc)[64], int z, int m0, int n0,
                             float* tile) const {
    stage_tile<T, kBM>(acc, tile);
    const float rs1 = stats[z * 4 + 3];
    const float* cz = corr + static_cast<size_t>(z) * C + n0;
    for_each_row8<kBM>(tile, [&](int r, int c, float (&v)[8]) {
      if (m0 + r >= T_len || n0 + c >= C) return;
      const size_t idx =
          (static_cast<size_t>(z) * T_len + m0 + r) * C + n0 + c;
      float xv[8];
      load8(x + idx, xv);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = xv[j] + rs1 * rnd<T>(v[j]) + cz[c + j];
      store8(y + idx, v);
    });
  }
};

// Elements of the two scratch buffers the forward needs: n_stream of the
// stream's dtype and n_f32 floats (ops/cuda_tcn.py `forward_plan` plans
// the same).
void scratch(int B, int T_len, int C, int H, long long* n_stream,
             long long* n_f32) {
  *n_stream = 2LL * B * T_len * H;
  *n_f32 = 4LL * B * product_blocks(T_len, H, kShortTile) +
           4LL * B * product_blocks(T_len, H) + 1LL * B * C;
}

template <typename T>
cudaError_t forward(const void* x, const void* b1_eff, const void* w1,
                    const void* p0, const void* kd, const void* bd,
                    const void* g0w, const void* g0b, const void* p1,
                    const void* w2, const void* b2, const void* g1w,
                    const void* g1b, void* y, void* stats, void* stream_ws,
                    void* f32_ws, int B, int T_len, int C, int H, int k,
                    int dilation, int pad_lo, float eps, Marks& mk,
                    cudaStream_t stream) {
  const size_t n_stream = static_cast<size_t>(B) * T_len * H;
  T* u = static_cast<T*>(stream_ws);
  T* gw = u + n_stream;
  // partials a sample: of the u product's tiles, of the dconv walk's blocks
  const int p_u = product_blocks(
      T_len, H, short_tiles<T>(B, T_len, H) ? kShortTile : kTile);
  const int p = product_blocks(T_len, H);
  double* part_u = static_cast<double*>(f32_ws);  // f64 sums, then corr
  double* part_w = part_u + static_cast<size_t>(B) * p_u * 2;
  float* corr =
      reinterpret_cast<float*>(part_w + static_cast<size_t>(B) * p * 2);
  float* st = static_cast<float*>(stats);
  const double nhw = static_cast<double>(T_len) * H;

  TCN_CHECK(mk.done(cudaSuccess, stream));
  TCN_CHECK(mk.done(
      launch_u<T>(static_cast<const T*>(x), static_cast<const T*>(w1),
                  static_cast<const float*>(b1_eff),
                  static_cast<const float*>(p0), u, part_u, B, T_len, C, H,
                  stream),
      stream));
  tcn_stats_kernel<<<B, 128, 0, stream>>>(part_u, st, p_u, nhw, eps, 0);
  TCN_CHECK(mk.done(cudaGetLastError(), stream));
  const dim3 walk((T_len + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  TCN_CHECK(cudaFuncSetAttribute(tcn_dconv_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(tap_bytes<T>())));
  tcn_dconv_kernel<T><<<walk, kThreads, tap_bytes<T>(), stream>>>(
      u, st, static_cast<const float*>(g0w), static_cast<const float*>(g0b),
      static_cast<const T*>(kd), static_cast<const float*>(bd),
      static_cast<const float*>(g1w), static_cast<const float*>(p1), gw,
      part_w, T_len, H, k, dilation, pad_lo);
  TCN_CHECK(mk.done(cudaGetLastError(), stream));
  tcn_stats_kernel<<<B, 128, 0, stream>>>(part_w, st, p, nhw, eps, 2);
  TCN_CHECK(mk.done(cudaGetLastError(), stream));
  tcn_corr_kernel<T><<<dim3((C + 31) / 32, B), kThreads, 0, stream>>>(
      st, static_cast<const float*>(g1w), static_cast<const float*>(g1b),
      static_cast<const T*>(w2), static_cast<const float*>(b2), corr, H, C);
  TCN_CHECK(mk.done(cudaGetLastError(), stream));
  const Operands<T> op{gw, static_cast<long long>(T_len) * H, H,
                       static_cast<const T*>(w2), C, T_len, C, H, 0};
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    err = short_tiles<T>(B, T_len, C)
              ? launch_product<T, false>(
                    op, EpiOut<T, kShortTile>{xs, st, corr, ys, T_len, C}, B,
                    stream)
              : launch_product<T, false>(
                    op, EpiOut<T>{xs, st, corr, ys, T_len, C}, B, stream);
  } else {
    err = launch_product<T, false>(op, EpiOut<T>{xs, st, corr, ys, T_len, C},
                                   B, stream);
  }
  return mk.done(err, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes by
// wesep_tpu_torch/ops/cuda_tcn.py. dtype: 0 = f32, 1 = bf16.
//
// x [B, T, C], w1 [C, H], kd [k, H], w2 [H, C] in the stream's dtype;
// b1_eff [B, H], bd, g0w, g0b, g1w, g1b [H], b2 [C], p0, p1 [1] f32. Writes
// y [B, T, C] in the stream's dtype and stats [B, 4] f32 = (mu0, rs0, mu1,
// rs1). stream_ws holds n_stream elements of the stream's dtype and f32_ws
// n_f32 floats (8-byte aligned), at least what `scratch` asks. events: null, or n_events
// CUDA events, recorded before the first of the six launches and after
// each in turn. All
// contiguous and 16-byte aligned; C % 8 == 0, H % 8 == 0, k <= 8. Returns
// the CUDA error code of the first launch that failed (0 on success) and
// never synchronises.
extern "C" int tcn_block_forward(
    const void* x, const void* b1_eff, const void* w1, const void* p0,
    const void* kd, const void* bd, const void* g0w, const void* g0b,
    const void* p1, const void* w2, const void* b2, const void* g1w,
    const void* g1b, void* y, void* stats, void* stream_ws, void* f32_ws,
    void* events, int B, int T_len, int C, int H, int k, int dilation,
    int pad_lo, int dtype, int n_events, long long n_stream, long long n_f32,
    float eps, void* stream) {
  if (tcn::bad_shape(B, T_len, C, H, k, dilation, pad_lo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long need_stream = 0, need_f32 = 0;
  scratch(B, T_len, C, H, &need_stream, &need_f32);
  if (n_stream < need_stream || n_f32 < need_f32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tcn::Marks mk{static_cast<void* const*>(events), n_events, 0};
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = forward<float>(x, b1_eff, w1, p0, kd, bd, g0w, g0b, p1, w2, b2, g1w,
                         g1b, y, stats, stream_ws, f32_ws, B, T_len, C, H, k,
                         dilation, pad_lo, eps, mk, s);
  } else if (dtype == 1) {
    err = forward<__nv_bfloat16>(x, b1_eff, w1, p0, kd, bd, g0w, g0b, p1, w2,
                                 b2, g1w, g1b, y, stats, stream_ws, f32_ws, B,
                                 T_len, C, H, k, dilation, pad_lo, eps, mk, s);
  }
  return static_cast<int>(err);
}
