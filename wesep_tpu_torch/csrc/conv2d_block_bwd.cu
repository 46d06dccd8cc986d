// Fused DPCCN Conv2dBlock, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel wesep_tpu/ops/pallas_conv2d.py
// `_bwd_kernel` (`_bwd_call`, the custom VJP of `conv2d_block_in`). From x,
// K, the bias, the forward's statistics (mu, rs) and dy, per sample b and
// channel c over the N = T * F positions:
//
//   e     = ELU(conv3x3(x) + bias), e_hat = (e - mu) * rs    recomputed
//   S_a   = sum(dy),  S_b = sum(round(dy * e_hat))
//   dout  = round(rs * (dy - S_a / N - e_hat * S_b / N) * (e > 0 ? 1 : e + 1))
//   db    = sum over b and positions of dout                 f32
//   dK[dt, df, ci, c] = sum x[b, t + dt - 1, f + df - 1, ci] * dout[b, t, f, c]
//   dx    = round(transposed conv3x3(dout, K))               f32 sums
//
// round() is to the stream's dtype. dout is rounded before db's sum and
// before both products, as the TPU kernel rounds it (unlike the BiLSTM
// kernels, whose db sums the unrounded values).
//
// Six launches on one stream:
//
//   1. conv3x3_kernel<kBackward>  e recomputed -> f32 scratch; per-tile sums
//                                 of dy and round(dy * e_hat)
//   2. conv_reduce_kernel         S_a, S_b in a fixed order
//   3. conv_dout_kernel           dout (stream dtype scratch), per-block db
//   4. conv3x3_kernel<kTransposed>  dx: the conv of dout with K flipped in
//                                 (T, F) and transposed in (Ci, Co), which
//                                 the wrapper passes as w_flip
//   5. conv_dk_kernel             per-block dK from x and dout tiles, each
//                                 block walking its own fixed set of tiles
//   6. tcn::sum_partials (x2)     dK and db from the partials, in order
//
// What bounds it on this card. The adjoint's two products (dx and dK), 4 *
// 9 * Ci * Co operations per position, against x and dy read and dx written
// once: at enc0.conv2 (B 8, T 376, F 257, Ci 32, Co 16, bf16) 1.4e10
// operations, 14 us at 989 TFLOP/s, against 124 MB, 37 us at 3.35 TB/s:
// bytes bound it. The products, and the recompute of e (a third conv),
// run on the f32 FMA units; e and dout make one round trip each through
// device memory.

#include "conv2d_common.cuh"

namespace {

using namespace conv2d;

constexpr int kChunk = 1024;     // positions per block of conv_dout_kernel
constexpr int kKThreads = 192;   // 3 (df) x 16 (ci) x 4 (groups of 8 co)
constexpr int kKTT = 4;          // rows of a dK tile (x kTF columns)
constexpr int kKPos = kKTT * kTF;
constexpr int kKCo = 32;         // output channels per dK block
constexpr int kKBlocks = 256;    // most blocks over the dK tiles

// dout and the per-block sums of dout (db), eight channels per thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_dout_kernel(const float* __restrict__ e, const T* __restrict__ dy,
                     const float* __restrict__ stats,
                     const float* __restrict__ sums, T* __restrict__ dout,
                     float* __restrict__ part_db, int positions, int Co,
                     float n) {
  __shared__ float red[kThreads][8];
  const int b = blockIdx.y;
  const int groups = Co / 8;
  const int rows = kThreads / groups;
  const int cg = threadIdx.x % groups;
  const int row = threadIdx.x / groups;
  const int c0 = cg * 8;
  float db[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) db[j] = 0.0f;
  if (row < rows) {
    const float* st = stats + static_cast<size_t>(b) * 2 * Co + c0;
    const float* sm = sums + static_cast<size_t>(b) * 2 * Co + c0;
    float mu[8], rs[8], sa[8], sb[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mu[j] = st[j];
      rs[j] = st[Co + j];
      sa[j] = sm[j] / n;
      sb[j] = sm[Co + j] / n;
    }
    const int p0 = static_cast<int>(blockIdx.x) * kChunk;
    const int p1 = min(p0 + kChunk, positions);
    for (int p = p0 + row; p < p1; p += rows) {
      const size_t idx =
          (static_cast<size_t>(b) * positions + p) * Co + c0;
      float ev[8], g[8], o[8];
      load8(e + idx, ev);
      load8(dy + idx, g);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float eh = (ev[j] - mu[j]) * rs[j];
        const float de = rs[j] * (g[j] - sa[j] - eh * sb[j]);
        o[j] = rnd<T>(de * (ev[j] > 0.0f ? 1.0f : ev[j] + 1.0f));
        db[j] += o[j];
      }
      store8(dout + idx, o);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) red[threadIdx.x][j] = db[j];
  __syncthreads();
  if (threadIdx.x < Co) {
    const int g = threadIdx.x / 8;
    const int j = threadIdx.x % 8;
    float s = 0.0f;
    for (int r = 0; r < rows; ++r) s += red[r * groups + g][j];
    part_db[(static_cast<size_t>(b) * gridDim.x + blockIdx.x) * Co +
            threadIdx.x] = s;
  }
}

// Partial dK of block g over the tiles g, g + G, ... (4 x 32 positions of
// one sample each, row-major over samples, T tiles, F tiles) for the input
// channels blockIdx.y * 16 .. + 16 and output channels blockIdx.z * 32 ..
// + 32: thread (df, ci, group) holds the 3 (dt) x 8 sums of
// x[t + dt - 1, f + df - 1, ci] * dout[t, f, c]. part [G, 3, 3, Ci, Co].
template <typename T>
__global__ void __launch_bounds__(kKThreads)
    conv_dk_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                   float* __restrict__ part, int B, int T_len, int F_len,
                   int Ci, int Co) {
  __shared__ __align__(16) float xs[kCiChunk][kKTT + 2][kHaloW];
  __shared__ __align__(16) float ds[kKPos][kKCo];
  const int ci0 = blockIdx.y * kCiChunk;
  const int co0 = blockIdx.z * kKCo;
  const int cg = threadIdx.x % 4;
  const int ci = (threadIdx.x / 4) % kCiChunk;
  const int df = threadIdx.x / (4 * kCiChunk);
  const bool active = ci0 + ci < Ci && co0 + cg * 8 < Co;
  const int n_ft = conv_ft(F_len);
  const int per_sample = ((T_len + kKTT - 1) / kKTT) * n_ft;
  const int total = B * per_sample;
  float acc[3][8];
#pragma unroll
  for (int dt = 0; dt < 3; ++dt) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[dt][j] = 0.0f;
  }
  for (int k = blockIdx.x; k < total; k += gridDim.x) {
    const int b = k / per_sample;
    const int rem = k % per_sample;
    const int t0 = (rem / n_ft) * kKTT;
    const int f0 = (rem % n_ft) * kTF;
    for (int i = threadIdx.x; i < kCiChunk * (kKTT + 2) * kHaloW;
         i += kKThreads) {
      const int c_in = i % kCiChunk;
      const int rc = i / kCiChunk;
      const int c = rc % kHaloW;
      const int r = rc / kHaloW;
      const int gt = t0 + r - 1;
      const int gf = f0 + c - 1;
      float v = 0.0f;
      if (ci0 + c_in < Ci && gt >= 0 && gt < T_len && gf >= 0 &&
          gf < F_len) {
        v = to_f32(x[((static_cast<size_t>(b) * T_len + gt) * F_len + gf) *
                         Ci + ci0 + c_in]);
      }
      xs[c_in][r][c] = v;
    }
    for (int i = threadIdx.x; i < kKPos * kKCo; i += kKThreads) {
      const int co = i % kKCo;
      const int p = i / kKCo;
      const int gt = t0 + p / kTF;
      const int gf = f0 + p % kTF;
      float v = 0.0f;
      if (co0 + co < Co && gt < T_len && gf < F_len) {
        v = to_f32(dout[((static_cast<size_t>(b) * T_len + gt) * F_len + gf) *
                            Co + co0 + co]);
      }
      ds[p][co] = v;
    }
    __syncthreads();
    if (active) {
      for (int p = 0; p < kKPos; ++p) {
        const int r = p / kTF;
        const int c = p % kTF + df;
        const float4 d0 = *reinterpret_cast<const float4*>(&ds[p][cg * 8]);
        const float4 d1 =
            *reinterpret_cast<const float4*>(&ds[p][cg * 8 + 4]);
        const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int dt = 0; dt < 3; ++dt) {
          const float xv = xs[ci][r + dt][c];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[dt][j] = fmaf(xv, dv[j], acc[dt][j]);
          }
        }
      }
    }
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
      float* o = part + ((static_cast<size_t>(blockIdx.x) * 9 + dt * 3 + df) *
                             Ci + ci0 + ci) * Co + co0 + cg * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = acc[dt][j];
    }
  }
}

int dk_blocks(int B, int T_len, int F_len) {
  const int tiles = B * ((T_len + kKTT - 1) / kKTT) * conv_ft(F_len);
  return tiles < kKBlocks ? tiles : kKBlocks;
}

int dout_chunks(int T_len, int F_len) {
  return (T_len * F_len + kChunk - 1) / kChunk;
}

template <typename T>
cudaError_t backward(const void* x, const void* w, const void* w_flip,
                     const void* bias, const void* stats, const void* dy,
                     void* dx, void* dk, void* db, void* stream_ws,
                     void* f32_ws, int B, int T_len, int F_len, int Ci,
                     int Co, cudaStream_t stream) {
  const int positions = T_len * F_len;
  const int n_tiles = conv_tiles(T_len, F_len, Co);
  const int chunks = dout_chunks(T_len, F_len);
  const int G = dk_blocks(B, T_len, F_len);
  float* e = static_cast<float*>(f32_ws);
  float* part_s = e + stream_elems(B, T_len, F_len, Co);
  float* sums = part_s + 2ULL * B * n_tiles * Co;
  float* part_db = sums + 2ULL * B * Co;
  float* part_dk = part_db + 1ULL * B * chunks * Co;
  T* dout = static_cast<T*>(stream_ws);
  const T* xt = static_cast<const T*>(x);
  const float* st = static_cast<const float*>(stats);

  TCN_CHECK((launch_conv<T, kBackward>(
      xt, static_cast<const T*>(w), static_cast<const float*>(bias), st,
      static_cast<const T*>(dy), e, nullptr, part_s, B, T_len, F_len, Ci, Co,
      stream)));
  TCN_CHECK(reduce_tiles(part_s, sums, B, n_tiles, Co, 0.0f, 0.0f, 0,
                         stream));
  const float n = static_cast<float>(T_len) * static_cast<float>(F_len);
  conv_dout_kernel<T><<<dim3(chunks, B), kThreads, 0, stream>>>(
      e, static_cast<const T*>(dy), st, sums, dout, part_db, positions, Co,
      n);
  TCN_CHECK(cudaGetLastError());
  TCN_CHECK((launch_conv<T, kTransposed>(
      dout, static_cast<const T*>(w_flip), nullptr, nullptr, nullptr, nullptr,
      static_cast<T*>(dx), nullptr, B, T_len, F_len, Co, Ci, stream)));
  const dim3 kgrid(G, (Ci + kCiChunk - 1) / kCiChunk, (Co + kKCo - 1) / kKCo);
  conv_dk_kernel<T><<<kgrid, kKThreads, 0, stream>>>(xt, dout, part_dk, B,
                                                     T_len, F_len, Ci, Co);
  TCN_CHECK(cudaGetLastError());
  TCN_CHECK(tcn::sum_partials(part_dk, static_cast<float*>(dk), 1, G,
                              9 * Ci * Co, 9 * Ci * Co, stream));
  return tcn::sum_partials(part_db, static_cast<float*>(db), 1, B * chunks,
                           Co, Co, stream);
}

}  // namespace

// Plain C entry points, bound with ctypes by
// wesep_tpu_torch/ops/cuda_conv2d.py. dtype: 0 = f32, 1 = bf16.

// Elements of the two scratch buffers the backward needs: n_stream of the
// stream's dtype (dout) and n_f32 floats (e and the partial sums).
extern "C" void conv2d_block_backward_scratch(int B, int T_len, int F_len,
                                              int Ci, int Co,
                                              long long* n_stream,
                                              long long* n_f32) {
  const size_t elems = conv2d::stream_elems(B, T_len, F_len, Co);
  *n_stream = static_cast<long long>(elems);
  *n_f32 = static_cast<long long>(
      elems + 2ULL * B * conv2d::conv_tiles(T_len, F_len, Co) * Co +
      2ULL * B * Co + 1ULL * B * dout_chunks(T_len, F_len) * Co +
      9ULL * dk_blocks(B, T_len, F_len) * Ci * Co);
}

// x [B, T, F, Ci], w [3, 3, Ci, Co] (HWIO), w_flip [3, 3, Co, Ci] (w
// flipped in both spatial axes, its channel axes swapped) and dy
// [B, T, F, Co] in the stream's dtype; bias [Co] and stats [B, 2, Co] (mu,
// rs) f32. Writes dx [B, T, F, Ci] in the stream's dtype, dk [3, 3, Ci, Co]
// and db [Co] f32. Limits as the forward's. Returns the CUDA error code of
// the first launch that failed (0 on success) and never synchronises.
extern "C" int conv2d_block_backward(const void* x, const void* w,
                                     const void* w_flip, const void* bias,
                                     const void* stats, const void* dy,
                                     void* dx, void* dk, void* db,
                                     void* stream_ws, void* f32_ws, int B,
                                     int T_len, int F_len, int Ci, int Co,
                                     int dtype, void* stream) {
  if (conv2d::bad_shape(B, T_len, F_len, Ci, Co)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = backward<float>(x, w, w_flip, bias, stats, dy, dx, dk, db,
                          stream_ws, f32_ws, B, T_len, F_len, Ci, Co, s);
  } else if (dtype == 1) {
    err = backward<__nv_bfloat16>(x, w, w_flip, bias, stats, dy, dx, dk, db,
                                  stream_ws, f32_ws, B, T_len, F_len, Ci, Co,
                                  s);
  }
  return static_cast<int>(err);
}
