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
// What bounds it on this card. The adjoint's two products (dx and dK), 4 *
// 9 * Ci * Co operations per position, against x and dy read and dx written
// once: at enc0.conv2 (B 8, T 376, F 257, Ci 32, Co 16, bf16) 1.4e10
// operations, 14 us at 989 TFLOP/s, against 124 MB, 37 us at 3.35 TB/s:
// bytes bound it.
//
// bf16: six launches, three passes over x on the tensor cores
// (conv2d_tc.cuh):
//   A. conv_tc_kernel<kSums>   e recomputed; f64 sums of dy and
//                              round(dy * e_hat) per warp of a tile
//      conv_reduce64_kernel    S_a, S_b in a fixed order
//   B. conv_tc_kernel<kDout>   e recomputed; dout written once, f64 db
//                              partials, and the dK partial from the x
//                              segments and dout in shared memory, each of
//                              a wave of blocks walking its fixed set of
//                              tiles (`dk_blocks` of them, planned by the
//                              caller from conv2d_block_backward_slots)
//      tcn::sum_slices (x2)    dK (f32) and db (f64) in order
//   C. conv_tc_kernel<kOut>    dx: the conv of dout with K flipped in
//                              (T, F) and transposed in (Ci, Co), read so
//                              from w as it is staged
// No f32 [B, T, F, Co] stream is kept: e is recomputed twice.
//
// f32: seven launches on the FMA units (conv2d_common.cuh): the conv with
// e to an f32 scratch and the sums, their reduce, dout and db partials
// from e (conv_dout_kernel), the transposed conv (dx), the dK partials
// (conv_dk_kernel, each of `dk_blocks` blocks walking its own fixed set of
// tiles), and the two ordered sums.

#include "conv2d_tc.cuh"

namespace {

using namespace conv2d;

constexpr int kChunk = 1024;     // positions per block of conv_dout_kernel
constexpr int kKThreads = 192;   // 3 (df) x 16 (ci) x 4 (groups of 8 co)
constexpr int kKTT = 4;          // rows of a dK tile (x kTF columns)
constexpr int kKPos = kKTT * kTF;
constexpr int kKCo = 32;         // output channels per dK block
constexpr int kKBlocks = 256;    // most blocks over the f32 dK tiles
constexpr int kKPlane = halo_plane(kKTT + 2);

// dout and the per-block sums of dout (db), eight channels per thread.
__global__ void __launch_bounds__(kThreads)
    conv_dout_kernel(const float* __restrict__ e, const float* __restrict__ dy,
                     const float* __restrict__ stats,
                     const float* __restrict__ sums, float* __restrict__ dout,
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
        o[j] = de * (ev[j] > 0.0f ? 1.0f : ev[j] + 1.0f);
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
__global__ void __launch_bounds__(kKThreads)
    conv_dk_kernel(const float* __restrict__ x,
                   const float* __restrict__ dout, float* __restrict__ part,
                   int B, int T_len, int F_len, int Ci, int Co) {
  __shared__ __align__(16) float xs[kCiChunk * kKPlane];
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
    stage_halo<kKThreads>(x, xs, kKTT + 2, b, t0, f0, ci0, T_len, F_len,
                          Ci);
    // 16-byte loads of 4 output channels of one position
    for (int i = threadIdx.x; i < kKPos * kKCo / 4; i += kKThreads) {
      const int co = 4 * (i % (kKCo / 4));
      const int p = i / (kKCo / 4);
      const int gt = t0 + p / kTF;
      const int gf = f0 + p % kTF;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (co0 + co < Co && gt < T_len && gf < F_len) {
        v = *reinterpret_cast<const float4*>(
            dout + ((static_cast<size_t>(b) * T_len + gt) * F_len + gf) * Co +
            co0 + co);
      }
      *reinterpret_cast<float4*>(&ds[p][co]) = v;
    }
    __syncthreads();
    if (active) {
      const float* xc = xs + ci * kKPlane + df;
      for (int p = 0; p < kKPos; ++p) {
        const int r = p / kTF;
        const int c = p % kTF;
        const float4 d0 = *reinterpret_cast<const float4*>(&ds[p][cg * 8]);
        const float4 d1 =
            *reinterpret_cast<const float4*>(&ds[p][cg * 8 + 4]);
        const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int dt = 0; dt < 3; ++dt) {
          const float xv = xc[(r + dt) * kHaloW + c];
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

int dout_chunks(int T_len, int F_len) {
  return (T_len * F_len + kChunk - 1) / kChunk;
}

// The units the dK blocks share out (tiles: f32, of 4 x 32 positions; bf16,
// of kM positions) and the blocks one wave of the dK pass holds at Ci, Co:
// at most `units`, at least 1.
long long dk_units(int B, int T_len, int F_len, int dtype) {
  if (dtype == 0) {
    return static_cast<long long>(B) * ((T_len + kKTT - 1) / kKTT) *
           conv_ft(F_len);
  }
  return static_cast<long long>(B) * tc_tiles(T_len, F_len);
}

// Floats of the f32 scratch (f64 sections first, two floats each) and
// elements of the stream scratch, for `G` dK blocks.
void scratch(int B, int T_len, int F_len, int Ci, int Co, int dtype, int G,
             long long* n_stream, long long* n_f32) {
  const long long elems =
      static_cast<long long>(stream_elems(B, T_len, F_len, Co));
  *n_stream = elems;  // dout
  if (dtype == 0) {
    // e, the per-tile sums, S_a and S_b, db per chunk, dK per block
    *n_f32 = elems + 2LL * B * conv_tiles(T_len, F_len, Co) * Co +
             2LL * B * Co + 1LL * B * dout_chunks(T_len, F_len) * Co +
             9LL * G * Ci * Co;
  } else {
    // f64: the sums of each warp of each tile, S_a and S_b, db per block;
    // f32: dK per block
    *n_f32 = 2 * (2LL * B * tc_tiles(T_len, F_len) * kTcWarps * Co +
                  2LL * B * Co + 1LL * G * Co) +
             9LL * G * Ci * Co;
  }
}

cudaError_t backward_f32(const float* x, const float* w,
                         const float* w_flip, const float* bias,
                         const float* st, const float* dy, float* dx,
                         float* dk, float* db, float* dout, float* f32_ws,
                         int B, int T_len, int F_len, int Ci, int Co, int G,
                         tcn::Marks& mk, cudaStream_t stream) {
  const int positions = T_len * F_len;
  const int n_tiles = conv_tiles(T_len, F_len, Co);
  const int chunks = dout_chunks(T_len, F_len);
  float* e = f32_ws;
  float* part_s = e + stream_elems(B, T_len, F_len, Co);
  float* sums = part_s + 2ULL * B * n_tiles * Co;
  float* part_db = sums + 2ULL * B * Co;
  float* part_dk = part_db + 1ULL * B * chunks * Co;

  TCN_CHECK(mk.done(cudaSuccess, stream));
  TCN_CHECK(mk.done(launch_conv<kBackward>(x, w, bias, st, dy, e, nullptr,
                                           part_s, B, T_len, F_len, Ci, Co,
                                           stream),
                    stream));
  TCN_CHECK(mk.done(reduce_tiles(part_s, sums, B, n_tiles, Co, 0.0f, 0.0f, 0,
                                 stream),
                    stream));
  const float n = static_cast<float>(T_len) * static_cast<float>(F_len);
  conv_dout_kernel<<<dim3(chunks, B), kThreads, 0, stream>>>(
      e, dy, st, sums, dout, part_db, positions, Co, n);
  TCN_CHECK(mk.done(cudaGetLastError(), stream));
  TCN_CHECK(mk.done(launch_conv<kTransposed>(dout, w_flip, nullptr, nullptr,
                                             nullptr, nullptr, dx, nullptr, B,
                                             T_len, F_len, Co, Ci, stream),
                    stream));
  const dim3 kgrid(G, (Ci + kCiChunk - 1) / kCiChunk, (Co + kKCo - 1) / kKCo);
  conv_dk_kernel<<<kgrid, kKThreads, 0, stream>>>(x, dout, part_dk, B, T_len,
                                                  F_len, Ci, Co);
  TCN_CHECK(mk.done(cudaGetLastError(), stream));
  TCN_CHECK(mk.done(tcn::sum_partials(part_dk, dk, 1, G, 9 * Ci * Co,
                                      9 * Ci * Co, stream),
                    stream));
  return mk.done(tcn::sum_partials(part_db, db, 1, B * chunks, Co, Co,
                                   stream),
                 stream);
}

cudaError_t backward_bf16(const __nv_bfloat16* x, const float* w,
                          const float* bias,
                          const float* st, const __nv_bfloat16* dy,
                          __nv_bfloat16* dx, float* dk, float* db,
                          __nv_bfloat16* dout, float* f32_ws, int B,
                          int T_len, int F_len, int Ci, int Co, int G,
                          tcn::Marks& mk, cudaStream_t stream) {
  const int tiles = tc_tiles(T_len, F_len) * kTcWarps;  // warp partials
  double* part_s = reinterpret_cast<double*>(f32_ws);
  double* sums = part_s + 2LL * B * tiles * Co;
  double* part_db = sums + 2LL * B * Co;
  float* part_dk = reinterpret_cast<float*>(part_db + 1LL * G * Co);
  TcArgs a{x, w, bias, st, sums, dy, dout, part_s, part_dk,
           B, T_len, F_len, Ci, Co};

  TCN_CHECK(mk.done(cudaSuccess, stream));
  TCN_CHECK(mk.done(launch_tc<kSums>(a, 0, stream), stream));
  TCN_CHECK(mk.done(reduce64(part_s, nullptr, sums, B, tiles, Co, 0.0, 0.0f,
                             stream),
                    stream));
  a.part = part_db;
  TCN_CHECK(mk.done(launch_tc<kDout>(a, G, stream), stream));
  TCN_CHECK(mk.done(tcn::sum_slices<float, float>(part_dk, dk, 1, G,
                                                  9 * Ci * Co, 9 * Ci * Co,
                                                  stream),
                    stream));
  TCN_CHECK(mk.done(tcn::sum_slices<double, float>(part_db, db, 1, G, Co, Co,
                                                   stream),
                    stream));
  // dx: the conv of dout [B, T, F, Co] with K flipped and transposed, which
  // the kOut pass reads from w itself
  const TcArgs c{dout, w, nullptr, nullptr, nullptr, nullptr, dx,
                 nullptr, nullptr, B, T_len, F_len, Co, Ci};
  return mk.done(launch_tc<kOut>(c, 0, stream), stream);
}

}  // namespace

// Plain C entry points, bound with ctypes by
// wesep_tpu_torch/ops/cuda_conv2d.py. dtype: 0 = f32, 1 = bf16.

// The blocks one wave of the dK pass holds at Ci, Co (bf16: the occupancy
// of conv_tc_kernel<kDout> times the SMs; f32: kKBlocks); 0 if the card
// cannot be asked. The caller plans dk_blocks from it.
extern "C" int conv2d_block_backward_slots(int Ci, int Co, int dtype) {
  return dtype == 0 ? kKBlocks : conv2d::tc_slots<conv2d::kDout>(Ci, Co);
}

// Elements of the two scratch buffers the backward needs for dk_blocks
// blocks of the dK pass: n_stream of the stream's dtype (dout) and n_f32
// floats (see scratch).
extern "C" void conv2d_block_backward_scratch(int B, int T_len, int F_len,
                                              int Ci, int Co, int dtype,
                                              int dk_blocks,
                                              long long* n_stream,
                                              long long* n_f32) {
  scratch(B, T_len, F_len, Ci, Co, dtype, dk_blocks, n_stream, n_f32);
}

// x [B, T, F, Ci] and dy [B, T, F, Co] in the stream's dtype; w
// [3, 3, Ci, Co] (HWIO), bias [Co] and stats [B, 2, Co] (mu, rs) f32 (a
// bf16 stream rounds w as it reads it); for an f32 stream w_flip
// [3, 3, Co, Ci] f32, w flipped in both spatial axes with its channel axes
// swapped (a bf16 stream reads w so and takes no w_flip). Writes dx [B, T, F, Ci] in the stream's dtype, dk [3, 3, Ci, Co]
// and db [Co] f32. dk_blocks: blocks of the dK pass, 1 to the units it
// shares out (dk_units); stream_ws and f32_ws hold n_stream and n_f32
// elements, at least what conv2d_block_backward_scratch asks. Limits as the
// forward's. events: null, or n_events CUDA events, recorded before the
// first launch (7 f32, 6 bf16) and after each in turn. Returns the CUDA
// error code of the first launch that failed (0 on success) and never
// synchronises.
extern "C" int conv2d_block_backward(const void* x, const void* w,
                                     const void* w_flip, const void* bias,
                                     const void* stats, const void* dy,
                                     void* dx, void* dk, void* db,
                                     void* stream_ws, void* f32_ws,
                                     void* events, int B, int T_len,
                                     int F_len, int Ci, int Co, int dtype,
                                     int n_events, int dk_blocks,
                                     long long n_stream, long long n_f32,
                                     void* stream) {
  if (conv2d::bad_shape(B, T_len, F_len, Ci, Co) || (dtype != 0 && dtype != 1)
      || dk_blocks < 1 || dk_blocks > dk_units(B, T_len, F_len, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long need_stream = 0, need_f32 = 0;
  scratch(B, T_len, F_len, Ci, Co, dtype, dk_blocks, &need_stream, &need_f32);
  if (n_stream < need_stream || n_f32 < need_f32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tcn::Marks mk{static_cast<void* const*>(events), n_events, 0};
  cudaError_t err;
  if (dtype == 0) {
    err = backward_f32(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(w_flip), static_cast<const float*>(bias),
        static_cast<const float*>(stats), static_cast<const float*>(dy),
        static_cast<float*>(dx), static_cast<float*>(dk),
        static_cast<float*>(db), static_cast<float*>(stream_ws),
        static_cast<float*>(f32_ws), B, T_len, F_len, Ci, Co, dk_blocks, mk,
        s);
  } else {
    err = backward_bf16(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<const float*>(stats),
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(dx), static_cast<float*>(dk),
        static_cast<float*>(db), static_cast<__nv_bfloat16*>(stream_ws),
        static_cast<float*>(f32_ws), B, T_len, F_len, Ci, Co, dk_blocks, mk,
        s);
  }
  return static_cast<int>(err);
}
