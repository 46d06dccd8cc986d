// Device code shared by the fused DPCCN Conv2dBlock kernels
// (conv2d_block.cu forward, conv2d_block_bwd.cu backward) on f32 streams: a
// tiled 3x3 stride-1 pad-1 convolution on the FMA units over channels-last
// [B, T, F, C] streams whose epilogue is the forward's ELU with its
// instance-norm sums, the backward's recompute of e with the adjoint's sums,
// or a plain output (the transposed convolution that gives dx); the
// ordered reduction of per-tile sums; and shape limits. bf16 streams take
// the tensor-core passes of conv2d_tc.cuh.
//
// Every product accumulates in f32 and every sum is f32. Nothing uses
// atomics: each block writes its own partial sums, and a second launch adds
// them in a fixed order, so a run repeats bit for bit.

#pragma once

#include "tcn_common.cuh"

namespace conv2d {

using tcn::load8;

constexpr int kThreads = 256;    // threads of a conv or elementwise block
constexpr int kTF = 32;          // F columns of a conv tile, one per lane
constexpr int kHaloW = kTF + 2;  // staged columns, with the two halo columns
constexpr int kCiChunk = 16;     // input channels staged per pass
constexpr int kMaxC = 256;       // most channels on either side
constexpr size_t kOptIn = 32 * 1024;  // dynamic smem above this opts in

// Epilogues of the conv kernel (f32: every rounding is the identity).
constexpr int kForward = 0;     // e = ELU(conv + b) -> scratch; sums of e,
                                // e^2 per tile
constexpr int kBackward = 1;    // the same e; sums of dy, dy * e_hat
constexpr int kTransposed = 2;  // out = conv, no bias (dx)

// Floats of one input channel's plane of a staged x halo of `rows` rows:
// padded to 2 mod 32, so that the four channels one thread stages from a
// 16-byte load land in four different bank octets.
__host__ __device__ constexpr int halo_plane(int rows) {
  return (rows * kHaloW + 31) / 32 * 32 + 2;
}

// Stage x[b, t0 - 1 .. t0 + rows, f0 - 1 .. f0 + 32, ci0 .. ci0 + 16] into
// xs [16][halo_plane(rows)] (channel planes of rows x kHaloW floats), zero
// outside the stream: 16-byte loads of four channels of one position, four
// threads a position, so a warp reads 8 positions' 64 contiguous bytes.
template <int kThreadsN>
__device__ __forceinline__ void stage_halo(const float* __restrict__ x,
                                           float* __restrict__ xs, int rows,
                                           int b, int t0, int f0, int ci0,
                                           int T_len, int F_len, int Ci) {
  const int plane = halo_plane(rows);
  const int n_quads = (kCiChunk / 4) * rows * kHaloW;
  for (int i = threadIdx.x; i < n_quads; i += kThreadsN) {
    const int q = i % (kCiChunk / 4);
    const int pos = i / (kCiChunk / 4);
    const int c = pos % kHaloW;
    const int r = pos / kHaloW;
    const int gt = t0 + r - 1;
    const int gf = f0 + c - 1;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (ci0 + 4 * q < Ci && gt >= 0 && gt < T_len && gf >= 0 && gf < F_len) {
      v = *reinterpret_cast<const float4*>(
          x + ((static_cast<size_t>(b) * T_len + gt) * F_len + gf) * Ci + ci0 +
          4 * q);
    }
    float* o = xs + 4 * q * plane + pos;
    o[0] = v.x;
    o[plane] = v.y;
    o[2 * plane] = v.z;
    o[3 * plane] = v.w;
  }
}

// A block computes a tile of TT x 32 positions of one sample for CB output
// channels with 256 threads: each warp owns one group of 8 channels and 4
// rows, each lane one F column, so a thread holds 4 x 8 sums.
template <int CB>
struct ConvTile {
  static constexpr int kGroups = CB / 8;
  static constexpr int kRowGroups = 8 / kGroups;
  static constexpr int kTT = 4 * kRowGroups;
  static constexpr int kPlane = halo_plane(kTT + 2);
  static constexpr int kXs = kCiChunk * kPlane;  // floats
  static constexpr int kWs = 9 * kCiChunk * CB;  // floats
  static constexpr size_t kSmem = (kXs + kWs) * sizeof(float);
  static_assert(kGroups * kRowGroups == kThreads / 32, "8 warps");
  static_assert(kXs % 4 == 0, "the weight tile starts 16-byte aligned");
};

// The tile width CB chosen for `cout` output channels: 16, 32 or 64 (wider
// outputs take several column blocks of 64).
inline int conv_cb(int cout) { return cout <= 16 ? 16 : cout <= 32 ? 32 : 64; }
inline int conv_tt(int cout) { return 4 * (8 / (conv_cb(cout) / 8)); }
__host__ __device__ inline int conv_ft(int F_len) { return (F_len + kTF - 1) / kTF; }
// Tiles per sample of the conv kernel for `cout` output channels.
inline int conv_tiles(int T_len, int F_len, int cout) {
  const int tt = conv_tt(cout);
  return ((T_len + tt - 1) / tt) * conv_ft(F_len);
}

__device__ __forceinline__ void store8(float* __restrict__ p,
                                       const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The 3x3 convolution of x [B, T, F, Ci] with w [3, 3, Ci, Co] (HWIO),
// zero outside [0, T) x [0, F), for the tile blockIdx.x (row-major over T
// tiles x F tiles), the output channels blockIdx.y * CB .. + CB and the
// sample blockIdx.z; then the epilogue MODE (see above). e_out
// [B, T, F, Co]; part [B, tiles, 2, Co]; stats [B, 2, Co] (mu, rs); dy and
// out [B, T, F, Co]. All f32.
template <int CB, int MODE>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ stats,
                   const float* __restrict__ dy, float* __restrict__ e_out,
                   float* __restrict__ out, float* __restrict__ part,
                   int T_len, int F_len, int Ci, int Co) {
  using Tile = ConvTile<CB>;
  constexpr int kTT = Tile::kTT;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;              // [kCiChunk][Tile::kPlane]
  float* ws = smem + Tile::kXs;  // [9][kCiChunk][CB]
  __shared__ float red[kThreads / 32][2][8];

  const int b = blockIdx.z;
  const int n_ft = conv_ft(F_len);
  const int t0 = (blockIdx.x / n_ft) * kTT;
  const int f0 = (blockIdx.x % n_ft) * kTF;
  const int co0 = blockIdx.y * CB;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cg = warp % Tile::kGroups;
  const int rg = warp / Tile::kGroups;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  for (int ci0 = 0; ci0 < Ci; ci0 += kCiChunk) {
    const int nci = min(kCiChunk, Ci - ci0);
    stage_halo<kThreads>(x, xs, kTT + 2, b, t0, f0, ci0, T_len, F_len, Ci);
    // 16-byte loads of 4 output channels; Co % 8 == 0
    for (int i = threadIdx.x; i < Tile::kWs / 4; i += kThreads) {
      const int co = 4 * (i % (CB / 4));
      const int rest = i / (CB / 4);
      const int ci = rest % kCiChunk;
      const int k9 = rest / kCiChunk;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (ci < nci && co0 + co < Co) {
        v = *reinterpret_cast<const float4*>(
            w + (static_cast<size_t>(k9) * Ci + ci0 + ci) * Co + co0 + co);
      }
      reinterpret_cast<float4*>(ws)[i] = v;
    }
    __syncthreads();
    for (int ci = 0; ci < nci; ++ci) {
      const float* xc = xs + ci * Tile::kPlane + rg * 4 * kHaloW + lane;
#pragma unroll
      for (int df = 0; df < 3; ++df) {
        float xv[6];
#pragma unroll
        for (int r = 0; r < 6; ++r) xv[r] = xc[r * kHaloW + df];
#pragma unroll
        for (int dt = 0; dt < 3; ++dt) {
          const float4* wp = reinterpret_cast<const float4*>(
              ws + ((dt * 3 + df) * kCiChunk + ci) * CB + cg * 8);
          const float4 w0 = wp[0];
          const float4 w1 = wp[1];
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w,
                               w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              acc[i][j] = fmaf(xv[i + dt], wv[j], acc[i][j]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  const int f = f0 + lane;
  const int c0 = co0 + cg * 8;  // Co % 8 == 0: a group is all in or out
  const bool c_ok = c0 < Co;
  if (MODE == kTransposed) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + rg * 4 + i;
      if (c_ok && t < T_len && f < F_len) {
        store8(out + ((static_cast<size_t>(b) * T_len + t) * F_len + f) * Co +
                   c0,
               acc[i]);
      }
    }
    return;
  }

  float bv[8];
  float mu[8];
  float rs[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bv[j] = c_ok ? bias[c0 + j] : 0.0f;
    mu[j] = 0.0f;
    rs[j] = 0.0f;
    if (MODE == kBackward && c_ok) {
      mu[j] = stats[(static_cast<size_t>(b) * 2) * Co + c0 + j];
      rs[j] = stats[(static_cast<size_t>(b) * 2 + 1) * Co + c0 + j];
    }
  }
  float s0[8];
  float s1[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s0[j] = 0.0f;
    s1[j] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + rg * 4 + i;
    if (!(c_ok && t < T_len && f < F_len)) continue;
    const size_t idx =
        ((static_cast<size_t>(b) * T_len + t) * F_len + f) * Co + c0;
    float e[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = acc[i][j] + bv[j];
      e[j] = v > 0.0f ? v : expf(v) - 1.0f;
    }
    store8(e_out + idx, e);
    if (MODE == kForward) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s0[j] += e[j];
        s1[j] += e[j] * e[j];
      }
    } else {
      float g[8];
      load8(dy + idx, g);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s0[j] += g[j];
        s1[j] += g[j] * ((e[j] - mu[j]) * rs[j]);
      }
    }
  }
  // every lane of a warp holds the same 8 channels
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s0[j] += __shfl_down_sync(0xffffffffu, s0[j], off);
      s1[j] += __shfl_down_sync(0xffffffffu, s1[j], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[warp][0][j] = s0[j];
      red[warp][1][j] = s1[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * CB) {
    const int which = threadIdx.x / CB;
    const int c = threadIdx.x % CB;
    float s = 0.0f;
    for (int r = 0; r < Tile::kRowGroups; ++r) {
      s += red[r * Tile::kGroups + c / 8][which][c % 8];
    }
    if (co0 + c < Co) {
      part[((static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 2 + which) *
               Co + co0 + c] = s;
    }
  }
}

template <int CB, int MODE>
cudaError_t launch_conv_cb(const float* x, const float* w, const float* bias,
                           const float* stats, const float* dy, float* e_out,
                           float* out, float* part, int B, int T_len,
                           int F_len, int Ci, int Co, cudaStream_t stream) {
  using Tile = ConvTile<CB>;
  auto kernel = conv3x3_kernel<CB, MODE>;
  if (Tile::kSmem > kOptIn) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Tile::kSmem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(conv_tiles(T_len, F_len, Co), (Co + CB - 1) / CB, B);
  kernel<<<grid, kThreads, Tile::kSmem, stream>>>(
      x, w, bias, stats, dy, e_out, out, part, T_len, F_len, Ci, Co);
  return cudaGetLastError();
}

// The conv kernel with the tile width for Co output channels.
template <int MODE>
cudaError_t launch_conv(const float* x, const float* w, const float* bias,
                        const float* stats, const float* dy, float* e_out,
                        float* out, float* part, int B, int T_len, int F_len,
                        int Ci, int Co, cudaStream_t stream) {
  switch (conv_cb(Co)) {
    case 16:
      return launch_conv_cb<16, MODE>(x, w, bias, stats, dy, e_out, out, part,
                                      B, T_len, F_len, Ci, Co, stream);
    case 32:
      return launch_conv_cb<32, MODE>(x, w, bias, stats, dy, e_out, out, part,
                                      B, T_len, F_len, Ci, Co, stream);
    default:
      return launch_conv_cb<64, MODE>(x, w, bias, stats, dy, e_out, out, part,
                                      B, T_len, F_len, Ci, Co, stream);
  }
}

// out[b][k][c] = sum over tiles, in order, of part[b][tile][k][c]; with
// `finalize`, the instance-norm statistics instead: out[b][0][c] = mean =
// sum0 / n, out[b][1][c] = 1 / sqrt(max(sum1 / n - mean^2, 0) + eps).
__global__ void conv_reduce_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int n_tiles,
                                   int Co, float n, float eps, int finalize) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Co) return;
  const float* p = part + static_cast<size_t>(b) * n_tiles * 2 * Co + c;
  float s0 = 0.0f;
  float s1 = 0.0f;
  for (int i = 0; i < n_tiles; ++i) {
    s0 += p[static_cast<size_t>(2 * i) * Co];
    s1 += p[static_cast<size_t>(2 * i + 1) * Co];
  }
  float* o = out + static_cast<size_t>(b) * 2 * Co + c;
  if (finalize) {
    const float mu = s0 / n;
    const float var = fmaxf(s1 / n - mu * mu, 0.0f);
    o[0] = mu;
    o[Co] = 1.0f / sqrtf(var + eps);
  } else {
    o[0] = s0;
    o[Co] = s1;
  }
}

inline cudaError_t reduce_tiles(const float* part, float* out, int B,
                                int n_tiles, int Co, float n, float eps,
                                int finalize, cudaStream_t stream) {
  const dim3 grid((Co + 63) / 64, B);
  conv_reduce_kernel<<<grid, 64, 0, stream>>>(part, out, n_tiles, Co, n, eps,
                                              finalize);
  return cudaGetLastError();
}

// The shapes the kernels take: Ci and Co multiples of 8 up to kMaxC, B up
// to 65535 (a grid dimension), a non-empty stream.
inline bool bad_shape(int B, int T_len, int F_len, int Ci, int Co) {
  return B <= 0 || T_len <= 0 || F_len <= 0 || Ci <= 0 || Co <= 0 ||
         Ci % 8 != 0 || Co % 8 != 0 || Ci > kMaxC || Co > kMaxC ||
         B > 65535;
}

inline size_t stream_elems(int B, int T_len, int F_len, int C) {
  return static_cast<size_t>(B) * T_len * F_len * C;
}

}  // namespace conv2d
