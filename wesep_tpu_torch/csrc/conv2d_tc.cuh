// The bf16 passes of the fused DPCCN Conv2dBlock (conv2d_block.cu forward,
// conv2d_block_bwd.cu backward): the 3x3 stride-1 pad-1 convolution over a
// channels-last [B, T, F, C] stream as an implicit GEMM on the tensor cores
// (mma.sync.m16n8k16 through ldmatrix, tc_common.cuh), with the block's
// elementwise work and sums in its epilogue.
//
// The product. A tile is kM = 128 consecutive positions p = t * F + f of
// one sample (the M of the GEMM), so F 257 / 129 / 65 / 33 / 17 waste no
// lanes: only a sample's last tile runs past T * F (8 of 96,640 positions at
// F 257). Output position p reads input positions p + (dt - 1) * F + df - 1
// for the taps (dt, df): three runs of kM + 2 consecutive positions, one
// per dt, whatever F is; where F <= kM + 2 the three overlap and are staged
// once, as one stripe of 2 F + kM + 2 positions. Those runs are contiguous
// pieces of the channels-last stream, copied into shared memory by 16-byte
// cp.async copies (zero outside the sample), two buffers deep: a block
// copies its next tile while it computes this one. K is 9 taps x the input
// channels; each lane hands ldmatrix the address of its own row, so the
// im2col matrix is never formed: row p of tap (dt, df) is the staged
// position dt * stride + p + df, or a zero row where f + df - 1 leaves
// [0, F) (the f-edges; the t-edges are the zero-filled positions). N is a
// slab of NB (16 or 32) output channels. The weights [9 * KC, NB] of a
// chunk of KC (16 or 32) input channels are read as stored (f32, HWIO),
// rounded to bf16 as they are staged, and stay in shared memory for every
// tile a block walks; the dx pass reads them flipped in (T, F) with Ci and
// Co swapped, so no flipped copy is made. Position rows are swizzled
// (16-byte chunk c of row q at c ^ s(q)) and weight rows padded by 8, so no
// ldmatrix has a bank conflict; a lane's row address for each of its rows
// and taps is formed once a tile, and one XOR a step picks the chunk.
//
// Blocks of 4 warps, each warp 32 rows x NB (two m16 tiles), walk the tiles
// blockIdx.x, + gridDim.x, ... (a grid of one wave, from the occupancy the
// card reports). Epilogues (MODE):
//   kStats  forward pass 1: e = ELU(acc + b); per-tile sums of round(e) and
//           round(e * e): each thread's four rows in f32, then f64 over the
//           lanes, one partial a warp
//   kNorm   forward pass 3: e again; y = round((e - mu) * rs)
//   kSums   backward pass A: e again; per-tile sums of dy and
//           round(dy * e_hat), as kStats sums
//   kDout   backward pass B: e again; dout = round(rs * (dy - S_a / N -
//           e_hat * S_b / N) * ELU'(e)) written once; db (f64) from the
//           rounded dout; and the dK partial im2col(x)^T . dout
//           [9 * KC, NB] on the tensor cores from the staged positions and
//           dout staged beside them, summed over the block's tiles in
//           registers (blockIdx.y picks the chunk of input channels whose dK
//           the block forms)
//   kOut    backward pass C: dx = round(acc), the conv of dout with K
//           flipped and transposed
// No atomics: every partial has its own slot and is summed in a fixed order
// by a later launch.

#pragma once

#include "conv2d_common.cuh"

namespace conv2d {

constexpr int kM = 128;              // positions of a tile
constexpr int kSegRows = kM + 2;     // positions of one segment
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;

constexpr int kStats = 0;
constexpr int kNorm = 1;
constexpr int kSums = 2;
constexpr int kDout = 3;
constexpr int kOut = 4;

__host__ __device__ inline int tc_tiles(int T_len, int F_len) {
  return static_cast<int>((static_cast<long long>(T_len) * F_len + kM - 1) /
                          kM);
}
// Input channels per staged chunk and output channels per slab.
inline int tc_kc(int cin) { return cin <= 16 ? 16 : 32; }
inline int tc_nb(int cout) { return cout <= 16 ? 16 : 32; }

template <int KC, int NB, int MODE>
struct TcLayout {
  static constexpr int kRowBytes = KC * 2;                // a position row
  static constexpr int kXBytes = 3 * kSegRows * kRowBytes;  // one buffer
  // weights: [k][n] (k = tap * KC + channel) with rows of NB + 8; the dx
  // pass [n][k] with rows of 9 KC + 8
  static constexpr int kWLd = MODE == kOut ? 9 * KC + 8 : NB + 8;
  static constexpr int kWBytes = (MODE == kOut ? NB : 9 * KC) * kWLd * 2;
  static constexpr int kDLd = NB + 8;  // padded dout rows
  static constexpr int kDBytes = MODE == kDout ? kM * kDLd * 2 : 0;
  static constexpr int kRedBytes = kTcWarps * NB * 8;
  static constexpr int kW = 2 * kXBytes;
  static constexpr int kD = kW + kWBytes;
  static constexpr int kRed = kD + kDBytes;
  static constexpr int kZero = (kRed + kRedBytes + 63) / 64 * 64;
  static constexpr size_t kSmem = kZero + 64;  // one zero position row
  // dK rows [9 * KC] in m16 tiles, dealt to the warps in turn
  static constexpr int kDkTiles = 9 * KC / 16;
  static constexpr int kDkPerWarp = (kDkTiles + kTcWarps - 1) / kTcWarps;
  static_assert(kXBytes % 64 == 0 && kWBytes % 16 == 0 && kDBytes % 16 == 0,
                "aligned regions");
};

// The swizzle of position row q: chunk c of the row sits at c ^ s(q), so
// that the eight rows of any ldmatrix (eight consecutive q) hit eight bank
// groups. Returned shifted to its byte place (bits 4-5, which a row's
// 32- or 64-byte aligned address leaves clear).
template <int KC>
__device__ __forceinline__ uint32_t swz(int q) {
  return KC == 32 ? ((q >> 1) & 3) << 4 : ((q >> 2) & 1) << 4;
}

// A lane's row address: the row's address with its swizzle in bits 4-5;
// the byte address of chunk c is then row ^ (c << 4). Where the tap leaves
// [0, F) at column f, the zero row (64 bytes of zeros, 64-byte aligned).
template <int KC>
__device__ __forceinline__ uint32_t row_addr(uint32_t xs, uint32_t zero,
                                             int q, int df, int f,
                                             int F_len) {
  const bool ok = (df != 0 || f != 0) && (df != 2 || f != F_len - 1);
  return ok ? (xs + q * KC * 2) | swz<KC>(q) : zero;
}

struct TcArgs {
  const __nv_bfloat16* x;   // [B, T, F, Cin] the conv's input
  const float* w;           // [9, Cin, Cout] f32; kOut: K [9, Cout, Cin]
  const float* bias;        // [Cout] (not kOut)
  const float* stats;       // [B, 2, Cout] (mu, rs): kNorm, kSums, kDout
  const double* sums;       // [B, 2, Cout] (S_a, S_b): kDout
  const __nv_bfloat16* dy;  // [B, T, F, Cout]: kSums, kDout
  __nv_bfloat16* out;       // y, dout or dx [B, T, F, Cout]
  double* part;             // [B, tiles, warps, 2, Cout] (kStats, kSums)
                            // or [gridDim.x, Cout] db (kDout)
  float* part_dk;           // [gridDim.x, 9, Cin, Cout] (kDout)
  int B, T_len, F_len, Cin, Cout;
};

// Stage the positions of tile (b, p0), channels ci0 .. ci0 + KC: rows
// q < 2 stride + kSegRows, row q of segment dt (q >= dt stride, the last
// such dt <= 2) being position p0 - F - 1 + q + dt (F - stride) (stride F:
// one stripe, the same position whatever dt). A thread copies one fixed
// 16-byte chunk of every (128 / chunks)-th row.
template <int KC>
__device__ __forceinline__ void stage_x(const TcArgs& a, unsigned char* xs,
                                        const void* zero, int stride, int b,
                                        int p0, int ci0) {
  constexpr int kChunks = KC / 8;
  constexpr int kStep = kTcThreads / kChunks;  // rows a pass of the block
  const long long tf = static_cast<long long>(a.T_len) * a.F_len;
  const int rows = 2 * stride + kSegRows;
  const int c = threadIdx.x % kChunks;
  const bool c_ok = ci0 + 8 * c < a.Cin;
  const __nv_bfloat16* xb =
      a.x + static_cast<long long>(b) * tf * a.Cin + ci0 + 8 * c;
  const long long p_first = static_cast<long long>(p0) - a.F_len - 1;
  const int delta = a.F_len - stride;
  for (int q = threadIdx.x / kChunks; q < rows; q += kStep) {
    const int dt = (q >= stride) + (q >= 2 * stride);
    const long long pg = p_first + q + dt * delta;
    const bool ok = c_ok && pg >= 0 && pg < tf;
    tc::cp_async16(xs + q * KC * 2 + ((c << 4) ^ swz<KC>(q)),
                   ok ? xb + pg * a.Cin : nullptr, zero);
  }
}

// Two f32 values rounded to bf16, as the bits of a pair (lo first).
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage the weights of input channels ci0 .. ci0 + KC and output channels
// co0 .. co0 + NB, rounded to bf16, zero past Cin and Cout: [k][n] from w
// [9, Cin, Cout]; kOut, [n][k] from K [9, Cout, Cin] flipped in (T, F)
// (tap 8 - tap). Each thread moves 8 consecutive channels: two 16-byte
// loads, one 16-byte store.
template <int KC, int NB, int MODE>
__device__ __forceinline__ void stage_w(const TcArgs& a, unsigned char* ws,
                                        int ci0, int co0) {
  using L = TcLayout<KC, NB, MODE>;
  if constexpr (MODE == kOut) {
    // row n = output channel (K's input channel), k = tap * KC + c
    constexpr int kPieces = 9 * KC / 8;
    for (int i = threadIdx.x; i < NB * kPieces; i += kTcThreads) {
      const int piece = i % kPieces;
      const int n = i / kPieces;
      const int tap = piece / (KC / 8);
      const int c = ci0 + 8 * (piece % (KC / 8));
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (co0 + n < a.Cout && c < a.Cin) {
        const float* src =
            a.w + (static_cast<long long>(8 - tap) * a.Cout + co0 + n) *
                      a.Cin + c;
        lo = *reinterpret_cast<const float4*>(src);
        hi = *reinterpret_cast<const float4*>(src + 4);
      }
      uint4 v;
      v.x = bf16x2_bits(lo.x, lo.y);
      v.y = bf16x2_bits(lo.z, lo.w);
      v.z = bf16x2_bits(hi.x, hi.y);
      v.w = bf16x2_bits(hi.z, hi.w);
      *reinterpret_cast<uint4*>(ws + (n * L::kWLd + 8 * piece) * 2) = v;
    }
  } else {
    constexpr int kPieces = NB / 8;
    for (int i = threadIdx.x; i < 9 * KC * kPieces; i += kTcThreads) {
      const int piece = i % kPieces;
      const int k = i / kPieces;
      const int tap = k / KC;
      const int ci = ci0 + k % KC;
      const int co = co0 + 8 * piece;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (ci < a.Cin && co < a.Cout) {
        const float* src =
            a.w + (static_cast<long long>(tap) * a.Cin + ci) * a.Cout + co;
        lo = *reinterpret_cast<const float4*>(src);
        hi = *reinterpret_cast<const float4*>(src + 4);
      }
      uint4 v;
      v.x = bf16x2_bits(lo.x, lo.y);
      v.y = bf16x2_bits(lo.z, lo.w);
      v.z = bf16x2_bits(hi.x, hi.y);
      v.w = bf16x2_bits(hi.z, hi.w);
      *reinterpret_cast<uint4*>(ws + (k * L::kWLd + 8 * piece) * 2) = v;
    }
  }
}

__device__ __forceinline__ void ldsm_x4_addr(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans_addr(uint32_t (&r)[4],
                                                   uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// exp(v) - 1 as the TPU kernel writes it (not expm1), the exponential on
// the SFU: its few units in the last place of f32 vanish in the bf16
// roundings that follow
__device__ __forceinline__ float elu(float v) {
  return v > 0.0f ? v : __expf(v) - 1.0f;
}

__device__ __forceinline__ float rnd_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Sums s[j][e] (channel 8 j + 2 (lane % 4) + e of the slab) over a warp's
// lanes in f64, in an order fixed by the lanes; lanes 0-3 then hold the
// warp's sums of their channels.
template <int NB>
__device__ __forceinline__ void warp_sums(double (&s)[NB / 8][2]) {
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s[j][e] += __shfl_xor_sync(0xffffffffu, s[j][e], off);
      }
    }
  }
}

// The warps' sums (warp_sums) then over the warps in order: out[co0 + n]
// gets the block's sum of channel n. Ends with the block synchronised.
template <int NB>
__device__ __forceinline__ void block_sums(double (&s)[NB / 8][2],
                                           double* red, double* out, int co0,
                                           int Cout) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_sums<NB>(s);
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[warp * NB + 8 * j + 2 * lane + e] = s[j][e];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < NB && co0 + threadIdx.x < Cout) {
    double total = 0.0;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) total += red[w * NB + threadIdx.x];
    out[co0 + threadIdx.x] = total;
  }
  __syncthreads();
}

template <int KC, int NB, int MODE>
__global__ void __launch_bounds__(kTcThreads)
    conv_tc_kernel(const TcArgs a) {
  using L = TcLayout<KC, NB, MODE>;
  constexpr int kJ = NB / 8;  // n8 tiles of the slab
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* ws = tc_smem + L::kW;
  __nv_bfloat16* ds = reinterpret_cast<__nv_bfloat16*>(tc_smem + L::kD);
  double* red = reinterpret_cast<double*>(tc_smem + L::kRed);
  unsigned char* zero = tc_smem + L::kZero;
  const uint32_t xs0_a = tc::smem_addr(tc_smem);
  const uint32_t ws_a = tc::smem_addr(ws);
  const uint32_t zero_a = tc::smem_addr(zero);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int co0 = blockIdx.z * NB;
  const int n_chunks = (a.Cin + KC - 1) / KC;
  const int dk_chunk = blockIdx.y;  // kDout: the input channels of its dK
  const int tps = tc_tiles(a.T_len, a.F_len);
  const int total = a.B * tps;
  const long long tf = static_cast<long long>(a.T_len) * a.F_len;
  const int stride = a.F_len <= kSegRows ? a.F_len : kSegRows;
  if (threadIdx.x < 16) reinterpret_cast<uint32_t*>(zero)[threadIdx.x] = 0u;

  // this thread's output channels: 8 j + 2 (lane % 4) + e of the slab
  float bv[kJ][2];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = co0 + 8 * j + 2 * (lane & 3) + e;
      bv[j][e] = (MODE != kOut && co0 + 8 * j < a.Cout) ? a.bias[co] : 0.0f;
    }
  }
  double db[kJ][2];
  float dk[MODE == kDout ? L::kDkPerWarp : 1][kJ][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j) db[j][0] = db[j][1] = 0.0;
#pragma unroll
  for (int r = 0; r < (MODE == kDout ? L::kDkPerWarp : 1); ++r) {
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) dk[r][j][v] = 0.0f;
    }
  }
  // the B-fragment address of this lane: rows k (or n for kOut) + the
  // 16 x 16 step's offset, which the unrolled loops fold in
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t wb_a =
      MODE == kOut
          ? ws_a + (((lane & 7) + (lane >> 4) * 8) * L::kWLd +
                    ((lane >> 3) & 1) * 8) * 2
          : ws_a + (lrow * L::kWLd + (lane >> 4) * 8) * 2;

  // one chunk of input channels: the next tile's copies go out while this
  // one computes; several: each chunk is copied, then computed
  const bool ring = n_chunks == 1;
  if (ring) {
    stage_w<KC, NB, MODE>(a, ws, 0, co0);
    if (blockIdx.x < total) {
      const int b = blockIdx.x / tps;
      stage_x<KC>(a, tc_smem, zero, stride, b, (blockIdx.x - b * tps) * kM,
                  0);
    }
    tc::cp_async_commit();
  }
  int it = 0;
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x, ++it) {
    const int b = tile / tps;
    const int p0 = (tile - b * tps) * kM;
    const int buf = ring ? (it & 1) : 0;
    const uint32_t xs_a = xs0_a + buf * L::kXBytes;
    unsigned char* xs = tc_smem + buf * L::kXBytes;
    float acc[2][kJ][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;
      }
    }
    // this lane's A rows: m of m16 tile i, at each tap
    uint32_t arow[2][9];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = 32 * warp + 16 * i + lrow;
      const int f = (p0 + m) % a.F_len;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        arow[i][tap] = row_addr<KC>(xs_a, zero_a,
                                    (tap / 3) * stride + m + tap % 3,
                                    tap % 3, f, a.F_len);
      }
    }
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      if (ring) {
        const int next = tile + gridDim.x;
        if (next < total) {
          const int nb = next / tps;
          stage_x<KC>(a, tc_smem + (buf ^ 1) * L::kXBytes, zero, stride, nb,
                      (next - nb * tps) * kM, 0);
        }
        tc::cp_async_commit();
        tc::cp_async_wait<1>();
      } else {
        stage_w<KC, NB, MODE>(a, ws, chunk * KC, co0);
        stage_x<KC>(a, xs, zero, stride, b, p0, chunk * KC);
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
      }
      __syncthreads();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          const uint32_t c16 = (2 * kk + (lane >> 4)) << 4;
          uint32_t af[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) ldsm_x4_addr(af[i], arow[i][tap] ^ c16);
#pragma unroll
          for (int jp = 0; jp < kJ / 2; ++jp) {
            uint32_t r[4];
            if constexpr (MODE == kOut) {
              ldsm_x4_addr(r, wb_a + (16 * jp * L::kWLd + tap * KC + kk * 16) *
                                         2);
            } else {
              ldsm_x4_trans_addr(
                  r, wb_a + ((tap * KC + kk * 16) * L::kWLd + 16 * jp) * 2);
            }
            const uint32_t b0[2] = {r[0], r[1]};
            const uint32_t b1[2] = {r[2], r[3]};
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              tc::mma_bf16(acc[i][2 * jp], af[i], b0);
              tc::mma_bf16(acc[i][2 * jp + 1], af[i], b1);
            }
          }
        }
      }
      if (!ring) __syncthreads();  // before the next chunk's copies
    }

    // ---- the epilogue: element (row m, channel n) of acc[i][j][v] is
    // m = 32 warp + 16 i + lane / 4 + 8 (v / 2), n = 8 j + 2 (lane % 4) +
    // v % 2
    // a thread's sums over its four rows of the tile (f32), then f64
    float s0[kJ][2], s1[kJ][2];
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      s0[j][0] = s0[j][1] = s1[j][0] = s1[j][1] = 0.0f;
    }
    float mu[kJ][2], rs[kJ][2], sa[kJ][2], sb[kJ][2];
    if (MODE == kNorm || MODE == kSums || MODE == kDout) {
      const float n_pos = static_cast<float>(tf);
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = co0 + 8 * j + 2 * (lane & 3) + e;
          const bool ok = co0 + 8 * j < a.Cout;
          const long long base = static_cast<long long>(b) * 2 * a.Cout + co;
          mu[j][e] = ok ? a.stats[base] : 0.0f;
          rs[j][e] = ok ? a.stats[base + a.Cout] : 0.0f;
          if (MODE == kDout) {
            sa[j][e] = ok ? static_cast<float>(a.sums[base]) / n_pos : 0.0f;
            sb[j][e] =
                ok ? static_cast<float>(a.sums[base + a.Cout]) / n_pos : 0.0f;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 32 * warp + 16 * i + (lane >> 2) + 8 * h;
        const long long p = static_cast<long long>(p0) + m;
        const bool row_ok = p < tf;
        const long long row = (static_cast<long long>(b) * tf + p) * a.Cout;
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int n = 8 * j + 2 * (lane & 3);
          const bool ok = row_ok && co0 + 8 * j < a.Cout;
          const float v0 = acc[i][j][2 * h];
          const float v1 = acc[i][j][2 * h + 1];
          if (MODE == kOut) {
            if (ok) {
              *reinterpret_cast<__nv_bfloat162*>(a.out + row + co0 + n) =
                  __floats2bfloat162_rn(v0, v1);
            }
            continue;
          }
          const float e0 = elu(v0 + bv[j][0]);
          const float e1 = elu(v1 + bv[j][1]);
          if (MODE == kStats) {
            if (ok) {
              s0[j][0] += rnd_bf16(e0);
              s0[j][1] += rnd_bf16(e1);
              s1[j][0] += rnd_bf16(e0 * e0);
              s1[j][1] += rnd_bf16(e1 * e1);
            }
          } else if (MODE == kNorm) {
            if (ok) {
              *reinterpret_cast<__nv_bfloat162*>(a.out + row + co0 + n) =
                  __floats2bfloat162_rn((e0 - mu[j][0]) * rs[j][0],
                                        (e1 - mu[j][1]) * rs[j][1]);
            }
          } else {
            float2 g = make_float2(0.0f, 0.0f);
            if (ok) {
              g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  a.dy + row + co0 + n));
            }
            const float h0 = (e0 - mu[j][0]) * rs[j][0];
            const float h1 = (e1 - mu[j][1]) * rs[j][1];
            if (MODE == kSums) {
              if (ok) {
                s0[j][0] += g.x;
                s0[j][1] += g.y;
                s1[j][0] += rnd_bf16(g.x * h0);
                s1[j][1] += rnd_bf16(g.y * h1);
              }
            } else {  // kDout
              const float d0 = rs[j][0] * (g.x - sa[j][0] - h0 * sb[j][0]);
              const float d1 = rs[j][1] * (g.y - sa[j][1] - h1 * sb[j][1]);
              const __nv_bfloat162 o = __floats2bfloat162_rn(
                  ok ? d0 * (e0 > 0.0f ? 1.0f : e0 + 1.0f) : 0.0f,
                  ok ? d1 * (e1 > 0.0f ? 1.0f : e1 + 1.0f) : 0.0f);
              *reinterpret_cast<__nv_bfloat162*>(ds + m * L::kDLd + n) = o;
              if (ok && dk_chunk == 0) {
                *reinterpret_cast<__nv_bfloat162*>(a.out + row + co0 + n) = o;
                const float2 of = __bfloat1622float2(o);
                s0[j][0] += of.x;
                s0[j][1] += of.y;
              }
            }
          }
        }
      }
    }
    if (MODE == kStats || MODE == kSums) {
      // each warp's f64 partial of the tile, [tile][warp][2][Cout]: no
      // barrier; the reduce adds them in order
      double d0[kJ][2], d1[kJ][2];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          d0[j][e] = s0[j][e];
          d1[j][e] = s1[j][e];
        }
      }
      warp_sums<NB>(d0);
      warp_sums<NB>(d1);
      if (lane < 4) {
        double* o = a.part +
                    (static_cast<long long>(tile) * kTcWarps + warp) * 2 *
                        a.Cout + co0;
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          if (co0 + 8 * j < a.Cout) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              o[8 * j + 2 * lane + e] = d0[j][e];
              o[a.Cout + 8 * j + 2 * lane + e] = d1[j][e];
            }
          }
        }
      }
    }
    if (MODE == kDout) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        db[j][0] += s0[j][0];
        db[j][1] += s0[j][1];
      }
      if (dk_chunk != n_chunks - 1) {
        // the conv left the last chunk's positions; dK wants its own
        __syncthreads();
        stage_x<KC>(a, xs, zero, stride, b, p0, dk_chunk * KC);
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
      }
      __syncthreads();  // dout staged
      // dK[k, n] += sum over the tile's positions m of X[m, k] dout[m, n],
      // k = tap * KC + channel: A = X^T by ldmatrix.trans of the position
      // rows, B = dout [m][n]
#pragma unroll
      for (int m0 = 0; m0 < kM; m0 += 16) {
        uint32_t bf[kJ][2];
#pragma unroll
        for (int jp = 0; jp < kJ / 2; ++jp) {
          uint32_t r[4];
          ldsm_x4_trans_addr(
              r, tc::smem_addr(ds + (m0 + lrow) * L::kDLd + 16 * jp +
                               (lane >> 4) * 8));
          bf[2 * jp][0] = r[0];
          bf[2 * jp][1] = r[1];
          bf[2 * jp + 1][0] = r[2];
          bf[2 * jp + 1][1] = r[3];
        }
        // lane's position row and channel chunk of the .trans A load
        const int m = m0 + (lane & 7) + (lane >> 4) * 8;
        const int f = (p0 + m) % a.F_len;
        const uint32_t c16 = ((lane >> 3) & 1) << 4;
#pragma unroll
        for (int r = 0; r < L::kDkPerWarp; ++r) {
          const int t16 = warp + kTcWarps * r;
          if (t16 < L::kDkTiles) {
            const int tap = t16 / (KC / 16);
            const int kk = t16 % (KC / 16);
            uint32_t af[4];
            ldsm_x4_trans_addr(
                af, row_addr<KC>(xs_a, zero_a,
                                 (tap / 3) * stride + m + tap % 3, tap % 3,
                                 f, a.F_len) ^
                        (c16 | (kk << 5)));
#pragma unroll
            for (int j = 0; j < kJ; ++j) tc::mma_bf16(dk[r][j], af, bf[j]);
          }
        }
      }
    }
    __syncthreads();  // before the next tile's copies
  }
  if (ring) tc::cp_async_wait<0>();  // no copy outlives the block

  if (MODE == kDout) {
    // dK partial [9, Cin, Cout] of this block, its chunk and slab
    float* pk = a.part_dk + static_cast<long long>(blockIdx.x) * 9 *
                                a.Cin * a.Cout;
#pragma unroll
    for (int r = 0; r < L::kDkPerWarp; ++r) {
      const int t16 = warp + kTcWarps * r;
      if (t16 >= L::kDkTiles) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 16 * t16 + (lane >> 2) + 8 * h;
        const int tap = k / KC;
        const int ci = dk_chunk * KC + k % KC;
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int co = co0 + 8 * j + 2 * (lane & 3);
          if (ci < a.Cin && co0 + 8 * j < a.Cout) {
            *reinterpret_cast<float2*>(
                pk + (static_cast<long long>(tap) * a.Cin + ci) * a.Cout +
                co) = make_float2(dk[r][j][2 * h], dk[r][j][2 * h + 1]);
          }
        }
      }
    }
    if (dk_chunk == 0) {
      block_sums<NB>(db, red,
                     a.part + static_cast<long long>(blockIdx.x) * a.Cout,
                     co0, a.Cout);
    }
  }
}

template <int KC, int NB, int MODE>
struct TcKernel {
  using L = TcLayout<KC, NB, MODE>;

  // Blocks of this kernel the card runs at once, queried once per device.
  // The opt-in to its shared memory is set on every call: a static of a
  // template is one object in the whole process, shared by every library
  // that instantiates it, so "done once" would not hold for each library's
  // own copy of the kernel.
  static int slots() {
    static int cached[64] = {0};
    auto kernel = conv_tc_kernel<KC, NB, MODE>;
    int dev = 0;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::kSmem)) != cudaSuccess ||
        cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) {
      return 0;
    }
    if (cached[dev] == 0) {
      int per_sm = 0, sms = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, kernel, kTcThreads, L::kSmem) != cudaSuccess ||
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 dev) != cudaSuccess) {
        return 0;
      }
      cached[dev] = per_sm * sms;
    }
    return cached[dev];
  }

  // grid_x 0: one wave of blocks (at most one a tile) over (chunks, slabs)
  static cudaError_t launch(const TcArgs& a, int grid_x, cudaStream_t s) {
    const int chunks = MODE == kDout ? (a.Cin + KC - 1) / KC : 1;
    const int slabs = (a.Cout + NB - 1) / NB;
    const int wave = slots();  // also opts the kernel in to its smem
    if (wave <= 0) return cudaErrorInvalidConfiguration;
    if (grid_x <= 0) {
      const int total = a.B * tc_tiles(a.T_len, a.F_len);
      grid_x = max(1, min(total, wave / (chunks * slabs)));
    }
    conv_tc_kernel<KC, NB, MODE>
        <<<dim3(grid_x, chunks, slabs), kTcThreads, L::kSmem, s>>>(a);
    return cudaGetLastError();
  }
};

// The kernel for MODE at Cin input and Cout output channels.
template <int MODE>
cudaError_t launch_tc(const TcArgs& a, int grid_x, cudaStream_t s) {
  const int kc = tc_kc(a.Cin);
  const int nb = tc_nb(a.Cout);
  if (kc == 16 && nb == 16) return TcKernel<16, 16, MODE>::launch(a, grid_x, s);
  if (kc == 16) return TcKernel<16, 32, MODE>::launch(a, grid_x, s);
  if (nb == 16) return TcKernel<32, 16, MODE>::launch(a, grid_x, s);
  return TcKernel<32, 32, MODE>::launch(a, grid_x, s);
}

template <int MODE>
int tc_slots(int cin, int cout) {
  const int kc = tc_kc(cin);
  const int nb = tc_nb(cout);
  if (kc == 16 && nb == 16) return TcKernel<16, 16, MODE>::slots();
  if (kc == 16) return TcKernel<16, 32, MODE>::slots();
  if (nb == 16) return TcKernel<32, 16, MODE>::slots();
  return TcKernel<32, 32, MODE>::slots();
}

// The partials part[b][i][which][c] (f64; i over a sample's tiles and
// their warps) summed per sample in an order fixed by the shapes: 128
// slices each add every 128th partial in order, then the slices are added
// in order. A block takes 8 channels of one sample. `stats` non-null: the
// instance-norm statistics as f32, stats[b][0][c] = mu = sum0 / n,
// stats[b][1][c] = 1 / sqrt(max(sum1 / n - mu^2, 0) + eps); else the two
// sums as f64 into sums[b][which][c].
constexpr int kRedSlices = 128;
constexpr int kRedCols = 8;
__global__ void __launch_bounds__(kRedSlices * kRedCols)
    conv_reduce64_kernel(const double* __restrict__ part,
                         float* __restrict__ stats, double* __restrict__ sums,
                         int n_part, int Co, double n, float eps) {
  __shared__ double red[kRedSlices][2][kRedCols];
  const int b = blockIdx.y;
  const int col = threadIdx.x % kRedCols, slice = threadIdx.x / kRedCols;
  const int c = blockIdx.x * kRedCols + col;
  double s0 = 0.0, s1 = 0.0;
  if (c < Co) {
    const double* p = part + static_cast<long long>(b) * n_part * 2 * Co + c;
#pragma unroll 4
    for (int i = slice; i < n_part; i += kRedSlices) {
      s0 += p[static_cast<long long>(2 * i) * Co];
      s1 += p[static_cast<long long>(2 * i + 1) * Co];
    }
  }
  red[slice][0][col] = s0;
  red[slice][1][col] = s1;
  __syncthreads();
  if (slice != 0 || c >= Co) return;
  for (int sl = 1; sl < kRedSlices; ++sl) {
    s0 += red[sl][0][col];
    s1 += red[sl][1][col];
  }
  const long long o = static_cast<long long>(b) * 2 * Co + c;
  if (stats == nullptr) {
    sums[o] = s0;
    sums[o + Co] = s1;
    return;
  }
  const double mu = s0 / n;
  const double var = fmax(s1 / n - mu * mu, 0.0);
  stats[o] = static_cast<float>(mu);
  stats[o + Co] =
      static_cast<float>(1.0 / sqrt(var + static_cast<double>(eps)));
}

inline cudaError_t reduce64(const double* part, float* stats, double* sums,
                            int B, int n_part, int Co, double n, float eps,
                            cudaStream_t stream) {
  conv_reduce64_kernel<<<dim3((Co + kRedCols - 1) / kRedCols, B),
                         kRedSlices * kRedCols, 0, stream>>>(
      part, stats, sums, n_part, Co, n, eps);
  return cudaGetLastError();
}

}  // namespace conv2d
