// The bf16 backward of the four LSTM layers, redesigned for Hopper
// (sm_90a): tensor cores for every product, and a serial adjoint that keeps
// only the carry's product on its chain.
//
// Replaces, for bf16 streams whose shapes pass the route gate of
// wesep_tpu_torch/ops/cuda_lstm_tc.py, the backward of four Pallas TPU
// kernels of wesep_tpu/ops/pallas_lstm.py: `_bi_layer_backward` (the
// custom VJP of `bilstm_layer`), `_bi_unfold_backward` (of
// `bilstm_layer_unfold`), `_bi_backward` (of `bilstm_fused`) and
// `_bwd_impl` (of `lstm_fused`). The f32 backward, and a shape the gate
// refuses, keep the kernels of bilstm_backward.cuh unchanged (f32 is the
// path of the gradient checks; TF32 tensor cores would change its result).
//
// The adjoint of step t (per direction, walking the forward's steps back):
//   g      = x_t @ Wx + h_{t-1} @ Wh + b     (or xw_t + h_{t-1} @ Wh)
//   dgates = f(g, c_t, c_{t-1}, dy_t + dh, dc) in f32, rounded to bf16: dg
//   dh     = dg @ Wh^T                       (the only carried product)
//   dx_t   = dg @ Wx^T;  dW += [x_t ; h_{t-1}]^T @ dg;  db += sum(dgates)
// Of these only dh depends on the previous adjoint step: g reads x and the
// saved y, dx_t and dW read dg. So four launches do it:
//
// 1. `lstm_tc_gates`: G = [x ; h_{t-1}] @ [Wx ; Wh] + b (or h_{t-1} @ Wh +
//    xw) for every step at once, f32 (the tensor-core product of
//    lstm_tc.cuh, kGates), stored as the gates' activations (sigmoid i, f,
//    o; tanh g: the serial kernel's formulas, which need no carry). G is
//    2 * B * T * 4H f32 scratch: 1.58 GB at the pBSRNN's training band
//    shape, alive until the chain has run.
// 2. `lstm_tc_chain`, the serial adjoint over thread-block clusters. A
//    cluster of 4 blocks takes 32 batch rows of one direction; block r owns
//    hidden units [r H/4, (r+1) H/4) and their 4 gate columns (H: 256 at
//    H = 256, 192 at H = 192) and holds Wh[:, own columns] in shared memory
//    for the whole time loop. A step: the dgates of the block's units
//    elementwise in registers from the stored gates (the rounding points of
//    bilstm_bwd_kernel: db from the unrounded ones), rounded dg to shared
//    memory and to the dg stream; the block's partial dh = dg_own @
//    Wh[:, own]^T [32, H] on the tensor cores (mma.sync, ldmatrix); a
//    reduce-scatter through distributed shared memory: each block writes
//    the partial of unit u into slot r of the owner's buffer, and after the
//    step's one cluster barrier sums its 4 slots in rank order. The barrier
//    is split (arrive, then the next step's loads of G, c and dy into
//    registers, then wait: the loads are unconditional and their values
//    first used after the wait, so no load waits on the chain), and the
//    exchange buffer is double, so one barrier a step is enough. Per block
//    at H = 256: Wh slice 256 x (256 + 8 pad) bf16 = 132 KB, dg tile 32 x
//    264 bf16 = 16.5 KB, exchange 2 x 4 x 32 x 64 f32 = 64 KB: 213 of the
//    227 KB (H = 192: 136 KB); 8 rows a block keep 8 items (a row and a
//    unit) a thread. One block fits an SM, and about 28 clusters of 4 run
//    at once (clusters of 8 over 64 rows: 14), so the pBSRNN band shape
//    (B' 512, 2 directions: 32 clusters) takes two waves and the comm shape
//    (B' 6016: 376 clusters) about 14.
// 3. `lstm_tc_dx` (K0 and K3 only): dx = dg @ Wx^T per direction, rounded
//    to bf16 (kDx); the wrapper adds the two directions in bf16. The K1/K2
//    layers form dx outside their kernels, as the JAX package does.
// 4. `lstm_tc_wgrad`: dW = [x ; h_{t-1}]^T @ dg per direction (kWgrad), one
//    partial per slice of the B * T rows, added by the wrapper in a fixed
//    order: the same bits from run to run. Every product of two bf16 values
//    is exact in f32, so only the order of the f32 sums differs from the
//    FMA kernel's.
//
// What bounds them on this card (989 TFLOP/s bf16, 3.35 TB/s), at the
// pBSRNN's training band shape (B' 512, T 376, D 128, H 256, both
// directions). The adjoint's own function (what the Pallas kernel
// computes: gate recompute, dh and dx from x, y, cs, dy and the weights,
// writing dg, dx and db) is 6.1e11 operations (0.61 ms) and ~1.7 GB
// (0.51 ms): 0.61 ms. The split adds G, 1.58 GB written by the gates and
// read back by the chain (0.94 ms of traffic no single kernel would move),
// which is the price of taking the gate product off the chain. Per kernel:
// gates and dW 3.0e11 operations each (0.31 ms), bytes 0.54 ms for the
// gates and 0.31 ms for dW; the chain moves G, cs, dy and dg (~3 GB,
// 0.88 ms) but is bound by its 376 dependent steps, each a [32, 256] x
// [256, 256] product per block, an exchange and a cluster barrier: ~10.8 k
// cycles, ~5.5 us at 1.98 GHz, on an H100 (tools/lstm_chain_phases.py
// builds this file with -DLSTM_CHAIN_PHASES to count them), where the FMA
// kernel it replaces waited ~111 us a step on reads of every weight from
// L2. The products run on mma.sync at 25-40% of the bf16 peak: their
// copies are addressed from per-thread row cursors (no division a copy).

#include "lstm_tc.cuh"

using namespace lstm_tc;

namespace {

// The rows of A = [x ; h_{t-1}]: kind 0 rows of x [B, T, D]; kind 1 frames
// of unfold(D / C, hs) over x [B, L, C] (k-major); kind 2 h alone (D 0).
bool make_rows(int kind, int B, int T, int D, int L, int C, int hs, int H,
               int dirs, int reverse, Rows* g) {
  if (B <= 0 || T <= 0 || D < 0 || H <= 0 || D % 8 != 0 || H % 8 != 0 ||
      dirs < 1 || dirs > 2 || reverse < 0 || reverse > 1 ||
      (dirs == 2 && reverse) ||
      static_cast<long long>(B) * T >= (1LL << 31) ||
      static_cast<long long>(B) * T > 65535LL * kBM) {
    return false;
  }
  if (kind == kRowX) {
    if (D == 0) return false;
  } else if (kind == kRowUnfold) {
    if (C <= 0 || C % 8 != 0 || D == 0 || D % C != 0 || hs <= 0 ||
        L < D / C || (L - D / C) / hs + 1 != T) {
      return false;
    }
  } else if (kind == kRowH) {
    if (D != 0) return false;
  } else {
    return false;
  }
  *g = Rows{D, H, T, L, C, hs, dirs, reverse, static_cast<int>(B * T)};
  return true;
}

template <int kMode>
cudaError_t product(int kind, const Rows& g, const Operands& op, int splits,
                    cudaStream_t s) {
  if (kind == kRowX) return launch_product<kMode, kRowX>(g, op, splits, s);
  if (kind == kRowUnfold) {
    return launch_product<kMode, kRowUnfold>(g, op, splits, s);
  }
  return launch_product<kMode, kRowH>(g, op, splits, s);
}

}  // namespace

// Plain C entry points, bound with ctypes by
// wesep_tpu_torch/ops/cuda_lstm_tc.py. bf16 tensors, contiguous; D, H and
// (kind 1) C multiples of 8, B * T <= 65535 * 128. dirs and reverse as the
// forward was launched (the bidirectional layers: 2, 0). Each returns the
// CUDA error code of its launch (0 on success) and never synchronises.

// G [dirs, B * T, 4H] f32 = act([x ; h_{t-1}] @ [Wx ; Wh] + (b or xw)) per
// direction: sigmoid of the i, f, o columns, tanh of the g ones. x as
// `kind` says (null for kind 2), y [B, T, dirs * H]; wx_* [D, 4H] (k-major
// rows for kind 1; null for kind 2) and wh_* [H, 4H];
// b_* [4H] f32 (the projecting layers) or xw [dirs, B, T, 4H] bf16 (the
// two-kernel layers; b_* null). The _b operands are null when dirs is 1.
extern "C" int lstm_tc_gates(const void* x, const void* y, const void* wx_f,
                             const void* wh_f, const void* wx_b,
                             const void* wh_b, const void* b_f,
                             const void* b_b, const void* xw, void* g,
                             int kind, int B, int T, int D, int L, int C,
                             int hs, int H, int dirs, int reverse,
                             void* stream) {
  Rows rows;
  if (!make_rows(kind, B, T, D, L, C, hs, H, dirs, reverse, &rows) ||
      (xw == nullptr) == (b_f == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Operands op{static_cast<const bf16*>(x),
              static_cast<const bf16*>(y),
              nullptr,
              {static_cast<const bf16*>(wx_f), static_cast<const bf16*>(wx_b)},
              {static_cast<const bf16*>(wh_f), static_cast<const bf16*>(wh_b)},
              g,
              0,
              {static_cast<const float*>(b_f), static_cast<const float*>(b_b)},
              static_cast<const bf16*>(xw)};
  return static_cast<int>(
      product<kGates>(kind, rows, op, 1, static_cast<cudaStream_t>(stream)));
}

// The serial adjoint. g from lstm_tc_gates; wh_* [H, 4H] (wh_b null when
// dirs is 1); cs [B, T, dirs * H] f32 and dy [B, T, dirs * H] bf16. Writes
// dg [dirs, B, T, 4H] bf16 and db_part [ceil(B / kChainRows), dirs, 4H]
// f32. H is 64, 128, 192 or 256.
extern "C" int lstm_tc_chain(const void* g, const void* wh_f,
                             const void* wh_b, const void* cs, const void* dy,
                             void* dg, void* db_part, int B, int T, int H,
                             int dirs, int reverse, void* stream) {
  if (B <= 0 || T <= 0 || H % 64 != 0 || H < 64 || H > 256 || dirs < 1 ||
      dirs > 2 || reverse < 0 || reverse > 1 || (dirs == 2 && reverse) ||
      (B + kChainRows - 1) / kChainRows * kCluster > 2147483647 / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ChainArgs a{static_cast<const float*>(g),
                    {static_cast<const bf16*>(wh_f),
                     static_cast<const bf16*>(wh_b)},
                    static_cast<const float*>(cs),
                    static_cast<const bf16*>(dy),
                    static_cast<bf16*>(dg),
                    static_cast<float*>(db_part),
                    B,
                    T,
                    dirs,
                    reverse};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (H / 32) {
    case 2: err = launch_chain_nt<2>(a, s); break;
    case 4: err = launch_chain_nt<4>(a, s); break;
    case 6: err = launch_chain_nt<6>(a, s); break;
    case 8: err = launch_chain_nt<8>(a, s); break;
    default: break;
  }
  return static_cast<int>(err);
}

// dx2 [dirs, rows, D] bf16 = dg @ Wx^T per direction; dg [dirs, rows, 4H],
// wx_* [D, 4H] (the _b one null when dirs is 1).
extern "C" int lstm_tc_dx(const void* dg, const void* wx_f, const void* wx_b,
                          void* dx2, int rows, int D, int H, int dirs,
                          void* stream) {
  Rows g;
  if (!make_rows(kRowX, rows, 1, D, 0, 0, 0, H, dirs, 0, &g) ||
      (dirs == 2) != (wx_b != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Operands op{nullptr,
              static_cast<const bf16*>(dg),
              static_cast<const bf16*>(dg),
              {static_cast<const bf16*>(wx_f), static_cast<const bf16*>(wx_b)},
              {nullptr, nullptr},
              dx2,
              0,
              {nullptr, nullptr},
              nullptr};
  return static_cast<int>(launch_product<kDx, kRowX>(
      g, op, 1, static_cast<cudaStream_t>(stream)));
}

// dw_part [splits, dirs, D + H, 4H] f32: for each slice of rows_per_split
// (a multiple of 64) of the B * T rows and each direction, [x ; h_{t-1}]^T
// @ dg; rows :D are dWx (k-major for kind 1), rows D: dWh. x, y as for
// lstm_tc_gates, dg [dirs, B, T, 4H].
extern "C" int lstm_tc_wgrad(const void* x, const void* y, const void* dg,
                             void* dw_part, int kind, int B, int T, int D,
                             int L, int C, int hs, int H, int dirs,
                             int reverse, int rows_per_split, void* stream) {
  Rows g;
  if (!make_rows(kind, B, T, D, L, C, hs, H, dirs, reverse, &g) ||
      rows_per_split <= 0 || rows_per_split % kBK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int splits = (g.rows + rows_per_split - 1) / rows_per_split;
  if (splits * dirs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Operands op{static_cast<const bf16*>(x),
              static_cast<const bf16*>(y),
              static_cast<const bf16*>(dg),
              {nullptr, nullptr},
              {nullptr, nullptr},
              dw_part,
              rows_per_split,
              {nullptr, nullptr},
              nullptr};
  return static_cast<int>(product<kWgrad>(kind, g, op, splits,
                                          static_cast<cudaStream_t>(stream)));
}

#ifdef LSTM_CHAIN_PHASES
// The chain's phase cycles (lstm_tc.cuh, LSTM_CHAIN_PHASES): 256 values.
extern "C" int lstm_tc_read_phase_cycles(long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles)));
}
#endif
