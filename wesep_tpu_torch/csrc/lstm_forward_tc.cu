// The bf16 forward of the four LSTM layers, redesigned for Hopper (sm_90a):
// the input projection of every step as one tensor-core product, and a
// recurrence that keeps only h_{t-1} @ Wh on its chain, with Wh held in
// shared memory over a thread-block cluster.
//
// Replaces, for bf16 streams whose shapes pass the route gate of
// wesep_tpu_torch/ops/cuda_lstm_tc.py (`forward_fits`), the forward of four
// Pallas TPU kernels of wesep_tpu/ops/pallas_lstm.py: `_bi_layer_forward`
// (of `bilstm_layer`), `_bi_unfold_forward` (of `bilstm_layer_unfold`),
// `_bi_forward` (of `bilstm_fused`) and `_forward` (of `lstm_fused`). f32
// streams take the FMA forward of lstm_forward_f32.cu (f32 is the serving
// path; TF32 tensor cores would change its result), and shapes both gates
// refuse `bilstm_fwd_kernel` of bilstm_common.cuh.
//
// A step of the forward (per direction, in its walk's order):
//   g   = (x_t @ Wx + b) + h_{t-1} @ Wh    in f32, h_{t-1} rounded to bf16
//   c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(g);  h_t = sigmoid(o) tanh(c_t)
// Only h_{t-1} @ Wh depends on the previous step. So two launches:
//
// 1. `lstm_tc_project` (the layers that project x, K0 and K3): xw[dir] =
//    A @ Wx[dir] + b for every step at once, f32, not activated (kProject of
//    tc_product_kernel in lstm_tc.cuh), A the rows of x in place or the
//    k-major frames of unfold(ks, hs) (the wrapper permutes Wx as for the
//    backward). xw is 2 * B * T * 4H f32 scratch, 1.58 GB at the pBSRNN's
//    training band shape, alive until the chain has run, and it is written
//    in the chain's order (ChainXw): each thread of the chain finds its
//    step's 64 values in 16 pieces of 16 bytes, each piece of a warp 512
//    contiguous bytes (the layers' [B, T, 4H] order gave 8 rows, 8 cache
//    lines, to every load of a warp). The two-kernel layers (K1, K2) receive
//    xw already projected and rounded to bf16, in their own order.
// 2. `lstm_tc_forward`, the recurrence over thread-block clusters of 4
//    blocks over 64 batch rows of one direction (`lstm_forward_chain_kernel`).
//    Block r owns hidden units [r H/4, (r+1) H/4) and all four gate columns
//    of each, and holds Wh[:, own columns] (H x H bf16, 132 KB at H = 256),
//    h_{t-1} of all rows and units at two parities (2 x 33 KB) and its slice
//    of c_t (16 KB) in shared memory: 214 KB of the 227. A step: wait for
//    the peers' slices of h_{t-1}; the block's [64, H] gate columns of
//    h_{t-1} @ Wh on the tensor cores (mma.sync, ldmatrix; a warp owns 8
//    units and all four of their gates, so the cell update needs no
//    exchange); xw added in f32, the activations and c in registers; h_t
//    rounded to bf16 into the block's own h buffer of the next parity and
//    c_t into its slice; one block barrier; the slice of h_t pushed 16 bytes
//    at a time into the same place of the three peers' buffers (st.async
//    into distributed shared memory, each store counting its bytes on the
//    peer's mbarrier of that parity); y and cs stored 16 bytes at a time
//    (cs only when a backward follows); the next step's xw loaded into
//    registers. No cluster barrier: a block waits only for the bytes it
//    receives, and a peer can write a parity of a block's h only after its
//    own product of the step, which needs that block's h of the step before
//    (sent after the block's product): so the double buffer is never
//    overwritten while it is read.
//
// Rows per cluster. One block fits an SM, and clusters of 4 must lie in one
// GPC, so the card runs a fixed number of clusters at once
// (`lstm_tc_forward_clusters`, cudaOccupancyMaxActiveClusters; about 28 on
// an H100 SXM for the adjoint chain's 213 KB blocks). 64 rows put the band
// shape (2 directions x 512 rows: 16 clusters) in one wave and the comm
// shape (2 x 6016 rows: 188 clusters) in 7; 32 rows would take 2 and 14
// waves. A step costs more with more rows (the product and the cell update
// grow with them), but the exchange's latency does not.
//
// What bounds them on this card (989 TFLOP/s bf16, 3.35 TB/s), at the
// pBSRNN's training band shape (B' 512, T 376, D 128, H 256, both
// directions). The forward's own function (what the Pallas kernel computes,
// from x and the weights to y and cs) is 3.03e11 operations (0.31 ms) and
// ~0.64 GB (0.19 ms): 0.31 ms. The split adds xw, 1.58 GB written by the
// projection and read back by the chain (0.94 ms of traffic), the price of
// taking the projection off the chain. The chain is bound by its 376
// dependent steps, each a [64, 256] x [256, 256] product per block, the
// cell update of 64 x 64 items and the exchange's round trip between SMs
// (tools/lstm_chain_phases.py builds this file with -DLSTM_CHAIN_PHASES to
// count the cycles of each part).

#include "lstm_tc.cuh"

using namespace lstm_tc;

// Plain C entry points, bound with ctypes by
// wesep_tpu_torch/ops/cuda_lstm_tc.py. Tensors contiguous; each returns the
// CUDA error code of its launch (0 on success) and never synchronises.

// xw = A @ Wx + b per direction, f32, in the chain's order (ChainXw of
// lstm_tc.cuh: dirs * ceil(B / 64) * T * 64 * 4H values). x bf16 as `kind`
// says (0: rows of x [B, T, D]; 1: frames of unfold(D / C, hs) over x [B,
// L, C], k-major); wx_* [D, 4H] bf16 (k-major rows for kind 1), b_* [4H]
// f32; the _b operands null when dirs is 1. D, H and (kind 1) C multiples
// of 8, B * T <= 65535 * 128.
extern "C" int lstm_tc_project(const void* x, const void* wx_f,
                               const void* wx_b, const void* b_f,
                               const void* b_b, void* xw, int kind, int B,
                               int T, int D, int L, int C, int hs, int H,
                               int dirs, void* stream) {
  Rows rows;
  if ((kind != kRowX && kind != kRowUnfold) || dirs < 1 || dirs > 2 ||
      B <= 0 || T <= 0 || D <= 0 || H <= 0 || D % 8 != 0 || H % 8 != 0 ||
      static_cast<long long>(B) * T >= (1LL << 31) ||
      static_cast<long long>(B) * T > 65535LL * kBM ||
      (dirs == 2) != (wx_b != nullptr && b_b != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kind == kRowUnfold &&
      (C <= 0 || C % 8 != 0 || D % C != 0 || hs <= 0 || L < D / C ||
       (L - D / C) / hs + 1 != T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rows = Rows{D, H, T, L, C, hs, dirs, 0, static_cast<int>(B * T)};
  Operands op{static_cast<const bf16*>(x),
              static_cast<const bf16*>(x),
              nullptr,
              {static_cast<const bf16*>(wx_f), static_cast<const bf16*>(wx_b)},
              {nullptr, nullptr},
              xw,
              0,
              {static_cast<const float*>(b_f), static_cast<const float*>(b_b)},
              nullptr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      kind == kRowX ? launch_product<kProject, kRowX>(rows, op, 1, s)
                    : launch_product<kProject, kRowUnfold>(rows, op, 1, s));
}

namespace {

template <typename XW>
cudaError_t forward_chain(const void* xw, const void* wh_f, const void* wh_b,
                          void* y, void* cs, int B, int T, int H, int dirs,
                          int reverse, cudaStream_t s) {
  const FwdArgs<XW> a{static_cast<const XW*>(xw),
                      {static_cast<const bf16*>(wh_f),
                       static_cast<const bf16*>(wh_b)},
                      static_cast<bf16*>(y),
                      static_cast<float*>(cs),
                      B,
                      T,
                      dirs,
                      reverse};
  switch (H / 32) {
    case 2: return launch_forward_chain_nt<2, XW>(a, s);
    case 4: return launch_forward_chain_nt<4, XW>(a, s);
    case 6: return launch_forward_chain_nt<6, XW>(a, s);
    case 8: return launch_forward_chain_nt<8, XW>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The recurrence. xw f32 in the chain's order (xw_dtype 0: from
// lstm_tc_project) or bf16 [dirs, B, T, 4H] (1: the two-kernel layers'
// projection); wh_*
// [H, 4H] bf16 (wh_b null when dirs is 1). Writes y [B, T, dirs * H] bf16
// and, unless cs is null, cs [B, T, dirs * H] f32. H is 64, 128, 192 or
// 256; dirs and reverse as the layer walks (the bidirectional layers: 2,
// 0).
extern "C" int lstm_tc_forward(const void* xw, const void* wh_f,
                               const void* wh_b, void* y, void* cs, int B,
                               int T, int H, int dirs, int reverse,
                               int xw_dtype, void* stream) {
  if (B <= 0 || T <= 0 || H % 64 != 0 || H < 64 || H > 256 || dirs < 1 ||
      dirs > 2 || reverse < 0 || reverse > 1 || (dirs == 2 && reverse) ||
      (dirs == 2) != (wh_b != nullptr) || xw_dtype < 0 || xw_dtype > 1 ||
      (B + kFwdRows - 1) / kFwdRows * kCluster > 2147483647 / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      xw_dtype == 0
          ? forward_chain<float>(xw, wh_f, wh_b, y, cs, B, T, H, dirs,
                                 reverse, s)
          : forward_chain<bf16>(xw, wh_f, wh_b, y, cs, B, T, H, dirs,
                                reverse, s));
}

// out[0] = how many clusters of the recurrence at hidden size H the card
// runs at once.
extern "C" int lstm_tc_forward_clusters(void* out, int H, void* stream) {
  (void)stream;
  int* n = static_cast<int*>(out);
  switch (H / 32) {
    case 2: return static_cast<int>(forward_chain_clusters_nt<2>(n));
    case 4: return static_cast<int>(forward_chain_clusters_nt<4>(n));
    case 6: return static_cast<int>(forward_chain_clusters_nt<6>(n));
    case 8: return static_cast<int>(forward_chain_clusters_nt<8>(n));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef LSTM_CHAIN_PHASES
// The forward chain's phase cycles (lstm_tc.cuh, LSTM_CHAIN_PHASES): 256
// values.
extern "C" int lstm_tc_read_phase_cycles(long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles)));
}
#endif
