"""Unfold-fused bidirectional LSTM layer: CUDA kernel wrappers and plain
versions.

Counterpart of wesep_tpu/ops/pallas_lstm.py `bilstm_layer_unfold`, forward
and backward: unfold(ks, hs) of a raw [B, L, C] stream into frames of ks
rows (T' = (L - ks) // hs + 1 of them, channel-major, `unfold_frames`) and
the fused BiLSTM layer over them, without materialising the frames on the
card. The kernels live in csrc/bilstm_unfold.cu (forward) and
csrc/bilstm_unfold_bwd.cu (the serial adjoint and the weight-gradient
product); they are the kernels of ops/cuda_lstm.py with another source of a
step's input row, and their headers say what bounds them.

`bilstm_layer_unfold` is a `torch.autograd.Function` on both devices. On
CUDA tensors its forward launches the forward kernel and its backward the
two backward kernels (for a bf16 stream whose shapes
`cuda_lstm_tc.forward_fits` and `backward_fits` take, the tensor-core
forward and backward of ops/cuda_lstm_tc.py instead; for an f32 stream
whose shapes `cuda_lstm_f32.f32_forward_fits` takes, the forward of
ops/cuda_lstm_f32.py), then adds the two
directions' frame cotangents and folds them back onto x's rows
(`fold_frames`); on CPU tensors it runs the
plain versions `bilstm_layer_unfold_reference` and
`bilstm_layer_unfold_backward_reference`: `unfold_frames`, the plain layer
of ops/cuda_lstm.py and `fold_frames`, with the kernels' rounding points.
There is no fallback from a failed build or launch. Every wrapper counts
its launches: `bilstm_layer_unfold.launches`,
`bilstm_layer_unfold_backward.launches`,
`bilstm_layer_unfold_wgrad.launches`.
"""

import torch
from torch.autograd.function import once_differentiable

from wesep_tpu_torch.ops.cuda_lstm import (
    _DTYPE_CODES,
    _TILE,
    _WGRAD_MAX_SPLITS,
    _WGRAD_SPLIT_ROWS,
    _check,
    _entry,
    _kernel_args,
    _launch,
    _on_kernel_path,
    bilstm_layer_backward_reference,
    bilstm_layer_reference,
    bilstm_layer_wgrad_reference,
)
from wesep_tpu_torch.ops.cuda_lstm import kernel_fits as layer_kernel_fits

__all__ = ["kernel_fits", "unfold_frames", "fold_frames",
           "bilstm_layer_unfold",
           "bilstm_layer_unfold_reference", "bilstm_layer_unfold_backward",
           "bilstm_layer_unfold_backward_reference",
           "bilstm_layer_unfold_wgrad", "bilstm_layer_unfold_wgrad_reference",
           "BiLSTMUnfoldFn"]


def kernel_fits(shape, ks: int, hs: int, hidden: int) -> bool:
    """Whether the kernels take unfold(ks, hs) of a [B, L, C] stream into
    `hidden` units: at least one frame, frames of ks * C % 4 == 0 inputs
    (the plain layer's limits on D and H) and B * T' < 2^31 rows."""
    batch, length, c = shape
    if ks < 1 or hs < 1 or length < ks:
        return False
    frames = (length - ks) // hs + 1
    return layer_kernel_fits(ks * c, hidden) and batch * frames < 2 ** 31


def _frames(length: int, ks: int, hs: int) -> int:
    if ks < 1 or hs < 1 or length < ks:
        raise ValueError(f"unfold({ks}, {hs}) needs L >= ks >= 1 and hs >= 1, "
                         f"got L={length}")
    return (length - ks) // hs + 1


def unfold_frames(x, ks: int, hs: int):
    """[B, L, C] -> [B, T', C * ks] sliding frames in torch F.unfold
    channel-major order (element c * ks + k of frame t is x[:, t*hs + k, c]),
    T' = (L - ks) // hs + 1."""
    b, length, c = x.shape
    n = _frames(length, ks, hs)
    return x.unfold(1, ks, hs).reshape(b, n, c * ks)  # [B, T', C, ks]


def fold_frames(du, ks: int, hs: int, length: int):
    """Adjoint of `unfold_frames`: [B, T', C * ks] -> [B, L, C], adding tap
    k of every frame onto row t * hs + k, in tap order and in du's dtype
    (the JAX package's `_fold_dxu`); rows in no frame get zero."""
    b, n, kc = du.shape
    taps = du.reshape(b, n, kc // ks, ks)
    dx = du.new_zeros(b, length, kc // ks)
    for k in range(ks):
        dx[:, k:k + hs * n:hs] += taps[..., k]
    return dx


def bilstm_layer_unfold_reference(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b,
                                  ks: int, hs: int, return_cs: bool = False):
    """Plain PyTorch version of the forward kernel: the plain layer over
    `unfold_frames(x, ks, hs)`. x [B, L, C]; wx_* [ks * C, 4H] (rows
    c * ks + k) -> ys [B, T', 2H] (and cs [B, T', 2H] f32)."""
    return bilstm_layer_reference(unfold_frames(x, ks, hs), wx_f, b_f, wh_f,
                                  wx_b, b_b, wh_b, return_cs=return_cs)


def bilstm_layer_unfold_backward_reference(x, wx_f, b_f, wh_f, wx_b, b_b,
                                           wh_b, ys, cs, dys, ks: int,
                                           hs: int):
    """Plain PyTorch version of the backward kernels and the fold ->
    (dx [B, L, C] in x's dtype, dwx_f, db_f, dwh_f, dwx_b, db_b, dwh_b f32).
    The two directions' frame cotangents are each rounded to x's dtype and
    added in it (`bilstm_layer_backward_reference`), then folded."""
    du, *dws = bilstm_layer_backward_reference(
        unfold_frames(x, ks, hs), wx_f, b_f, wh_f, wx_b, b_b, wh_b, ys, cs,
        dys)
    return (fold_frames(du, ks, hs, x.shape[1]), *dws)


def bilstm_layer_unfold_wgrad_reference(x, ys, dg, ks: int, hs: int):
    """Plain PyTorch version of the weight-gradient kernel -> [2, ks * C +
    H, 4H] f32 (rows :ks*C are dWx, rows ks*C: dWh)."""
    return bilstm_layer_wgrad_reference(unfold_frames(x, ks, hs), ys, dg)


def _shape(x, ks, hs):
    """(B, L, C, T') of a raw stream, checked."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, L, C], got {tuple(x.shape)}")
    b, length, c = x.shape
    return b, length, c, _frames(length, ks, hs)


def _forward_cuda(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, ks, hs, with_cs):
    """The forward on the card -> (ys, cs or None): where
    `cuda_lstm_tc.forward_fits` takes the shapes (bf16), the tensor-core
    projection over k-major frames and the cluster recurrence of
    ops/cuda_lstm_tc.py; where `cuda_lstm_f32.f32_forward_fits` takes them
    (f32), the FMA projection over k-major frames and cluster recurrence of
    ops/cuda_lstm_f32.py; otherwise the forward kernel of
    csrc/bilstm_unfold.cu."""
    from wesep_tpu_torch.ops import cuda_lstm_f32, cuda_lstm_tc

    b, length, c, n = _shape(x, ks, hs)
    args = _kernel_args(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, d=ks * c)
    hidden = wh_f.shape[0]
    if cuda_lstm_tc.forward_fits(x.dtype, ks * c, hidden, b * n, c=c) or \
            cuda_lstm_f32.f32_forward_fits(x.dtype, ks * c, hidden, b * n,
                                           c=c):
        return cuda_lstm_tc.unfold_forward(*args, ks, hs, with_cs=with_cs)
    ys = torch.empty(b, n, 2 * hidden, dtype=x.dtype, device=x.device)
    cs = torch.empty(b, n, 2 * hidden, dtype=torch.float32,
                     device=x.device) if with_cs else None
    if b == 0:
        return ys, cs
    _launch(bilstm_layer_unfold,
            _entry("bilstm_unfold", "bilstm_unfold_forward", 9, 7),
            (*args, ys, cs),
            (b, length, c, ks, hs, hidden, _DTYPE_CODES[x.dtype]), x.device)
    return ys, cs


def bilstm_layer_unfold_wgrad(x, ys, dg, ks: int, hs: int):
    """Weight-gradient kernel: dW[dir] = [u_t ; h_{t-1}]^T @ dg[dir] summed
    over batch and frames, u_t the frame gathered from x in place -> [2,
    ks * C + H, 4H] f32. x [B, L, C], ys [B, T', 2H], dg [2, B, T', 4H] in
    x's dtype, contiguous, on the card. The slices' partial sums are added
    here, in a fixed order."""
    b, length, c, n = _shape(x, ks, hs)
    hidden = ys.shape[2] // 2
    _check("ys", ys, (b, n, 2 * hidden), x.device)
    _check("dg", dg, (2, b, n, 4 * hidden), x.device)
    if x.dtype not in _DTYPE_CODES or ys.dtype != x.dtype \
            or dg.dtype != x.dtype:
        raise TypeError("x, ys and dg must share float32 or bfloat16")
    if not (x.is_contiguous() and ys.is_contiguous() and dg.is_contiguous()):
        raise ValueError("x, ys and dg must be contiguous")
    splits = max(1, min(_WGRAD_MAX_SPLITS, -(-b * n // _WGRAD_SPLIT_ROWS)))
    partial = torch.empty(splits, 2, ks * c + hidden, 4 * hidden,
                          dtype=torch.float32, device=x.device)
    _launch(bilstm_layer_unfold_wgrad,
            _entry("bilstm_unfold_bwd", "bilstm_unfold_wgrad", 4, 8),
            (x, ys, dg, partial),
            (b, length, c, ks, hs, hidden, splits, _DTYPE_CODES[x.dtype]),
            x.device)
    return partial.sum(dim=0)


def bilstm_layer_unfold_backward(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, ys, cs,
                                 dys, ks: int, hs: int):
    """The serial adjoint kernel on CUDA tensors -> (du, db, dg).

    du [B, T', ks * C] in x's dtype is the sum of the two directions' frame
    cotangents, each rounded first (fold it with `fold_frames`); db [2, 4H]
    f32 holds both directions' bias gradients; dg [2, B, T', 4H] in x's
    dtype is the stream of rounded dgates that `bilstm_layer_unfold_wgrad`
    contracts, transient scratch. The kernel reads Wx^T and Wh^T from
    transposed copies made here once per call."""
    b, length, c, n = _shape(x, ks, hs)
    args = _kernel_args(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, d=ks * c)
    hidden = wh_f.shape[0]
    for name, t in (("ys", ys), ("cs", cs), ("dys", dys)):
        _check(name, t, (b, n, 2 * hidden), x.device)
    if ys.dtype != x.dtype or cs.dtype != torch.float32:
        raise TypeError("ys must have x's dtype and cs must be float32")
    if b == 0:
        raise ValueError("the backward kernels need B > 0")
    transposed = [w.t().contiguous() for w in
                  (args[1], args[3], args[4], args[6])]
    du2 = torch.empty(2, b, n, ks * c, dtype=x.dtype, device=x.device)
    dg = torch.empty(2, b, n, 4 * hidden, dtype=x.dtype, device=x.device)
    db_part = torch.empty(-(-b // _TILE), 2, 4 * hidden,
                          dtype=torch.float32, device=x.device)
    _launch(bilstm_layer_unfold_backward,
            _entry("bilstm_unfold_bwd", "bilstm_unfold_backward", 17, 7),
            (*args, *transposed, ys.contiguous(), cs.contiguous(),
             dys.to(x.dtype).contiguous(), du2, dg, db_part),
            (b, length, c, ks, hs, hidden, _DTYPE_CODES[x.dtype]), x.device)
    return du2[0] + du2[1], db_part.sum(dim=0), dg


def _backward_cuda(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, ys, cs, dys, ks, hs):
    """The backward kernels and the fold; results as
    `bilstm_layer_unfold_backward_reference`. Where
    `cuda_lstm_tc.backward_fits` takes the shapes (bf16), the tensor-core
    backward of ops/cuda_lstm_tc.py; where `cuda_lstm_f32.f32_backward_fits`
    takes them (f32), the FMA backward of ops/cuda_lstm_f32.py (both through
    `cuda_lstm_tc.unfold_backward`); otherwise the kernels of
    csrc/bilstm_unfold_bwd.cu."""
    from wesep_tpu_torch.ops import cuda_lstm_f32, cuda_lstm_tc

    d = ks * x.shape[2]
    hidden, rows = wh_f.shape[0], x.shape[0] * ys.shape[1]
    if cuda_lstm_tc.backward_fits(x.dtype, d, hidden, rows, c=x.shape[2]) \
            or cuda_lstm_f32.f32_backward_fits(x.dtype, d, hidden, rows,
                                               c=x.shape[2]):
        return cuda_lstm_tc.unfold_backward(x, wx_f, b_f, wh_f, wx_b, b_b,
                                            wh_b, ys, cs, dys, ks, hs)
    du, db, dg = bilstm_layer_unfold_backward(
        x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, ys, cs, dys, ks, hs)
    dw = bilstm_layer_unfold_wgrad(x.detach().contiguous(), ys.contiguous(),
                                   dg, ks, hs)
    return (fold_frames(du, ks, hs, x.shape[1]), dw[0, :d], db[0],
            dw[0, d:], dw[1, :d], db[1], dw[1, d:])


bilstm_layer_unfold_backward.launches = 0
bilstm_layer_unfold_wgrad.launches = 0


class BiLSTMUnfoldFn(torch.autograd.Function):
    """The unfold-fused layer with its hand-written backward, on both
    devices; arguments and dtype handling as `cuda_lstm.BiLSTMLayerFn`,
    with the unfold's (ks, hs) after (plain, save)."""

    @staticmethod
    def forward(ctx, plain, save, ks, hs, x, wx_f, b_f, wh_f, wx_b, b_b,
                wh_b):
        weights = (wx_f, b_f, wh_f, wx_b, b_b, wh_b)
        if _on_kernel_path(plain, x):
            ys, cs = _forward_cuda(x, *weights, ks, hs, with_cs=save)
        else:
            out = bilstm_layer_unfold_reference(x, *weights, ks, hs,
                                                return_cs=save)
            ys, cs = out if save else (out, None)
        if save:
            ctx.plain, ctx.ks, ctx.hs = plain, ks, hs
            ctx.save_for_backward(x, *weights, ys, cs)
        return ys

    @staticmethod
    @once_differentiable
    def backward(ctx, dys):
        x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, ys, cs = ctx.saved_tensors
        weights = (wx_f, b_f, wh_f, wx_b, b_b, wh_b)
        run = _backward_cuda if _on_kernel_path(ctx.plain, x) \
            else bilstm_layer_unfold_backward_reference
        dx, *dws = run(x, *weights, ys, cs, dys, ctx.ks, ctx.hs)
        return (None, None, None, None, dx,
                *(dw.to(w.dtype) for dw, w in zip(dws, weights)))


def bilstm_layer_unfold(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, ks: int,
                        hs: int, plain: bool = False):
    """unfold(ks, hs) + fused bidirectional LSTM layer -> [B, T', 2H]
    (argument order of pallas_lstm.bilstm_layer_unfold). x [B, L, C];
    wx_* [ks * C, 4H] in channel-major row order (c * ks + k), identical to
    feeding `cuda_lstm.bilstm_layer` the unfolded stream. Differentiable in
    x and every weight."""
    tensors = (x, wx_f, b_f, wh_f, wx_b, b_b, wh_b)
    save = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    if not (save or plain) and x.device.type in ("cpu", "cuda"):
        return bilstm_layer_unfold_op(*tensors, int(ks), int(hs))
    return BiLSTMUnfoldFn.apply(plain, save, ks, hs, *tensors)


@torch.library.custom_op("wesep::bilstm_layer_unfold", mutates_args=(),
                         device_types="cpu")
def bilstm_layer_unfold_op(x: torch.Tensor, wx_f: torch.Tensor,
                           b_f: torch.Tensor, wh_f: torch.Tensor,
                           wx_b: torch.Tensor, b_b: torch.Tensor,
                           wh_b: torch.Tensor, ks: int, hs: int
                           ) -> torch.Tensor:
    """The layer's forward as the operator `wesep::bilstm_layer_unfold`
    (a served forward's; one node under torch.export): on the CPU the
    plain version, on CUDA tensors the kernels."""
    return bilstm_layer_unfold_reference(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b,
                                         ks, hs)


@bilstm_layer_unfold_op.register_kernel("cuda")
def _bilstm_layer_unfold_op_cuda(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, ks,
                                 hs):
    return _forward_cuda(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, ks, hs,
                         with_cs=False)[0]


@bilstm_layer_unfold_op.register_fake
def _bilstm_layer_unfold_op_fake(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, ks,
                                 hs):
    return x.new_empty(x.shape[0], _frames(x.shape[1], ks, hs),
                       2 * wh_f.shape[0])


bilstm_layer_unfold.launches = 0
