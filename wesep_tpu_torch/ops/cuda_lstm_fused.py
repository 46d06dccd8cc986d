"""Two-kernel LSTM layers: CUDA kernel wrappers and plain versions.

Counterpart of wesep_tpu/ops/pallas_lstm.py `bilstm_fused` and
`lstm_fused`. In both, the input projection xw = x @ Wx + b is a library
product outside the kernels, as XLA computes it in the JAX package, and the
kernels run only the recurrence: csrc/lstm_fused.cu holds the forward
(`_bi_forward`, both directions of a layer; `_forward`, one direction with
`reverse`) and csrc/lstm_fused_bwd.cu the serial adjoint and the dWh product
(`_bi_backward`, `_bwd_impl`). dx and dWx are library products again. The
sources' headers say what bounds the kernels.

Layouts: xw and dxw are [dirs, B, T, 4H] (one batch-major slab per
direction), y and the cell states cs [B, T, dirs * H] (forward features
first).

`bilstm_fused` and `lstm_fused` are `torch.autograd.Function`s on both
devices (`BiLSTMFusedFn`, `LSTMFusedFn`). On CUDA tensors they launch the
kernels (for a bf16 stream whose shapes `cuda_lstm_tc.forward_fits` and
`backward_fits` take, the tensor-core recurrence and backward of
ops/cuda_lstm_tc.py; for an f32 stream whose shapes
`cuda_lstm_f32.f32_forward_fits` and `f32_backward_fits` take, the
recurrence, adjoint and dWh of ops/cuda_lstm_f32.py); on CPU tensors they
run the plain versions
`bilstm_fused_reference` and `bilstm_fused_backward_reference`,
`lstm_fused_reference` and `lstm_fused_backward_reference`. Anything else
raises: there is no fallback from a failed build or launch. Every wrapper counts its launches:
`bilstm_fused_forward.launches`, `bilstm_fused_backward.launches`,
`bilstm_fused_wgrad.launches` and the three `lstm_fused_*` ones.

Rounding follows the JAX package: xw is summed in f32 from x and the f32
Wx (not rounded to the stream's dtype) and rounded once, with the bias;
Wh is rounded to the stream's dtype and h before every Wh product; dys is
cast to the stream's dtype before the adjoint; each direction's dx is
rounded before the two are added; `lstm_fused` rounds dWh to the stream's
dtype, `bilstm_fused` does not.
"""

import torch
from torch.autograd.function import once_differentiable

from wesep_tpu_torch.ops.cuda_lstm import (
    _DTYPE_CODES,
    _MAX_HIDDEN,
    _TILE,
    _WGRAD_MAX_SPLITS,
    _WGRAD_SPLIT_ROWS,
    _check,
    _entry,
    _launch,
    _on_kernel_path,
)

__all__ = ["kernel_fits", "project",
           "bilstm_fused", "bilstm_fused_forward", "bilstm_fused_backward",
           "bilstm_fused_wgrad", "bilstm_fused_reference",
           "bilstm_fused_backward_reference",
           "lstm_fused", "lstm_fused_forward", "lstm_fused_backward",
           "lstm_fused_wgrad", "lstm_fused_reference",
           "lstm_fused_backward_reference", "lstm_fused_wgrad_reference",
           "BiLSTMFusedFn", "LSTMFusedFn"]


def kernel_fits(hidden: int) -> bool:
    """Whether the kernels take a layer of `hidden` units: one thread per
    unit and float4 reads of h, so H % 4 == 0 and H <= 256."""
    return 0 < hidden <= _MAX_HIDDEN and hidden % 4 == 0


def project(x, wx, b):
    """xw = x @ Wx + b [B, T, 4H]: f32 sums of x and the f32 Wx, plus the
    bias, rounded to x's dtype (pallas_lstm._xw_time_major, batch-major)."""
    return (torch.matmul(x.float(), wx.float()) + b.float()).to(x.dtype)


def _mm_f32(a, b):
    """a @ b with f32 sums and an f32 result, from operands in the stream's
    dtype: for bf16 on the card, one tensor-core product (cuBLAS with
    `out_dtype`); otherwise the same sums from f32 operands."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _walks_back(d: int, reverse: bool) -> bool:
    """Whether direction d walks time from T-1 down (the kernels' d ^
    reverse)."""
    return (d == 1) != bool(reverse)


# ---- plain versions ---------------------------------------------------------


def _recurrence_reference(xw, whs, reverse, return_cs):
    """Plain PyTorch version of the forward kernel: xw [dirs, B, T, 4H] in
    the stream's dtype, one Wh per direction -> y [B, T, dirs * H] in the
    stream's dtype and, with `return_cs`, cs [B, T, dirs * H] f32. Products
    accumulate in f32 from Wh and h rounded to the stream's dtype."""
    dtype = xw.dtype
    _, batch, t_len, h4 = xw.shape
    hidden = h4 // 4
    ys, cs = [], []
    for d, wh in enumerate(whs):
        wh32 = wh.to(dtype).float()
        h = xw.new_zeros(batch, hidden, dtype=torch.float32)
        c = torch.zeros_like(h)
        y_d, c_d = [None] * t_len, [None] * t_len
        steps = range(t_len - 1, -1, -1) if _walks_back(d, reverse) \
            else range(t_len)
        for t in steps:
            g = xw[d, :, t].float() + torch.matmul(h, wh32)
            i, f, gg, o = g.split(hidden, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = (torch.sigmoid(o) * torch.tanh(c)).to(dtype).float()
            y_d[t], c_d[t] = h, c
        ys.append(torch.stack(y_d, dim=1))
        cs.append(torch.stack(c_d, dim=1))
    y = torch.cat(ys, dim=-1).to(dtype)
    return (y, torch.cat(cs, dim=-1)) if return_cs else y


def _adjoint_reference(xw, whs, reverse, ys, cs, dys):
    """Plain PyTorch version of the backward kernels, step by step with the
    same rounding points -> (dxw [dirs, B, T, 4H] in the stream's dtype,
    dwh [dirs, H, 4H] f32, db [dirs, 4H] f32). dgates are formed in f32
    and rounded before every product; db sums the unrounded ones."""
    dtype = xw.dtype
    dirs, batch, t_len, h4 = xw.shape
    hidden = h4 // 4
    dys32 = dys.to(dtype).float()
    zeros = xw.new_zeros(batch, hidden, dtype=torch.float32)
    dxw = torch.empty_like(xw)
    dwh, db = [], []
    for d, wh in enumerate(whs):
        wh32 = wh.to(dtype).float()
        cols = slice(d * hidden, (d + 1) * hidden)
        y32, c, dy = ys[..., cols].float(), cs[..., cols], dys32[..., cols]
        dh, dc = zeros, zeros
        dwh_d = torch.zeros_like(wh32)
        db_d = xw.new_zeros(h4, dtype=torch.float32)
        back = _walks_back(d, reverse)
        # the adjoint walks the forward's steps backwards
        steps = range(t_len) if back else range(t_len - 1, -1, -1)
        for t in steps:
            tp = t + 1 if back else t - 1
            inside = 0 <= tp < t_len
            h_prev = y32[:, tp] if inside else zeros
            c_prev = c[:, tp] if inside else zeros
            g = xw[d, :, t].float() + torch.matmul(h_prev, wh32)
            i, f, gg, o = g.split(hidden, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            gg = torch.tanh(gg)
            tanh_c = torch.tanh(c[:, t])
            dh_total = dy[:, t] + dh
            do = dh_total * tanh_c
            dct = dh_total * o * (1.0 - tanh_c * tanh_c) + dc
            dgates = torch.cat([
                (dct * gg) * i * (1.0 - i),
                (dct * c_prev) * f * (1.0 - f),
                (dct * i) * (1.0 - gg * gg),
                do * o * (1.0 - o),
            ], dim=-1)
            dg_lp = dgates.to(dtype)
            dxw[d, :, t] = dg_lp
            dh = torch.matmul(dg_lp.float(), wh32.t())
            dwh_d += torch.matmul(h_prev.t(), dg_lp.float())
            db_d += dgates.sum(dim=0)
            dc = dct * f
        dwh.append(dwh_d)
        db.append(db_d)
    return dxw, torch.stack(dwh), torch.stack(db)


def lstm_fused_wgrad_reference(ys, dxw, reverse: bool = False):
    """Plain PyTorch version of the weight-gradient kernel: for each
    direction, h_{t-1}^T @ dxw summed over batch and time -> [dirs, H, 4H]
    f32, with h_{t-1} read from ys one step back (a direction that walks
    forwards) or one step on (one that walks backwards), zero at the
    boundary."""
    dirs, batch = dxw.shape[:2]
    hidden = ys.shape[2] // dirs
    zero = ys.new_zeros(batch, 1, hidden, dtype=torch.float32)
    out = []
    for d in range(dirs):
        y32 = ys[..., d * hidden:(d + 1) * hidden].float()
        h_prev = torch.cat([y32[:, 1:], zero], dim=1) \
            if _walks_back(d, reverse) else torch.cat([zero, y32[:, :-1]],
                                                      dim=1)
        out.append(torch.einsum("btm,btn->mn", h_prev, dxw[d].float()))
    return torch.stack(out)


def bilstm_fused_reference(xw, wh_f, wh_b, return_cs: bool = False):
    """Plain version of the bidirectional forward kernel: xw [2, B, T, 4H]
    -> y [B, T, 2H] (and cs [B, T, 2H] f32 with `return_cs`)."""
    return _recurrence_reference(xw, (wh_f, wh_b), False, return_cs)


def bilstm_fused_backward_reference(xw, wh_f, wh_b, ys, cs, dys):
    """Plain version of the bidirectional backward kernels -> (dxw [2, B,
    T, 4H] in the stream's dtype, dwh [2, H, 4H] f32, db [2, 4H] f32)."""
    return _adjoint_reference(xw, (wh_f, wh_b), False, ys, cs, dys)


def lstm_fused_reference(xw, wh, reverse: bool = False,
                         return_cs: bool = False):
    """Plain version of the unidirectional forward kernel: xw [1, B, T, 4H]
    -> y [B, T, H] (and cs [B, T, H] f32 with `return_cs`)."""
    return _recurrence_reference(xw, (wh,), reverse, return_cs)


def lstm_fused_backward_reference(xw, wh, ys, cs, dys,
                                  reverse: bool = False):
    """Plain version of the unidirectional backward kernels -> (dxw [1, B,
    T, 4H] in the stream's dtype, dwh [1, H, 4H] f32, db [1, 4H] f32)."""
    return _adjoint_reference(xw, (wh,), reverse, ys, cs, dys)


# ---- kernel wrappers --------------------------------------------------------


def _stream_args(xw, whs):
    """Check what the kernels take; return (dims, Wh in the stream's dtype,
    contiguous) with dims = (dirs, B, T, H)."""
    if xw.dim() != 4 or xw.shape[0] != len(whs) or xw.shape[3] % 4:
        raise ValueError(f"xw must be [{len(whs)}, B, T, 4H], got "
                         f"{tuple(xw.shape)}")
    if xw.dtype not in _DTYPE_CODES:
        raise TypeError(f"the LSTM kernels take float32 or bfloat16, not "
                        f"{xw.dtype}")
    if not xw.is_contiguous():
        raise ValueError("xw must be contiguous")
    dirs, batch, t_len, h4 = xw.shape
    hidden = h4 // 4
    if not kernel_fits(hidden):
        raise ValueError(f"kernel needs H % 4 == 0 and H <= {_MAX_HIDDEN}; "
                         f"got H={hidden}")
    for wh in whs:
        _check("wh", wh, (hidden, h4), xw.device)
    return (dirs, batch, t_len, hidden), [
        w.detach().to(xw.dtype).contiguous() for w in whs]


def _forward_cuda(counter, xw, whs, reverse, with_cs):
    """The recurrence on the card -> (ys, cs or None): where
    `cuda_lstm_tc.forward_fits` takes the shapes (bf16), the tensor-core
    cluster recurrence of ops/cuda_lstm_tc.py; where
    `cuda_lstm_f32.f32_forward_fits` takes them (f32), the FMA cluster
    recurrence of ops/cuda_lstm_f32.py; otherwise the route's K1/K2 kernel
    (`counter`)."""
    from wesep_tpu_torch.ops import cuda_lstm_f32, cuda_lstm_tc

    (dirs, batch, t_len, hidden), whs = _stream_args(xw, whs)
    rows = batch * t_len
    if cuda_lstm_tc.forward_fits(xw.dtype, 0, hidden, rows) or \
            cuda_lstm_f32.f32_forward_fits(xw.dtype, 0, hidden, rows):
        return cuda_lstm_tc.fused_forward(xw, whs, reverse, with_cs)
    ys = torch.empty(batch, t_len, dirs * hidden, dtype=xw.dtype,
                     device=xw.device)
    cs = torch.empty(batch, t_len, dirs * hidden, dtype=torch.float32,
                     device=xw.device) if with_cs else None
    if batch == 0 or t_len == 0:
        return ys, cs
    _launch(counter, _entry("lstm_fused", "lstm_fused_forward", 5, 6),
            (xw, whs[0], whs[1] if dirs == 2 else None, ys, cs),
            (batch, t_len, hidden, dirs, int(reverse),
             _DTYPE_CODES[xw.dtype]), xw.device)
    return ys, cs


def _backward_cuda(counter, xw, whs, reverse, ys, cs, dys):
    (dirs, batch, t_len, hidden), whs = _stream_args(xw, whs)
    for name, t in (("ys", ys), ("cs", cs), ("dys", dys)):
        _check(name, t, (batch, t_len, dirs * hidden), xw.device)
    if ys.dtype != xw.dtype or cs.dtype != torch.float32:
        raise TypeError("ys must have xw's dtype and cs must be float32")
    if batch == 0 or t_len == 0:
        raise ValueError("the backward kernels need B > 0 and T > 0")
    transposed = [w.t().contiguous() for w in whs]
    if dirs == 1:
        whs, transposed = whs + [None], transposed + [None]
    dxw = torch.empty_like(xw)
    db_part = torch.empty(-(-batch // _TILE), dirs, 4 * hidden,
                          dtype=torch.float32, device=xw.device)
    _launch(counter, _entry("lstm_fused_bwd", "lstm_fused_backward", 10, 6),
            (xw, *whs, *transposed, ys.contiguous(), cs.contiguous(),
             dys.to(xw.dtype).contiguous(), dxw, db_part),
            (batch, t_len, hidden, dirs, int(reverse),
             _DTYPE_CODES[xw.dtype]), xw.device)
    return dxw, db_part.sum(dim=0)


def _wgrad_cuda(counter, ys, dxw, reverse):
    dirs, batch, t_len, h4 = dxw.shape
    hidden = h4 // 4
    _check("ys", ys, (batch, t_len, dirs * hidden), dxw.device)
    if dxw.dtype not in _DTYPE_CODES or ys.dtype != dxw.dtype:
        raise TypeError("ys and dxw must share float32 or bfloat16")
    if not (ys.is_contiguous() and dxw.is_contiguous()):
        raise ValueError("ys and dxw must be contiguous")
    if not kernel_fits(hidden) or batch == 0 or t_len == 0:
        raise ValueError(f"kernel needs B, T > 0, H % 4 == 0 and H <= "
                         f"{_MAX_HIDDEN}; got dxw {tuple(dxw.shape)}")
    rows = batch * t_len
    splits = max(1, min(_WGRAD_MAX_SPLITS, -(-rows // _WGRAD_SPLIT_ROWS)))
    partial = torch.empty(splits, dirs, hidden, h4, dtype=torch.float32,
                          device=dxw.device)
    _launch(counter, _entry("lstm_fused_bwd", "lstm_fused_wgrad", 3, 7),
            (ys, dxw, partial),
            (batch, t_len, hidden, splits, dirs, int(reverse),
             _DTYPE_CODES[dxw.dtype]), dxw.device)
    return partial.sum(dim=0)


def bilstm_fused_forward(xw, wh_f, wh_b, with_cs: bool = False):
    """K2 on CUDA tensors: xw [2, B, T, 4H] -> (y [B, T, 2H] in xw's dtype,
    cs [B, T, 2H] f32 or None)."""
    return _forward_cuda(bilstm_fused_forward, xw, (wh_f, wh_b), False,
                         with_cs)


def bilstm_fused_backward(xw, wh_f, wh_b, ys, cs, dys):
    """K2b's serial adjoint on CUDA tensors -> (dxw [2, B, T, 4H] in xw's
    dtype, the rounded dgates; db [2, 4H] f32, its tiles added here in a
    fixed order)."""
    return _backward_cuda(bilstm_fused_backward, xw, (wh_f, wh_b), False,
                          ys, cs, dys)


def bilstm_fused_wgrad(ys, dxw):
    """K2b's weight gradients on CUDA tensors: dWh [2, H, 4H] f32 from ys
    [B, T, 2H] and dxw [2, B, T, 4H]; each block sums one slice of the
    (batch, time) rows and the slices are added here in a fixed order."""
    return _wgrad_cuda(bilstm_fused_wgrad, ys, dxw, False)


def lstm_fused_forward(xw, wh, reverse: bool = False, with_cs: bool = False):
    """K1 on CUDA tensors: xw [1, B, T, 4H] -> (y [B, T, H], cs or None)."""
    return _forward_cuda(lstm_fused_forward, xw, (wh,), reverse, with_cs)


def lstm_fused_backward(xw, wh, ys, cs, dys, reverse: bool = False):
    """K1b's serial adjoint on CUDA tensors -> (dxw [1, B, T, 4H], db
    [1, 4H] f32)."""
    return _backward_cuda(lstm_fused_backward, xw, (wh,), reverse, ys, cs,
                          dys)


def lstm_fused_wgrad(ys, dxw, reverse: bool = False):
    """K1b's weight gradients on CUDA tensors: dWh [1, H, 4H] f32."""
    return _wgrad_cuda(lstm_fused_wgrad, ys, dxw, reverse)


for _fn in (bilstm_fused_forward, bilstm_fused_backward, bilstm_fused_wgrad,
            lstm_fused_forward, lstm_fused_backward, lstm_fused_wgrad):
    _fn.launches = 0


# ---- the layers -------------------------------------------------------------


def _project_all(x, weights):
    """xw [dirs, B, T, 4H] from (Wx, b, Wh) per direction."""
    return torch.stack([project(x.detach(), wx.detach(), b.detach())
                        for wx, b, _ in weights])


# (forward, adjoint, weight-gradient wrappers, whether dWh is rounded to the
# stream's dtype as pallas_lstm._bwd_impl returns it)
_BIDIRECTIONAL = (bilstm_fused_forward, bilstm_fused_backward,
                  bilstm_fused_wgrad, False)
_UNIDIRECTIONAL = (lstm_fused_forward, lstm_fused_backward, lstm_fused_wgrad,
                   True)


def _layer_forward(ctx, route, plain, save, reverse, x, flat):
    """Forward of a two-kernel layer; `flat` holds (Wx, b, Wh) per
    direction as stored (f32), cast inside. Saves (x, the weights, ys, cs),
    not xw: the backward projects x again."""
    on_card = _on_kernel_path(plain, x)
    weights = [flat[i:i + 3] for i in range(0, len(flat), 3)]
    xw = _project_all(x, weights)
    whs = [wh for _, _, wh in weights]
    if on_card:
        ys, cs = _forward_cuda(route[0], xw, whs, reverse, save)
    else:
        out = _recurrence_reference(xw, whs, reverse, save)
        ys, cs = out if save else (out, None)
    if save:
        ctx.plain, ctx.reverse = plain, reverse
        ctx.save_for_backward(x, *flat, ys, cs)
    return ys


def _layer_backward(ctx, route, dys):
    """-> (dx, then dWx, db, dWh per direction in the parameters' dtype).
    On the card a bf16 stream whose shapes `cuda_lstm_tc.backward_fits`
    takes runs the tensor-core adjoint and dWh of ops/cuda_lstm_tc.py, an
    f32 stream whose shapes `cuda_lstm_f32.f32_backward_fits` takes the FMA
    adjoint and dWh of ops/cuda_lstm_f32.py (both through
    `cuda_lstm_tc.fused_backward`), other streams the route's K1b/K2b
    kernels."""
    from wesep_tpu_torch.ops import cuda_lstm_f32, cuda_lstm_tc

    x, *flat, ys, cs = ctx.saved_tensors
    weights = [flat[i:i + 3] for i in range(0, len(flat), 3)]
    xw = _project_all(x, weights)  # recomputed, not saved
    whs = [wh for _, _, wh in weights]
    dys = dys.to(x.dtype)
    if _on_kernel_path(ctx.plain, x):
        hidden, rows = whs[0].shape[0], xw.shape[1] * xw.shape[2]
        if cuda_lstm_tc.backward_fits(xw.dtype, 0, hidden, rows) or \
                cuda_lstm_f32.f32_backward_fits(xw.dtype, 0, hidden, rows):
            dxw, dwh, db = cuda_lstm_tc.fused_backward(xw, whs, ys, cs, dys,
                                                       ctx.reverse)
        else:
            dxw, db = _backward_cuda(route[1], xw, whs, ctx.reverse, ys, cs,
                                     dys)
            dwh = _wgrad_cuda(route[2], ys.contiguous(), dxw, ctx.reverse)
    else:
        dxw, dwh, db = _adjoint_reference(xw, whs, ctx.reverse, ys, cs, dys)
    if route[3]:
        dwh = dwh.to(x.dtype)
    x2d = x.reshape(-1, x.shape[-1])
    dx, grads = None, []
    for d, (wx, b, wh) in enumerate(weights):
        dxw_d = dxw[d].reshape(-1, dxw.shape[-1])
        # f32 sums of the rounded dgates and Wx rounded to their dtype, each
        # direction's dx rounded before the two are added
        dx_d = _mm_f32(dxw_d, wx.to(dxw.dtype).t()).to(x.dtype)
        dx = dx_d if dx is None else dx + dx_d
        dwx = _mm_f32(x2d.t(), dxw_d)
        grads += [dwx.to(wx.dtype), db[d].to(b.dtype), dwh[d].to(wh.dtype)]
    return (dx.reshape(x.shape), *grads)


class BiLSTMFusedFn(torch.autograd.Function):
    """`bilstm_fused` on both devices: K2 forward, K2b backward."""

    @staticmethod
    def forward(ctx, plain, save, x, wx_f, b_f, wh_f, wx_b, b_b, wh_b):
        return _layer_forward(ctx, _BIDIRECTIONAL, plain, save, False, x,
                              (wx_f, b_f, wh_f, wx_b, b_b, wh_b))

    @staticmethod
    @once_differentiable
    def backward(ctx, dys):
        return (None, None, *_layer_backward(ctx, _BIDIRECTIONAL, dys))


class LSTMFusedFn(torch.autograd.Function):
    """`lstm_fused` on both devices: K1 forward, K1b backward."""

    @staticmethod
    def forward(ctx, plain, save, reverse, x, wx, b, wh):
        return _layer_forward(ctx, _UNIDIRECTIONAL, plain, save, reverse, x,
                              (wx, b, wh))

    @staticmethod
    @once_differentiable
    def backward(ctx, dys):
        return (None, None, None, *_layer_backward(ctx, _UNIDIRECTIONAL, dys))


def _save(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# A served forward (nothing kept for a gradient) goes through the operators
# `wesep::bilstm_fused` and `wesep::lstm_fused`, which torch.export keeps as
# one node each: on the CPU the plain versions, on CUDA tensors the kernels.


@torch.library.custom_op("wesep::bilstm_fused", mutates_args=(),
                         device_types="cpu")
def bilstm_fused_op(x: torch.Tensor, wx_f: torch.Tensor, b_f: torch.Tensor,
                    wh_f: torch.Tensor, wx_b: torch.Tensor, b_b: torch.Tensor,
                    wh_b: torch.Tensor) -> torch.Tensor:
    """`bilstm_fused`'s forward as an operator (the plain version here)."""
    return _layer_forward(None, _BIDIRECTIONAL, True, False, False, x,
                          (wx_f, b_f, wh_f, wx_b, b_b, wh_b))


@bilstm_fused_op.register_kernel("cuda")
def _bilstm_fused_op_cuda(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b):
    return _layer_forward(None, _BIDIRECTIONAL, False, False, False, x,
                          (wx_f, b_f, wh_f, wx_b, b_b, wh_b))


@bilstm_fused_op.register_fake
def _bilstm_fused_op_fake(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b):
    return x.new_empty(x.shape[0], x.shape[1], 2 * wh_f.shape[0])


@torch.library.custom_op("wesep::lstm_fused", mutates_args=(),
                         device_types="cpu")
def lstm_fused_op(x: torch.Tensor, wx: torch.Tensor, b: torch.Tensor,
                  wh: torch.Tensor, reverse: bool) -> torch.Tensor:
    """`lstm_fused`'s forward as an operator (the plain version here)."""
    return _layer_forward(None, _UNIDIRECTIONAL, True, False, reverse, x,
                          (wx, b, wh))


@lstm_fused_op.register_kernel("cuda")
def _lstm_fused_op_cuda(x, wx, b, wh, reverse):
    return _layer_forward(None, _UNIDIRECTIONAL, False, False, reverse, x,
                          (wx, b, wh))


@lstm_fused_op.register_fake
def _lstm_fused_op_fake(x, wx, b, wh, reverse):
    return x.new_empty(x.shape[0], x.shape[1], wh.shape[0])


def bilstm_fused(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, plain: bool = False):
    """Two-kernel bidirectional LSTM layer -> [B, T, 2H] (argument order of
    pallas_lstm.bilstm_fused). Differentiable in x and every weight; a
    served forward goes through `bilstm_fused_op`."""
    tensors = (x, wx_f, b_f, wh_f, wx_b, b_b, wh_b)
    save = _save(tensors)
    if not (save or plain) and x.device.type in ("cpu", "cuda"):
        return bilstm_fused_op(*tensors)
    return BiLSTMFusedFn.apply(plain, save, *tensors)


def lstm_fused(x, wx, b, wh, reverse: bool = False, plain: bool = False):
    """Two-kernel unidirectional LSTM layer -> [B, T, H] (argument order of
    pallas_lstm.lstm_fused). Differentiable in x and every weight; a
    served forward goes through `lstm_fused_op`."""
    tensors = (x, wx, b, wh)
    save = _save(tensors)
    if not (save or plain) and x.device.type in ("cpu", "cuda"):
        return lstm_fused_op(*tensors, bool(reverse))
    return LSTMFusedFn.apply(plain, save, bool(reverse), *tensors)
