"""Fused bidirectional LSTM layer: CUDA kernel wrappers and plain versions.

Counterpart of wesep_tpu/ops/pallas_lstm.py `bilstm_layer`, forward and
backward. The kernels live in csrc/bilstm_layer.cu (forward) and
csrc/bilstm_layer_bwd.cu (the serial adjoint and the weight-gradient
product); their headers say what bounds them and how they are laid out.

`bilstm_layer` is a `torch.autograd.Function` on both devices. On CUDA
tensors its forward launches the forward kernel (which also writes the cell
states when a gradient will be needed) and its backward launches the two
backward kernels (for a bf16 stream whose shapes `cuda_lstm_tc.forward_fits`
and `backward_fits` take, the tensor-core kernels of ops/cuda_lstm_tc.py
instead; for an f32 stream whose shapes `cuda_lstm_f32.f32_forward_fits`
and `f32_backward_fits` take, the FMA kernels of ops/cuda_lstm_f32.py); on
CPU tensors it runs the
plain versions `bilstm_layer_reference` and
`bilstm_layer_backward_reference`. Anything else raises: there is no
fallback from a failed build or launch. Every wrapper counts its launches:
`bilstm_layer.launches`, `bilstm_layer_backward.launches`,
`bilstm_layer_wgrad.launches`.
"""

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

__all__ = ["kernel_fits", "bilstm_layer", "bilstm_layer_reference",
           "bilstm_layer_backward", "bilstm_layer_backward_reference",
           "bilstm_layer_wgrad", "bilstm_layer_wgrad_reference",
           "BiLSTMLayerFn"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HIDDEN = 256  # one thread per hidden unit (csrc/bilstm_layer.cu)
_TILE = 8  # batch rows per block of the serial kernels (csrc/bilstm_common.cuh)
# rows of the flattened (batch, time) axis that one block of the
# weight-gradient kernel sums, and the most such splits
_WGRAD_SPLIT_ROWS = 4096
_WGRAD_MAX_SPLITS = 8


def kernel_fits(d: int, hidden: int) -> bool:
    """Whether the kernels take rows of d inputs into `hidden` units: one
    thread per unit and float4 reads, so D % 4 == 0, H % 4 == 0 and
    H <= 256."""
    return d > 0 and d % 4 == 0 and 0 < hidden <= _MAX_HIDDEN \
        and hidden % 4 == 0


def _rounded(w, dtype):
    """A weight as the kernels see it: rounded to the stream's dtype, f32."""
    return w.to(dtype).float()


def bilstm_layer_reference(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b,
                           return_cs: bool = False):
    """Plain PyTorch version of the forward kernel, with the same dtype
    handling.

    x: [B, T, D]; wx_*: [D, 4H]; b_*: [4H]; wh_*: [H, 4H] -> ys [B, T, 2H]
    in x's dtype and, with `return_cs`, the cell states cs [B, T, 2H] f32.
    The weights are rounded to x's dtype, products accumulate in f32, the
    bias and cell state stay f32, and h is rounded to x's dtype before it
    enters the next Wh product and when it is stored.
    """
    dtype = x.dtype
    x32 = x.float()

    def one(wx, b, wh, reverse):
        wx32, wh32 = _rounded(wx, dtype), _rounded(wh, dtype)
        xw = torch.matmul(x32, wx32) + b.float()  # [B, T, 4H], f32
        hidden = wh.shape[0]
        h = x32.new_zeros(x.shape[0], hidden)
        c = x32.new_zeros(x.shape[0], hidden)
        ys = [None] * x.shape[1]
        cs = [None] * x.shape[1]
        steps = range(x.shape[1] - 1, -1, -1) if reverse \
            else range(x.shape[1])
        for t in steps:
            g = xw[:, t] + torch.matmul(h, wh32)
            i, f, gg, o = g.split(hidden, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = (torch.sigmoid(o) * torch.tanh(c)).to(dtype).float()
            ys[t] = h
            cs[t] = c
        return torch.stack(ys, dim=1), torch.stack(cs, dim=1)

    ys_f, cs_f = one(wx_f, b_f, wh_f, False)
    ys_b, cs_b = one(wx_b, b_b, wh_b, True)
    ys = torch.cat([ys_f, ys_b], dim=-1).to(dtype)
    if return_cs:
        return ys, torch.cat([cs_f, cs_b], dim=-1)
    return ys


def bilstm_layer_backward_reference(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b,
                                    ys, cs, dys):
    """Plain PyTorch version of the backward kernels, step by step with the
    same rounding points.

    Takes the forward's inputs, its outputs ys [B, T, 2H] (x's dtype) and
    cs [B, T, 2H] (f32) and the cotangent dys [B, T, 2H]; returns
    (dx, dwx_f, db_f, dwh_f, dwx_b, db_b, dwh_b): dx in x's dtype, the
    rest f32. Per direction and reversed step the gates are recomputed
    from (x_t, h_{t-1}), dgates are formed in f32 and rounded to x's dtype
    before every product (db sums the unrounded ones); the two directions'
    dx are each rounded to x's dtype and then added.
    """
    dtype = x.dtype
    x32 = x.float()
    dys32 = dys.to(dtype).float()
    batch, t_len, _ = x.shape
    hidden = wh_f.shape[0]

    def one(wx, b, wh, y, c, dy, reverse):
        wx32, wh32 = _rounded(wx, dtype), _rounded(wh, dtype)
        xw = torch.matmul(x32, wx32) + b.float()
        y32 = y.float()
        zeros = x32.new_zeros(batch, hidden)
        dh, dc = zeros, zeros
        dx = [None] * t_len
        dwx = torch.zeros_like(wx32)
        dwh = torch.zeros_like(wh32)
        db = x32.new_zeros(4 * hidden)
        # the adjoint walks the forward's steps backwards
        steps = range(t_len) if reverse else range(t_len - 1, -1, -1)
        for t in steps:
            tp = t + 1 if reverse else t - 1
            inside = 0 <= tp < t_len
            h_prev = y32[:, tp] if inside else zeros
            c_prev = c[:, tp] if inside else zeros
            g = xw[:, t] + torch.matmul(h_prev, wh32)
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
            dg_lp = dgates.to(dtype).float()
            dh = torch.matmul(dg_lp, wh32.t())
            dx[t] = torch.matmul(dg_lp, wx32.t()).to(dtype)
            dwx += torch.matmul(x32[:, t].t(), dg_lp)
            dwh += torch.matmul(h_prev.t(), dg_lp)
            db += dgates.sum(dim=0)
            dc = dct * f
        return torch.stack(dx, dim=1), dwx, db, dwh

    dx_f, dwx_f, db_f, dwh_f = one(
        wx_f, b_f, wh_f, ys[..., :hidden], cs[..., :hidden],
        dys32[..., :hidden], False)
    dx_b, dwx_b, db_b, dwh_b = one(
        wx_b, b_b, wh_b, ys[..., hidden:], cs[..., hidden:],
        dys32[..., hidden:], True)
    return dx_f + dx_b, dwx_f, db_f, dwh_f, dwx_b, db_b, dwh_b


def bilstm_layer_wgrad_reference(x, ys, dg):
    """Plain PyTorch version of the weight-gradient kernel: for each
    direction, [x_t ; h_{t-1}]^T @ dg summed over batch and time ->
    [2, D + H, 4H] f32, with h_{t-1} read from ys one step back (forward
    direction) or one step on (backward direction), zero at the boundary."""
    hidden = ys.shape[2] // 2
    x32, y32, zero = x.float(), ys.float(), ys.new_zeros(
        ys.shape[0], 1, hidden, dtype=torch.float32)
    h_prev = (torch.cat([zero, y32[:, :-1, :hidden]], dim=1),
              torch.cat([y32[:, 1:, hidden:], zero], dim=1))
    return torch.stack([
        torch.einsum("btm,btn->mn", torch.cat([x32, h], dim=-1), dg[d].float())
        for d, h in enumerate(h_prev)])


@functools.lru_cache(maxsize=None)
def _entry(library: str, name: str, n_pointers: int, n_ints: int,
           n_floats: int = 0):
    """A kernel's C entry point (pointers, ints, floats, stream), built and
    loaded at first use."""
    from wesep_tpu_torch.ops._build import load_library

    fn = getattr(load_library(library), name)
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints \
        + [ctypes.c_float] * n_floats + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(counter, fn, tensors, ints, device):
    """Call a C entry point on the current stream; raise unless it returns
    0; count the launch on `counter`."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*[0 if t is None else t.data_ptr() for t in tensors],
                 *ints, stream)
    if err != 0:
        raise RuntimeError(
            f"{counter.__name__} kernel launch failed: CUDA error {err}")
    counter.launches += 1


def _check(name, t, shape, device):
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x is on {device}")


def _kernel_args(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, d=None):
    """Check what the kernels take and return (x, wx_f, b_f, wh_f, wx_b,
    b_b, wh_b) as they take it: weights in the stream's dtype (f32 params
    must not promote a bf16 stream), biases f32, all contiguous. `d` is the
    length of a step's input row (x's last axis unless given)."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, D], got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"bilstm_layer takes float32 or bfloat16, not {x.dtype}")
    d = x.shape[2] if d is None else d
    hidden = wh_f.shape[0]
    if not kernel_fits(d, hidden):
        raise ValueError(
            f"kernel needs D % 4 == 0, H % 4 == 0 and H <= {_MAX_HIDDEN}; "
            f"got D={d}, H={hidden}"
        )
    for name, w, shape in (
        ("wx_f", wx_f, (d, 4 * hidden)), ("wx_b", wx_b, (d, 4 * hidden)),
        ("wh_f", wh_f, (hidden, 4 * hidden)),
        ("wh_b", wh_b, (hidden, 4 * hidden)),
        ("b_f", b_f, (4 * hidden,)), ("b_b", b_b, (4 * hidden,)),
    ):
        _check(name, w, shape, x.device)
    cast = lambda w: w.detach().to(x.dtype).contiguous()  # noqa: E731
    bias = lambda b: b.detach().float().contiguous()  # noqa: E731
    return (x.detach().contiguous(), cast(wx_f), bias(b_f), cast(wh_f),
            cast(wx_b), bias(b_b), cast(wh_b))


def _forward_cuda(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, with_cs):
    """The forward on the card -> (ys, cs or None): where
    `cuda_lstm_tc.forward_fits` takes the shapes (bf16), the tensor-core
    projection and cluster recurrence of ops/cuda_lstm_tc.py; where
    `cuda_lstm_f32.f32_forward_fits` takes them (f32), the FMA projection
    and cluster recurrence of ops/cuda_lstm_f32.py; otherwise the forward
    kernel of csrc/bilstm_layer.cu."""
    from wesep_tpu_torch.ops import cuda_lstm_f32, cuda_lstm_tc

    args = _kernel_args(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b)
    x = args[0]
    batch, t_len, d = x.shape
    hidden = wh_f.shape[0]
    if cuda_lstm_tc.forward_fits(x.dtype, d, hidden, batch * t_len) or \
            cuda_lstm_f32.f32_forward_fits(x.dtype, d, hidden, batch * t_len):
        return cuda_lstm_tc.layer_forward(*args, with_cs=with_cs)
    ys = torch.empty(batch, t_len, 2 * hidden, dtype=x.dtype, device=x.device)
    cs = torch.empty(batch, t_len, 2 * hidden, dtype=torch.float32,
                     device=x.device) if with_cs else None
    if batch == 0 or t_len == 0:
        return ys, cs
    _launch(bilstm_layer,
            _entry("bilstm_layer", "bilstm_layer_forward", 9, 5),
            (*args, ys, cs),
            (batch, t_len, d, hidden, _DTYPE_CODES[x.dtype]), x.device)
    return ys, cs


def bilstm_layer_wgrad(x, ys, dg):
    """Weight-gradient kernel: dW[dir] = [x_t ; h_{t-1}]^T @ dg[dir] summed
    over batch and time -> [2, D + H, 4H] f32 (rows :D are dWx, rows D: are
    dWh). x [B, T, D], ys [B, T, 2H], dg [2, B, T, 4H] in x's dtype,
    contiguous, on the card. Each block sums one slice of the (batch, time)
    axis; the slices' partial sums are added here, in a fixed order."""
    batch, t_len, d = x.shape
    hidden = ys.shape[2] // 2
    _check("ys", ys, (batch, t_len, 2 * hidden), x.device)
    _check("dg", dg, (2, batch, t_len, 4 * hidden), x.device)
    if x.dtype not in _DTYPE_CODES or ys.dtype != x.dtype \
            or dg.dtype != x.dtype:
        raise TypeError("x, ys and dg must share float32 or bfloat16")
    if not (x.is_contiguous() and ys.is_contiguous() and dg.is_contiguous()):
        raise ValueError("x, ys and dg must be contiguous")
    rows = batch * t_len
    splits = max(1, min(_WGRAD_MAX_SPLITS, -(-rows // _WGRAD_SPLIT_ROWS)))
    partial = torch.empty(splits, 2, d + hidden, 4 * hidden,
                          dtype=torch.float32, device=x.device)
    _launch(bilstm_layer_wgrad,
            _entry("bilstm_layer_bwd", "bilstm_layer_wgrad", 4, 6),
            (x, ys, dg, partial),
            (batch, t_len, d, hidden, splits, _DTYPE_CODES[x.dtype]),
            x.device)
    return partial.sum(dim=0)


def bilstm_layer_backward(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, ys, cs, dys):
    """The serial adjoint kernel on CUDA tensors -> (dx, db, dg).

    Arguments as `bilstm_layer_backward_reference`. dx [B, T, D] in x's
    dtype is the sum of the two directions' dx, each rounded first; db
    [2, 4H] f32 holds both directions' bias gradients; dg [2, B, T, 4H] in
    x's dtype is the stream of rounded dgates that `bilstm_layer_wgrad`
    contracts into the weight gradients: transient scratch of
    2 * B * T * 4H elements. The kernel reads Wx^T and Wh^T from transposed
    copies made here once per call. The sums over the batch tiles' bias
    partials and the add of the two dx happen here, in a fixed order."""
    args = _kernel_args(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b)
    x = args[0]
    batch, t_len, d = x.shape
    hidden = wh_f.shape[0]
    for name, t in (("ys", ys), ("cs", cs), ("dys", dys)):
        _check(name, t, (batch, t_len, 2 * hidden), x.device)
    if ys.dtype != x.dtype or cs.dtype != torch.float32:
        raise TypeError("ys must have x's dtype and cs must be float32")
    if batch == 0 or t_len == 0:
        raise ValueError("the backward kernels need B > 0 and T > 0")
    transposed = [w.t().contiguous() for w in
                  (args[1], args[3], args[4], args[6])]
    dx2 = torch.empty(2, batch, t_len, d, dtype=x.dtype, device=x.device)
    dg = torch.empty(2, batch, t_len, 4 * hidden, dtype=x.dtype,
                     device=x.device)
    db_part = torch.empty(-(-batch // _TILE), 2, 4 * hidden,
                          dtype=torch.float32, device=x.device)
    _launch(bilstm_layer_backward,
            _entry("bilstm_layer_bwd", "bilstm_layer_backward", 17, 5),
            (*args, *transposed, ys.contiguous(), cs.contiguous(),
             dys.to(x.dtype).contiguous(), dx2, dg, db_part),
            (batch, t_len, d, hidden, _DTYPE_CODES[x.dtype]), x.device)
    return dx2[0] + dx2[1], db_part.sum(dim=0), dg


def _backward_cuda(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, ys, cs, dys):
    """The backward kernels; results as `bilstm_layer_backward_reference`.
    Where `cuda_lstm_tc.backward_fits` takes the shapes (bf16), the
    tensor-core backward of ops/cuda_lstm_tc.py; where
    `cuda_lstm_f32.f32_backward_fits` takes them (f32), the FMA backward of
    ops/cuda_lstm_f32.py (both through `cuda_lstm_tc.layer_backward`);
    otherwise the serial adjoint and weight-gradient kernels of
    csrc/bilstm_layer_bwd.cu."""
    from wesep_tpu_torch.ops import cuda_lstm_f32, cuda_lstm_tc

    d = x.shape[2]
    hidden, rows = wh_f.shape[0], x.shape[0] * x.shape[1]
    if cuda_lstm_tc.backward_fits(x.dtype, d, hidden, rows) or \
            cuda_lstm_f32.f32_backward_fits(x.dtype, d, hidden, rows):
        return cuda_lstm_tc.layer_backward(x, wx_f, b_f, wh_f, wx_b, b_b,
                                           wh_b, ys, cs, dys)
    dx, db, dg = bilstm_layer_backward(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b,
                                       ys, cs, dys)
    dw = bilstm_layer_wgrad(x.detach().contiguous(), ys.contiguous(), dg)
    return dx, dw[0, :d], db[0], dw[0, d:], dw[1, :d], db[1], dw[1, d:]


bilstm_layer_backward.launches = 0
bilstm_layer_wgrad.launches = 0


def _on_kernel_path(plain: bool, x) -> bool:
    if plain or x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"bilstm_layer runs on cuda or cpu, not {x.device}")
    return True


class BiLSTMLayerFn(torch.autograd.Function):
    """The layer with its hand-written backward, on both devices.

    It takes the parameters as they are stored (f32) and casts them inside,
    so the weight gradients come back in the parameters' dtype from f32
    sums, whatever the stream's dtype. `plain` runs the plain versions on
    any device; `save` says whether a gradient may be asked for (the cell
    states are computed and kept only then)."""

    @staticmethod
    def forward(ctx, plain, save, x, wx_f, b_f, wh_f, wx_b, b_b, wh_b):
        weights = (wx_f, b_f, wh_f, wx_b, b_b, wh_b)
        if _on_kernel_path(plain, x):
            ys, cs = _forward_cuda(x, *weights, with_cs=save)
        else:
            out = bilstm_layer_reference(x, *weights, return_cs=save)
            ys, cs = out if save else (out, None)
        if save:
            ctx.plain = plain
            ctx.save_for_backward(x, *weights, ys, cs)
        return ys

    @staticmethod
    @once_differentiable
    def backward(ctx, dys):
        x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, ys, cs = ctx.saved_tensors
        weights = (wx_f, b_f, wh_f, wx_b, b_b, wh_b)
        run = _backward_cuda if _on_kernel_path(ctx.plain, x) \
            else bilstm_layer_backward_reference
        dx, *dws = run(x, *weights, ys, cs, dys)
        return (None, None, dx,
                *(dw.to(w.dtype) for dw, w in zip(dws, weights)))


@torch.library.custom_op("wesep::bilstm_layer", mutates_args=(),
                         device_types="cpu")
def bilstm_layer_op(x: torch.Tensor, wx_f: torch.Tensor, b_f: torch.Tensor,
                    wh_f: torch.Tensor, wx_b: torch.Tensor, b_b: torch.Tensor,
                    wh_b: torch.Tensor) -> torch.Tensor:
    """The layer's forward as the operator `wesep::bilstm_layer`, which a
    served forward calls and torch.export keeps as one node: on the CPU
    the plain version, on CUDA tensors the kernels (registered below)."""
    return bilstm_layer_reference(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b)


@bilstm_layer_op.register_kernel("cuda")
def _bilstm_layer_op_cuda(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b):
    return _forward_cuda(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b,
                         with_cs=False)[0]


@bilstm_layer_op.register_fake
def _bilstm_layer_op_fake(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b):
    return x.new_empty(x.shape[0], x.shape[1], 2 * wh_f.shape[0])


def bilstm_layer(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, plain: bool = False):
    """Fused bidirectional LSTM layer -> [B, T, 2H] (argument order of
    pallas_lstm.bilstm_layer: input weight, bias, recurrent weight).
    Differentiable in x and every weight. A forward that keeps nothing for
    a gradient (serving) goes through `bilstm_layer_op`; on any other
    device than the CPU or CUDA the Function raises."""
    tensors = (x, wx_f, b_f, wh_f, wx_b, b_b, wh_b)
    save = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    if not (save or plain) and x.device.type in ("cpu", "cuda"):
        return bilstm_layer_op(*tensors)
    return BiLSTMLayerFn.apply(plain, save, *tensors)


bilstm_layer.launches = 0
