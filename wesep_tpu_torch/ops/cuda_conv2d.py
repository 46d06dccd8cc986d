"""Fused DPCCN Conv2dBlock: CUDA kernel wrappers and plain versions.

Counterpart of wesep_tpu/ops/pallas_conv2d.py `conv2d_block_in`, forward
and backward. The kernels live in csrc/conv2d_block.cu (forward) and
csrc/conv2d_block_bwd.cu (backward); their headers say what bounds them and
how they are laid out. Channels-last, stride 1, pad 1:

    y = InstanceNorm(ELU(conv3x3(x) + bias)),  x [B, T, F, Ci], y [B, T, F, Co]

`Conv2dBlockFn` is a `torch.autograd.Function` on both devices. It saves
only x, the kernel, the bias and the statistics (mu, rs) [B, 2, Co], as the
JAX custom VJP does, and the backward recomputes e. On CUDA tensors its
forward and backward launch the kernels; on CPU tensors they run the plain
versions `conv2d_block_in_reference` and
`conv2d_block_in_backward_reference`. Anything else raises: there is no
fallback from a failed build or launch. Each wrapper counts its launches:
`conv2d_block_in.launches`, `conv2d_block_in_backward.launches`.

Rounding points (they matter for a bf16 stream; for f32 every rounding is
the identity). x and the kernel are in the stream's dtype, the products
accumulate in f32, the bias and e = ELU(conv + b) are f32. The statistics
sum round(e) and round(e * e); y rounds (e - mu) * rs from the unrounded e.
Backward: S_b sums round(dy * e_hat); dout is rounded before db's sum and
before both products (dK in f32, dx rounded once).

Kernel limits (`csrc/conv2d_common.cuh`): Ci and Co multiples of 8, at
most 256; B at most 65535. DPCCN's gated convs have Ci <= 32, Co 16 or 32.
"""

import ctypes

import torch
from torch.autograd.function import once_differentiable
from torch.nn import functional as F

from wesep_tpu_torch.ops.cuda_lstm import _entry, _launch
from wesep_tpu_torch.ops.cuda_tcn import _aligned

__all__ = ["kernel_fits", "conv2d_block_in", "conv2d_block_in_reference",
           "conv2d_block_in_backward", "conv2d_block_in_backward_reference",
           "Conv2dBlockFn"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHANNELS = 256  # csrc/conv2d_common.cuh kMaxC


def _conv3x3(x32, k32):
    """Stride-1 pad-1 3x3 convolution of f32 [B, T, F, Ci] with an HWIO
    kernel [3, 3, Ci, Co] -> f32 [B, T, F, Co]."""
    y = F.conv2d(x32.permute(0, 3, 1, 2), k32.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def _elu(s):
    # exp(s) - 1 as the TPU kernel writes it (no expm1)
    return torch.where(s > 0, s, torch.exp(s) - 1.0)


def _pre(x, kernel, bias):
    """(rounding to the stream, e, N) of the block's input."""
    dt = x.dtype
    r = lambda t: t.to(dt).float()  # noqa: E731 - round through the stream
    s = _conv3x3(x.float(), r(kernel)) + bias.float()
    return r, _elu(s), float(x.shape[1] * x.shape[2])


def conv2d_block_in_reference(x, kernel, bias, eps: float = 1e-5,
                              return_stats: bool = False):
    """Plain PyTorch version of the forward kernel, with its rounding points.

    x [B, T, F, Ci] (f32 or bf16); kernel [3, 3, Ci, Co] HWIO; bias [Co]
    -> y [B, T, F, Co] in x's dtype and, with `return_stats`, stats
    [B, 2, Co] f32 = (mu, rs)."""
    r, e, n = _pre(x, kernel, bias)
    mu = r(e).sum(dim=(1, 2)) / n
    var = (r(e * e).sum(dim=(1, 2)) / n - mu * mu).clamp_min(0.0)
    rs = torch.rsqrt(var + eps)
    y = ((e - mu[:, None, None]) * rs[:, None, None]).to(x.dtype)
    if return_stats:
        return y, torch.stack([mu, rs], dim=1)
    return y


def conv2d_block_in_backward_reference(x, kernel, bias, stats, dy):
    """Plain PyTorch version of the backward kernels, with their rounding
    points. From the forward's inputs, its statistics [B, 2, Co] and dy
    [B, T, F, Co] -> (dx in x's dtype, dK [3, 3, Ci, Co] f32, db [Co]
    f32)."""
    r, e, n = _pre(x, kernel, bias)
    t_len, f_len = x.shape[1:3]
    mu = stats[:, 0].float()[:, None, None]
    rs = stats[:, 1].float()[:, None, None]
    ehat = (e - mu) * rs
    dy32 = r(dy)
    sa = dy32.sum(dim=(1, 2), keepdim=True)
    sb = r(dy32 * ehat).sum(dim=(1, 2), keepdim=True)
    de = rs * (dy32 - sa / n - ehat * (sb / n))
    dout = r(de * torch.where(e > 0, 1.0, e + 1.0))
    db = dout.sum(dim=(0, 1, 2))
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    dk = torch.stack([
        torch.stack([
            torch.einsum("btfi,btfo->io",
                         xp[:, dt:dt + t_len, df:df + f_len], dout)
            for df in range(3)])
        for dt in range(3)])
    dx = _conv3x3(dout, r(kernel).flip(0, 1).transpose(2, 3)).to(x.dtype)
    return dx, dk, db


def _scratch(library: str, name: str, dims, dtype, device):
    """The two scratch buffers a pass needs, as its C query `name` sizes
    them: (stream's dtype, f32)."""
    from wesep_tpu_torch.ops._build import load_library

    query = getattr(load_library(library), name)
    query.argtypes = [ctypes.c_int] * len(dims) \
        + [ctypes.POINTER(ctypes.c_longlong)] * 2
    query.restype = None
    n_stream, n_f32 = ctypes.c_longlong(), ctypes.c_longlong()
    query(*dims, ctypes.byref(n_stream), ctypes.byref(n_f32))
    return (torch.empty(n_stream.value, dtype=dtype, device=device),
            torch.empty(n_f32.value, dtype=torch.float32, device=device))


def kernel_fits(ci: int, co: int) -> bool:
    """Whether the kernels take a block of Ci input and Co output channels:
    multiples of 8, at most 256."""
    return 0 < ci <= MAX_CHANNELS and 0 < co <= MAX_CHANNELS \
        and ci % 8 == 0 and co % 8 == 0


def _kernel_args(x, kernel, bias):
    """Check what the kernels take and return (x, kernel, bias) as they
    take them: x and the kernel in the stream's dtype, the bias f32, all
    contiguous and 16-byte aligned."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, T, F, Ci], got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"conv2d_block_in takes float32 or bfloat16, not {x.dtype}")
    batch, t_len, f_len, ci = x.shape
    co = kernel.shape[-1]
    if tuple(kernel.shape) != (3, 3, ci, co) or tuple(bias.shape) != (co,):
        raise ValueError(
            f"kernel must be [3, 3, {ci}, Co] and bias [Co]; got "
            f"{tuple(kernel.shape)}, {tuple(bias.shape)}")
    if (not kernel_fits(ci, co) or not 0 < batch <= 65535 or t_len == 0
            or f_len == 0):
        raise ValueError(
            f"kernel needs Ci and Co multiples of 8, at most {MAX_CHANNELS}, "
            f"and a non-empty x with B <= 65535; got x {tuple(x.shape)}, "
            f"Co={co}")
    if kernel.device != x.device or bias.device != x.device:
        raise ValueError("all tensors must be on x's device")
    return (_aligned(x.detach()), _aligned(kernel.detach().to(x.dtype)),
            _aligned(bias.detach().float()))


def _forward_cuda(x, kernel, bias, eps):
    """Launch the forward kernels -> (y, stats [B, 2, Co])."""
    x, kernel, bias = _kernel_args(x, kernel, bias)
    batch, t_len, f_len, ci = x.shape
    co = kernel.shape[-1]
    dims = (batch, t_len, f_len, ci, co)
    y = torch.empty(batch, t_len, f_len, co, dtype=x.dtype, device=x.device)
    stats = torch.empty(batch, 2, co, dtype=torch.float32, device=x.device)
    _, f32_ws = _scratch("conv2d_block", "conv2d_block_forward_scratch", dims,
                         x.dtype, x.device)
    _launch(conv2d_block_in,
            _entry("conv2d_block", "conv2d_block_forward", 6, 6, 1),
            (x, kernel, bias, y, stats, f32_ws),
            (*dims, _DTYPE_CODES[x.dtype], float(eps)), x.device)
    return y, stats


def conv2d_block_in_backward(x, kernel, bias, stats, dy):
    """The backward; arguments and results as
    `conv2d_block_in_backward_reference`. On CUDA tensors it launches the
    kernels (the flipped, transposed kernel the dx conv reads is made here
    once per call; the scratch lives only for the call), on CPU tensors it
    runs the plain version."""
    if not _on_kernel_path(False, x):
        return conv2d_block_in_backward_reference(x, kernel, bias, stats, dy)
    x, kernel, bias = _kernel_args(x, kernel, bias)
    batch, t_len, f_len, ci = x.shape
    co = kernel.shape[-1]
    if tuple(dy.shape) != (batch, t_len, f_len, co) or dy.device != x.device:
        raise ValueError(f"dy must be [B, T, F, Co], got {tuple(dy.shape)}")
    if tuple(stats.shape) != (batch, 2, co) or stats.device != x.device:
        raise ValueError(f"stats must be [B, 2, Co], got {tuple(stats.shape)}")
    dims = (batch, t_len, f_len, ci, co)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dk = torch.empty(3, 3, ci, co, **f32)
    db = torch.empty(co, **f32)
    stream_ws, f32_ws = _scratch("conv2d_block_bwd",
                                 "conv2d_block_backward_scratch", dims,
                                 x.dtype, x.device)
    _launch(conv2d_block_in_backward,
            _entry("conv2d_block_bwd", "conv2d_block_backward", 11, 6),
            (x, kernel, _aligned(kernel.flip(0, 1).transpose(2, 3)), bias,
             _aligned(stats.float()), _aligned(dy.detach().to(x.dtype)), dx,
             dk, db, stream_ws, f32_ws),
            (*dims, _DTYPE_CODES[x.dtype]), x.device)
    return dx, dk, db


conv2d_block_in_backward.launches = 0


def _on_kernel_path(plain: bool, x) -> bool:
    if plain or x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(
            f"conv2d_block_in runs on cuda or cpu, not {x.device}")
    return True


class Conv2dBlockFn(torch.autograd.Function):
    """The block with its hand-written backward, on both devices.

    It takes the kernel and bias as they are stored (f32) and casts them
    inside, so their gradients come back in their own dtype from f32 sums,
    whatever the stream's dtype. `plain` runs the plain versions on any
    device; `save` says whether a gradient may be asked for."""

    @staticmethod
    def forward(ctx, plain, save, eps, x, kernel, bias):
        if _on_kernel_path(plain, x):
            y, stats = _forward_cuda(x, kernel, bias, eps)
        else:
            y, stats = conv2d_block_in_reference(x, kernel, bias, eps,
                                                 return_stats=True)
        if save:
            ctx.plain = plain
            ctx.save_for_backward(x, kernel, bias, stats)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, kernel, bias, stats = ctx.saved_tensors
        run = conv2d_block_in_backward if _on_kernel_path(ctx.plain, x) \
            else conv2d_block_in_backward_reference
        dx, dk, db = run(x, kernel, bias, stats, dy)
        return None, None, None, dx, dk.to(kernel.dtype), db.to(bias.dtype)


def conv2d_block_in(x, kernel, bias, eps: float = 1e-5, plain: bool = False):
    """y = InstanceNorm(ELU(conv3x3(x) + bias)), stride 1, pad 1, NHWC
    (argument order of pallas_conv2d.conv2d_block_in): x [B, T, F, Ci],
    kernel [3, 3, Ci, Co] HWIO, bias [Co] -> [B, T, F, Co] in x's dtype.
    Differentiable in x, the kernel and the bias."""
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, kernel, bias))
    return Conv2dBlockFn.apply(plain, save, float(eps), x, kernel, bias)


conv2d_block_in.launches = 0
