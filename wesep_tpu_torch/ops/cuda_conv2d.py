"""Fused DPCCN Conv2dBlock: CUDA kernel wrappers and plain versions.

Counterpart of wesep_tpu/ops/pallas_conv2d.py `conv2d_block_in`, forward
and backward. The kernels live in csrc/conv2d_block.cu (forward) and
csrc/conv2d_block_bwd.cu (backward): bf16 streams take implicit-GEMM
convolutions on the tensor cores with the block's elementwise work in their
epilogues (csrc/conv2d_tc.cuh), f32 streams tiled convolutions on the FMA
units (csrc/conv2d_common.cuh); their headers say what bounds them and how
they are laid out. Channels-last, stride 1, pad 1:

    y = InstanceNorm(ELU(conv3x3(x) + bias)),  x [B, T, F, Ci], y [B, T, F, Co]

`Conv2dBlockFn` is a `torch.autograd.Function` on both devices. It saves
only x, the kernel, the bias and the statistics (mu, rs) [B, 2, Co], as the
JAX custom VJP does, and the backward recomputes e. On CUDA tensors its
forward and backward launch the kernels; on CPU tensors they run the plain
versions `conv2d_block_in_reference` and
`conv2d_block_in_backward_reference`. Anything else raises: there is no
fallback from a failed build or launch. Each wrapper counts its launches:
`conv2d_block_in.launches`, `conv2d_block_in_backward.launches`.

What the kernels need from the host is planned here, from the shapes: the
scratch of each pass (`forward_plan`, `backward_plan`, mirrors of the C
`_scratch` entry points, which refuse less) and the blocks of the backward's
dK pass (`dk_blocks`: one wave of the card, block g walking the tiles g,
g + blocks, ...). `cuda_tcn.launch_times` runs one pass with a CUDA
event after each launch (`FORWARD_LAUNCHES`, `BACKWARD_LAUNCHES`).

Rounding points (they matter for a bf16 stream; for f32 every rounding is
the identity). x is in the stream's dtype and the kernel is rounded to it
where the products take it, the products accumulate in f32, the bias and e = ELU(conv + b) are f32. The statistics
sum round(e) and round(e * e); y rounds (e - mu) * rs from the unrounded e.
Backward: S_b sums round(dy * e_hat); dout is rounded before db's sum and
before both products (dK in f32, dx rounded once).

Kernel limits (`csrc/conv2d_common.cuh`): Ci and Co multiples of 8, at
most 256; B at most 65535 a launch (a grid dimension), so a larger batch
runs in slices of that many samples (`cuda_tcn.run_in_batch_chunks`: the
statistics are per sample). DPCCN's gated convs have Ci <= 32, Co 16 or
32.
"""

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable
from torch.nn import functional as F

from wesep_tpu_torch.ops.cuda_lstm import _launch
from wesep_tpu_torch.ops.cuda_tcn import _aligned, run_in_batch_chunks

__all__ = ["kernel_fits", "conv2d_block_in", "conv2d_block_in_reference",
           "conv2d_block_in_backward", "conv2d_block_in_backward_reference",
           "Conv2dBlockFn", "forward_plan", "backward_plan", "dk_units",
           "dk_blocks", "FORWARD_LAUNCHES", "BACKWARD_LAUNCHES"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHANNELS = 256  # csrc/conv2d_common.cuh kMaxC
# csrc/conv2d_tc.cuh (bf16): positions of a tile; csrc/conv2d_common.cuh
# and conv2d_block_bwd.cu (f32): columns of a conv tile, rows of a dK tile,
# positions of a dout block, most dK blocks
_TC_TILE = 128
_TC_WARPS = 4  # warps of a bf16 tile, each writing its own partial sums
_F32_COLS = 32
_F32_DK_ROWS = 4
_F32_DOUT_CHUNK = 1024
# the launches of each pass in order, as the C entry points mark them
FORWARD_LAUNCHES = {
    torch.float32: ("conv", "reduce", "norm"),
    torch.bfloat16: ("conv stats", "reduce", "conv norm")}
BACKWARD_LAUNCHES = {
    torch.float32: ("conv", "reduce", "dout", "dx conv", "dK", "dK sum",
                    "db sum"),
    torch.bfloat16: ("conv sums", "reduce", "conv dout dK", "dK sum",
                     "db sum", "dx conv")}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _f32_conv_tiles(t_len: int, f_len: int, co: int) -> int:
    """Tiles per sample of the f32 conv kernel: 16, 8 or 4 rows (Co <= 16,
    <= 32, more) x 32 columns (conv_tiles)."""
    rows = 16 if co <= 16 else 8 if co <= 32 else 4
    return _cdiv(t_len, rows) * _cdiv(f_len, _F32_COLS)


def _tc_tiles(t_len: int, f_len: int) -> int:
    """Tiles per sample of the bf16 passes: 128 consecutive positions
    t * F + f each (tc_tiles)."""
    return _cdiv(t_len * f_len, _TC_TILE)


def forward_plan(batch, t_len, f_len, ci, co, dtype):
    """(elements of the stream's dtype, floats) of the forward's scratch,
    as conv2d_block_forward_scratch gives them: f32, e [B, T, F, Co] and
    the per-tile sums (two per channel); bf16, only the sums of each warp of
    each tile, f64 (two floats each)."""
    del ci
    if dtype == torch.float32:
        return 0, (batch * t_len * f_len * co
                   + 2 * batch * _f32_conv_tiles(t_len, f_len, co) * co)
    return 0, 2 * (2 * batch * _tc_tiles(t_len, f_len) * _TC_WARPS * co)


def dk_units(batch, t_len, f_len, dtype) -> int:
    """Tiles the backward's dK blocks share out: f32, of 4 rows x 32
    columns; bf16, of 128 positions (dk_units)."""
    if dtype == torch.float32:
        return batch * _cdiv(t_len, _F32_DK_ROWS) * _cdiv(f_len, _F32_COLS)
    return batch * _tc_tiles(t_len, f_len)


def dk_blocks(units, ci, co, dtype, slots) -> int:
    """Blocks of the dK pass: the `slots` that one wave of the card holds
    (conv2d_block_backward_slots), shared by the bf16 grid's chunks of 32
    input channels (16 at Ci <= 16) and slabs of 32 output channels (16
    at Co <= 16); at most one block a tile, at least one."""
    if dtype == torch.float32:
        per_block = 1
    else:
        kc, nb = (16 if ci <= 16 else 32), (16 if co <= 16 else 32)
        per_block = _cdiv(ci, kc) * _cdiv(co, nb)
    return max(1, min(units, slots // per_block))


def backward_plan(batch, t_len, f_len, ci, co, dtype, slots):
    """(dK blocks, elements of the stream's dtype, floats) of the
    backward's scratch, as conv2d_block_backward_scratch gives them. Stream:
    dout. f32: e, the per-tile sums, S_a and S_b, db per 1024 positions of
    a sample, dK per block. bf16, f64 first (two floats each): the sums of
    each warp of each tile, S_a and S_b, db per block; then dK per block,
    f32."""
    blocks = dk_blocks(dk_units(batch, t_len, f_len, dtype), ci, co, dtype,
                       slots)
    elems = batch * t_len * f_len * co
    if dtype == torch.float32:
        n_f32 = (elems + 2 * batch * _f32_conv_tiles(t_len, f_len, co) * co
                 + 2 * batch * co
                 + batch * _cdiv(t_len * f_len, _F32_DOUT_CHUNK) * co
                 + 9 * blocks * ci * co)
    else:
        n_f32 = (2 * (2 * batch * _tc_tiles(t_len, f_len) * _TC_WARPS * co
                      + 2 * batch * co + blocks * co)
                 + 9 * blocks * ci * co)
    return blocks, elems, n_f32


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


def _argtypes(entry: str):
    """ctypes types of a C entry point's arguments, in order."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return {
        "conv2d_block_forward":
            [ptr] * 7 + [i32] * 7 + [i64, ctypes.c_float, ptr],
        "conv2d_block_backward": [ptr] * 12 + [i32] * 8 + [i64] * 2 + [ptr],
        "conv2d_block_backward_slots": [i32] * 3,
    }[entry]


@functools.lru_cache(maxsize=None)
def _library(name: str):
    """The library of csrc/<name>.cu with its entry points' signatures,
    built and loaded at first use."""
    from wesep_tpu_torch.ops._build import load_library

    lib = load_library(name)
    entries = ("conv2d_block_forward",) if name == "conv2d_block" else (
        "conv2d_block_backward", "conv2d_block_backward_slots")
    for entry in entries:
        getattr(lib, entry).argtypes = _argtypes(entry)
        getattr(lib, entry).restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _slots(ci: int, co: int, dtype, device) -> int:
    """Blocks of the dK pass one wave of the card holds."""
    with torch.cuda.device(device):
        n = _library("conv2d_block_bwd").conv2d_block_backward_slots(
            ci, co, _DTYPE_CODES[dtype])
    if n <= 0:
        raise RuntimeError("conv2d_block_in_backward: the card's occupancy "
                           "query failed")
    return n


def kernel_fits(ci: int, co: int) -> bool:
    """Whether the kernels take a block of Ci input and Co output channels:
    multiples of 8, at most 256."""
    return 0 < ci <= MAX_CHANNELS and 0 < co <= MAX_CHANNELS \
        and ci % 8 == 0 and co % 8 == 0


def _kernel_args(x, kernel, bias):
    """Check what the kernels take and return (x, kernel, bias) as they
    take them: x in the stream's dtype, the kernel and the bias f32 (a
    bf16 stream's kernels round K as they stage it), all contiguous and
    16-byte aligned."""
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
    if (not kernel_fits(ci, co) or batch == 0 or t_len == 0
            or f_len == 0):
        raise ValueError(
            f"kernel needs Ci and Co multiples of 8, at most {MAX_CHANNELS}, "
            f"and a non-empty x; got x {tuple(x.shape)}, Co={co}")
    if kernel.device != x.device or bias.device != x.device:
        raise ValueError("all tensors must be on x's device")
    return (_aligned(x.detach()), _aligned(kernel.detach().float()),
            _aligned(bias.detach().float()))


def _forward_cuda(x, kernel, bias, eps, events=None):
    """Launch the forward kernels -> (y, stats [B, 2, Co]), in slices of at
    most cuda_tcn.MAX_GRID_BATCH samples (the statistics are per sample);
    `events` (one batch slice only): CUDA event handles, as
    `cuda_tcn.launch_times` makes them."""
    x, kernel, bias = _kernel_args(x, kernel, bias)
    return run_in_batch_chunks(
        lambda b0, b1: _forward_slice(x[b0:b1], kernel, bias, eps, events),
        x.shape[0])


def _forward_slice(x, kernel, bias, eps, events):
    """The forward kernels over a batch they take, operands prepared."""
    batch, t_len, f_len, ci = x.shape
    co = kernel.shape[-1]
    y = torch.empty(batch, t_len, f_len, co, dtype=x.dtype, device=x.device)
    stats = torch.empty(batch, 2, co, dtype=torch.float32, device=x.device)
    _, n_f32 = forward_plan(batch, t_len, f_len, ci, co, x.dtype)
    f32_ws = torch.empty(n_f32, dtype=torch.float32, device=x.device)
    _launch(conv2d_block_in,
            _library("conv2d_block").conv2d_block_forward,
            (x, kernel, bias, y, stats, f32_ws, events),
            (batch, t_len, f_len, ci, co, _DTYPE_CODES[x.dtype],
             _n_events(events), n_f32, float(eps)), x.device)
    return y, stats


def conv2d_block_in_backward(x, kernel, bias, stats, dy, events=None):
    """The backward; arguments and results as
    `conv2d_block_in_backward_reference`. On CUDA tensors it launches the
    kernels (the scratch lives only for the call), on CPU tensors it runs
    the plain version. `events` as `_forward_cuda` takes them. An f32
    stream's dx conv reads K flipped and transposed, made here once a call;
    a bf16 stream's reads K so as it stages it."""
    if not _on_kernel_path(False, x):
        return conv2d_block_in_backward_reference(x, kernel, bias, stats, dy)
    x, kernel, bias = _kernel_args(x, kernel, bias)
    batch, t_len, f_len, ci = x.shape
    co = kernel.shape[-1]
    if tuple(dy.shape) != (batch, t_len, f_len, co) or dy.device != x.device:
        raise ValueError(f"dy must be [B, T, F, Co], got {tuple(dy.shape)}")
    if tuple(stats.shape) != (batch, 2, co) or stats.device != x.device:
        raise ValueError(f"stats must be [B, 2, Co], got {tuple(stats.shape)}")
    stats = _aligned(stats.float())
    dy = _aligned(dy.detach().to(x.dtype))
    flipped = _aligned(kernel.flip(0, 1).transpose(2, 3)) \
        if x.dtype == torch.float32 else None
    # dx per sample; dK and db summed over the slices
    return run_in_batch_chunks(
        lambda b0, b1: _backward_slice(x[b0:b1], kernel, flipped, bias,
                                       stats[b0:b1], dy[b0:b1], events),
        batch, summed=(1, 2))


def _backward_slice(x, kernel, flipped, bias, stats, dy, events):
    """The backward kernels over a batch they take, operands prepared."""
    batch, t_len, f_len, ci = x.shape
    co = kernel.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dk = torch.empty(3, 3, ci, co, **f32)
    db = torch.empty(co, **f32)
    blocks, n_stream, n_f32 = backward_plan(
        batch, t_len, f_len, ci, co, x.dtype,
        _slots(ci, co, x.dtype, x.device))
    stream_ws = torch.empty(n_stream, dtype=x.dtype, device=x.device)
    f32_ws = torch.empty(n_f32, **f32)
    _launch(conv2d_block_in_backward,
            _library("conv2d_block_bwd").conv2d_block_backward,
            (x, kernel, flipped, bias, stats, dy, dx, dk, db, stream_ws,
             f32_ws, events),
            (batch, t_len, f_len, ci, co, _DTYPE_CODES[x.dtype],
             _n_events(events), blocks, n_stream, n_f32), x.device)
    return dx, dk, db


conv2d_block_in_backward.launches = 0


def _n_events(events) -> int:
    return 0 if events is None else len(events)


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
