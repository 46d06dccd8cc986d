"""Fused gLN TCN block: CUDA kernel wrappers and plain versions.

Counterpart of wesep_tpu/ops/pallas_tcn.py `tcn_block_gln`, forward and
backward. The kernels live in csrc/tcn_block.cu (forward) and
csrc/tcn_block_bwd.cu (backward), their products in csrc/tcn_common.cuh
(bf16 on the tensor cores, f32 on the FMA units); their headers say what
bounds them and how they are laid out. What the kernels need from
the host is planned here, from the shapes alone: the scratch of each pass
(`forward_plan`, `backward_plan`) and the rows per split of the weight
gradients (`wgrad_rows`); the C entry points refuse scratch smaller than
their own layout. `launch_times` runs one pass with a CUDA event after
each launch.

    y = x + conv2(gLN1(PReLU(dconv(gLN0(PReLU(x @ w1 + b1_eff))))))

`tcn_block_gln` is a `torch.autograd.Function` on both devices. On CUDA
tensors its forward launches the forward kernels and its backward the
backward kernels (from x, dy and the four saved statistics; u is
recomputed; a batch past one grid dimension, MAX_GRID_BATCH samples, in
slices); on CPU tensors it runs the plain versions
`tcn_block_gln_reference` and `tcn_block_gln_backward_reference`. Anything
else raises: there is no fallback from a failed build or launch. Each
wrapper counts its calls: `tcn_block_gln.launches`,
`tcn_block_gln_backward.launches`.

Rounding points (they matter for a bf16 stream; for f32 every rounding is
the identity). Parameters are f32 and are rounded to the stream's dtype
where a product or the depthwise conv takes them. Forward: u is rounded
before its statistics are summed; n0, the taps, v and w are formed op by op
in the stream's dtype; g1w * w and q are rounded; the combine
x + rs1 * q + corr is f32. Backward: n0, v are recomputed in f32 and w is
rounded; round(n1), round(dv) and round(ds) feed the products and the
gather while db1_eff, dbd, dkd, dp0, dp1 sum the unrounded values; dn0 is
accumulated in the stream's dtype.
"""

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable
from torch.nn import functional as F

from wesep_tpu_torch.ops.cuda_lstm import _launch

__all__ = ["kernel_fits", "tcn_block_gln", "tcn_block_gln_reference",
           "tcn_block_gln_backward", "tcn_block_gln_backward_reference",
           "TCNBlockFn", "MAX_GRID_BATCH", "batch_chunks",
           "run_in_batch_chunks", "wgrad_rows", "forward_plan",
           "backward_plan", "FORWARD_LAUNCHES", "BACKWARD_LAUNCHES",
           "launch_times"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/tcn_common.cuh: kMaxTaps; kTile, the rows and columns of a product's
# tile and of an elementwise pass's block, whose sums are the partials;
# kShortTile, the rows of an f32 product's tile where tiles of 128 are few
_MAX_TAPS = 8
_TILE = 128
_SHORT_TILE = 64
# a weight-gradient product aims at two blocks on each of the H100's 132
# SMs, over splits of at least 512 rows, each a multiple of 32 (a stage's
# depth)
_WGRAD_BLOCKS = 264
_WGRAD_MIN_ROWS = 512
_WGRAD_ROW_STEP = 32
# the launches of each pass in order, as the C entry points mark them
FORWARD_LAUNCHES = ("u product", "u stats", "dconv", "w stats", "corr",
                    "out product")
BACKWARD_LAUNCHES = (
    "u product", "gln1 product", "gln1 sums", "gln1 sums", "dv product",
    "dv sums", "dv sums", "dW2 product", "dW2 sum", "db2 colsum", "db2 sum",
    "dn0", "dn0 sums", "dn0 sums", "ds product", "ds sums", "ds sums",
    "dx product", "dW1 product", "dW1 sum")
# samples a launch of the TCN or Conv2dBlock kernels takes: the batch is a
# grid dimension (csrc/tcn_common.cuh, csrc/conv2d_common.cuh)
MAX_GRID_BATCH = 65535


def batch_chunks(batch: int, most: int = MAX_GRID_BATCH):
    """[(b0, b1), ...] in order, covering range(batch) in slices of at most
    `most` samples."""
    return [(b0, min(b0 + most, batch)) for b0 in range(0, batch, most)]


def run_in_batch_chunks(run, batch: int, summed=(), most=MAX_GRID_BATCH):
    """run(b0, b1) -> a tuple of results for samples b0:b1, once per slice
    of `batch_chunks`: every statistic of the TCN and Conv2dBlock kernels is
    per sample, so a batch the grid does not take runs exactly as slices.
    Results with an index in `summed` (weight gradients) are added over
    the slices in order, the others (per sample) joined along axis 0."""
    if batch <= most:
        return run(0, batch)
    chunks = batch_chunks(batch, most)
    parts = [run(b0, b1) for b0, b1 in chunks]
    out = []
    for i, first in enumerate(parts[0]):
        if i in summed:
            total = first.clone()
            for part in parts[1:]:
                total += part[i]
            out.append(total)
        else:
            out.append(torch.cat([part[i] for part in parts]))
    return tuple(out)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wgrad_rows(rows: int, c: int, h: int) -> int:
    """Rows of the B * T rows per split of the weight-gradient products
    dW1 [C, H] and dW2 [H, C]: enough splits that the 128 x 128 tiles times
    the splits fill _WGRAD_BLOCKS blocks, none shorter than
    _WGRAD_MIN_ROWS rows (a product's partials are summed in order, so
    every split costs a [C, H] partial), rounded up to a multiple of 32."""
    tiles = _cdiv(c, _TILE) * _cdiv(h, _TILE)
    splits = max(1, min(_cdiv(rows, _WGRAD_MIN_ROWS),
                        _cdiv(_WGRAD_BLOCKS, tiles)))
    return _cdiv(_cdiv(rows, splits), _WGRAD_ROW_STEP) * _WGRAD_ROW_STEP


def forward_plan(batch: int, t_len: int, c: int, h: int):
    """(elements of the stream's dtype, floats) of the forward's scratch
    for one batch slice: u and g1w * w; the two sums (f64, two floats
    each) of u of each tile of the u product (of 64 rows at most, the f32
    short tiles) and of w of each 128 x 128 block of the dconv pass; and
    corr."""
    columns = _cdiv(h, _TILE)
    u_tiles = _cdiv(t_len, _SHORT_TILE) * columns
    w_blocks = _cdiv(t_len, _TILE) * columns
    return 2 * batch * t_len * h, 4 * batch * (u_tiles + w_blocks) + batch * c


def backward_plan(batch: int, t_len: int, c: int, h: int, k: int):
    """(wgrad_rows, elements of the stream's dtype, floats) of the
    backward for one batch slice. Stream scratch: u, round(n1) (reused for
    dn0, then round(ds)), round(dv). f32 scratch: the scalar partials (two per
    128 x 128 block) and two pairs of per-sample sums, all f64 (two floats
    each); the per-channel partials of the widest sum (1 + k vectors of H,
    or db2's C, per chunk of 128 rows); the weight gradients' split
    partials."""
    chunks = batch * _cdiv(t_len, _TILE)
    per = wgrad_rows(batch * t_len, c, h)
    splits = _cdiv(batch * t_len, per)
    n_f32 = (4 * chunks * _cdiv(h, _TILE) + 8 * batch
             + chunks * max((1 + k) * h, c) + splits * h * c)
    return per, 3 * batch * t_len * h, n_f32


def _pads(dilation: int, k: int, causal: bool):
    """(rows of zeros before, after) the normalized stream."""
    span = dilation * (k - 1)
    pad_lo = span if causal else span // 2
    return pad_lo, span - pad_lo


def _prelu(x, p):
    return torch.where(x >= 0, x, p * x)


def _gln_stats(t, eps):
    """Per-sample mean and 1/sqrt(var + eps) over all but the batch axis of
    an f32 tensor [B, T, H], single pass: var = max(E[t^2] - mean^2, 0)."""
    nhw = float(t.shape[1] * t.shape[2])
    mu = t.sum(dim=(1, 2)) / nhw
    var = ((t * t).sum(dim=(1, 2)) / nhw - mu * mu).clamp_min(0.0)
    return mu, 1.0 / torch.sqrt(var + eps)


def _taps(n0, dilation, k, pad_lo, pad_hi):
    """The k zero-padded shifted views of n0 [B, T, H] the conv reads."""
    t_len = n0.shape[1]
    padded = F.pad(n0, (0, 0, pad_lo, pad_hi))
    return [padded[:, kk * dilation:kk * dilation + t_len] for kk in range(k)]


def tcn_block_gln_reference(x, b1_eff, w1, p0, kd, bd, g0w, g0b, p1, w2, b2,
                            g1w, g1b, dilation, k, causal, eps,
                            return_stats: bool = False):
    """Plain PyTorch version of the forward kernels, with the same rounding
    points.

    x [B, T, C] (f32 or bf16); b1_eff [B, H]; w1 [C, H]; p0, p1 PReLU
    slopes (one element each); kd [k, H]; bd, g0w, g0b, g1w, g1b [H];
    w2 [H, C]; b2 [C] -> y [B, T, C] in x's dtype and, with `return_stats`,
    stats [B, 4] f32 = (mu0, rs0, mu1, rs1).
    """
    dt = x.dtype
    r = lambda t: t.to(dt).float()  # noqa: E731 - round through the stream
    x32 = x.float()
    p0, p1 = p0.float().reshape(()), p1.float().reshape(())
    pad_lo, pad_hi = _pads(dilation, k, causal)
    s = torch.matmul(x32, r(w1)) + b1_eff.float()[:, None, :]
    u = r(_prelu(s, p0))
    mu0, rs0 = _gln_stats(u, eps)
    a0 = g0w.float()[None, :] * rs0[:, None]
    c0 = g0b.float()[None, :] - mu0[:, None] * a0
    n0 = r(r(r(a0)[:, None, :] * u) + r(c0)[:, None, :])
    v = r(bd).expand_as(u)
    for kk, tap in enumerate(_taps(n0, dilation, k, pad_lo, pad_hi)):
        v = r(v + r(r(kd[kk]) * tap))
    w = torch.where(v >= 0, v, r(r(p1) * v))
    mu1, rs1 = _gln_stats(w, eps)
    q = r(torch.matmul(r(r(g1w) * w), r(w2)))
    c1 = g1b.float()[None, :] - mu1[:, None] * g1w.float()[None, :] \
        * rs1[:, None]
    corr = torch.matmul(r(c1), r(w2)) + b2.float()[None, :]
    y = (x32 + rs1[:, None, None] * q + corr[:, None, :]).to(dt)
    if return_stats:
        return y, torch.stack([mu0, rs0, mu1, rs1], dim=1)
    return y


def tcn_block_gln_backward_reference(x, b1_eff, w1, p0, kd, bd, g0w, g0b, p1,
                                     w2, b2, g1w, g1b, stats, dy, dilation,
                                     k, causal, eps):
    """Plain PyTorch version of the backward kernels, step by step with the
    same rounding points.

    Takes the forward's inputs, its statistics [B, 4] and the cotangent dy
    [B, T, C]; returns (dx, db1_eff, dw1, dp0, dkd, dbd, dg0w, dg0b, dp1,
    dw2, db2, dg1w, dg1b): dx in x's dtype, the rest f32 (dp0, dp1 with
    one element).
    """
    dt = x.dtype
    r = lambda t: t.to(dt).float()  # noqa: E731
    x32, dyc = x.float(), dy.to(dt).float()
    p0, p1 = p0.float().reshape(()), p1.float().reshape(())
    g0w, g0b, g1w, g1b = (t.float() for t in (g0w, g0b, g1w, g1b))
    pad_lo, pad_hi = _pads(dilation, k, causal)
    t_len = x.shape[1]
    nhw = float(t_len * w1.shape[1])
    mu0, rs0, mu1, rs1 = (stats[:, i].float()[:, None, None]
                          for i in range(4))
    w1c, w2c, kdc = r(w1), r(w2), r(kd)

    s = torch.matmul(x32, w1c) + b1_eff.float()[:, None, :]
    u = r(_prelu(s, p0))
    a0 = g0w * rs0
    n0 = a0 * u + (g0b - mu0 * a0)
    taps = _taps(n0, dilation, k, pad_lo, pad_hi)
    v = bd.float().expand_as(u)
    for kk in range(k):
        v = v + kdc[kk] * taps[kk]
    w = r(_prelu(v, p1))
    s1hat = (w - mu1) * rs1
    n1 = g1w * s1hat + g1b

    dn1 = torch.matmul(dyc, w2c.t())
    dw2 = torch.einsum("bth,btc->hc", r(n1), dyc)
    db2 = dyc.sum(dim=(0, 1))
    dg1 = (dn1 * s1hat).sum(dim=(0, 1))
    dbe1 = dn1.sum(dim=(0, 1))
    m0 = (g1w * dn1).sum(dim=(1, 2), keepdim=True) / nhw
    m1 = (g1w * dn1 * s1hat).sum(dim=(1, 2), keepdim=True) / nhw
    dw = rs1 * (g1w * dn1 - m0 - s1hat * m1)
    dp1 = (dw * v.clamp_max(0.0)).sum()
    dv = dw * torch.where(v >= 0, 1.0, p1)
    dbd = dv.sum(dim=(0, 1))
    dkd = torch.stack([(dv * taps[kk]).sum(dim=(0, 1)) for kk in range(k)])

    # adjoint of the depthwise conv as a gather of round(dv) at the
    # mirrored shifts, accumulated in the stream's dtype
    dvp = F.pad(r(dv), (0, 0, pad_hi, pad_lo))
    dn0 = torch.zeros_like(u)
    for kk in range(k):
        start = (k - 1 - kk) * dilation
        dn0 = r(dn0 + r(kdc[kk] * dvp[:, start:start + t_len]))
    s0hat = (u - mu0) * rs0
    dg0 = (dn0 * s0hat).sum(dim=(0, 1))
    dbe0 = dn0.sum(dim=(0, 1))
    m2 = (g0w * dn0).sum(dim=(1, 2), keepdim=True) / nhw
    m3 = (g0w * dn0 * s0hat).sum(dim=(1, 2), keepdim=True) / nhw
    du = rs0 * (g0w * dn0 - m2 - s0hat * m3)
    dp0 = (du * s.clamp_max(0.0)).sum()
    ds = du * torch.where(s >= 0, 1.0, p0)
    db1e = ds.sum(dim=1)
    dsc = r(ds)
    dx = (dyc + torch.matmul(dsc, w1c.t())).to(dt)
    dw1 = torch.einsum("btc,bth->ch", x32, dsc)
    return (dx, db1e, dw1, dp0.reshape(1), dkd, dbd, dg0, dbe0,
            dp1.reshape(1), dw2, db2, dg1, dbe1)


def _argtypes(entry: str):
    """ctypes types of a C entry point's arguments, in order."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return {
        "tcn_block_forward":
            [ptr] * 18 + [i32] * 9 + [i64] * 2 + [ctypes.c_float, ptr],
        "tcn_block_backward": [ptr] * 27 + [i32] * 9 + [i64] * 3 + [ptr],
    }[entry]


@functools.lru_cache(maxsize=None)
def _library(name: str):
    """The library of csrc/<name>.cu with its entry point's signature,
    built and loaded at first use."""
    from wesep_tpu_torch.ops._build import load_library

    lib = load_library(name)
    entry = "tcn_block_forward" if name == "tcn_block" else \
        "tcn_block_backward"
    getattr(lib, entry).argtypes = _argtypes(entry)
    getattr(lib, entry).restype = ctypes.c_int
    return lib


def _scratch(n_stream, n_f32, dtype, device):
    """The two scratch buffers a pass needs (stream dtype, f32)."""
    return (torch.empty(n_stream, dtype=dtype, device=device),
            torch.empty(n_f32, dtype=torch.float32, device=device))


def kernel_fits(c: int, h: int, k: int) -> bool:
    """Whether the kernels take a block of C channels, H hidden channels
    and k taps: C % 8 == 0, H % 8 == 0 and 0 < k <= 8."""
    return c > 0 and h > 0 and c % 8 == 0 and h % 8 == 0 \
        and 0 < k <= _MAX_TAPS


def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_args(x, b1_eff, w1, p0, kd, bd, g0w, g0b, p1, w2, b2, g1w, g1b,
                 k):
    """Check what the kernels take and return the thirteen tensors as they
    take them: x and the matrices w1, kd, w2 in the stream's dtype, the
    rest f32, all contiguous and 16-byte aligned."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, C], got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"tcn_block_gln takes float32 or bfloat16, not {x.dtype}")
    batch, t_len, c = x.shape
    h = w1.shape[1]
    if not kernel_fits(c, h, k) or batch == 0 or t_len == 0:
        raise ValueError(
            f"kernel needs C % 8 == 0, H % 8 == 0, 0 < k <= {_MAX_TAPS} and "
            f"a non-empty x; got C={c}, H={h}, k={k}, x {tuple(x.shape)}")
    shapes = (("b1_eff", b1_eff, (batch, h)), ("w1", w1, (c, h)),
              ("kd", kd, (k, h)), ("bd", bd, (h,)), ("g0w", g0w, (h,)),
              ("g0b", g0b, (h,)), ("w2", w2, (h, c)), ("b2", b2, (c,)),
              ("g1w", g1w, (h,)), ("g1b", g1b, (h,)))
    for name, t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: shape {tuple(t.shape)}, expected {shape}")
    for name, t in (("p0", p0), ("p1", p1)):
        if t.numel() != 1:
            raise ValueError(f"{name} must hold one element")
    every = (x, b1_eff, w1, p0, kd, bd, g0w, g0b, p1, w2, b2, g1w, g1b)
    if any(t.device != x.device for t in every):
        raise ValueError("all tensors must be on x's device")
    stream = lambda t: _aligned(t.detach().to(x.dtype))  # noqa: E731
    f32 = lambda t: _aligned(t.detach().float())  # noqa: E731
    return (stream(x), f32(b1_eff), stream(w1), f32(p0), stream(kd), f32(bd),
            f32(g0w), f32(g0b), f32(p1), stream(w2), f32(b2), f32(g1w),
            f32(g1b))


def _forward_cuda(x, b1_eff, w1, p0, kd, bd, g0w, g0b, p1, w2, b2, g1w, g1b,
                  dilation, k, causal, eps, events=None):
    """Launch the forward kernels -> (y, stats [B, 4]), in slices of at
    most MAX_GRID_BATCH samples; `events` (one batch slice only): CUDA
    event handles, as `launch_times` makes them."""
    x, b1_eff, *rest = _kernel_args(x, b1_eff, w1, p0, kd, bd, g0w, g0b, p1,
                                    w2, b2, g1w, g1b, k)
    return run_in_batch_chunks(
        lambda b0, b1: _forward_slice(x[b0:b1], b1_eff[b0:b1], *rest,
                                      dilation, k, causal, eps, events),
        x.shape[0])


def _forward_slice(*args):
    """The forward kernels over a batch they take, operands as
    `_kernel_args` returns them, then (dilation, k, causal, eps,
    events)."""
    *args, dilation, k, causal, eps, events = args
    x, w1 = args[0], args[2]
    batch, t_len, c = x.shape
    h = w1.shape[1]
    lib = _library("tcn_block")
    y = torch.empty_like(x)
    stats = torch.empty(batch, 4, dtype=torch.float32, device=x.device)
    n_stream, n_f32 = forward_plan(batch, t_len, c, h)
    stream_ws, f32_ws = _scratch(n_stream, n_f32, x.dtype, x.device)
    _launch(tcn_block_gln, lib.tcn_block_forward,
            (*args, y, stats, stream_ws, f32_ws, events),
            (batch, t_len, c, h, k, dilation, _pads(dilation, k, causal)[0],
             _DTYPE_CODES[x.dtype], 0 if events is None else len(events),
             n_stream, n_f32, float(eps)), x.device)
    return y, stats


def tcn_block_gln_backward(x, b1_eff, w1, p0, kd, bd, g0w, g0b, p1, w2, b2,
                           g1w, g1b, stats, dy, dilation, k, causal, eps,
                           events=None):
    """The backward kernels on CUDA tensors; arguments and results as
    `tcn_block_gln_backward_reference`. The transposes of w1 and w2 the
    products read are made here once per call; the scratch (three streams
    of [B, T, H] in x's dtype and the f32 partials, `backward_plan`) lives
    only for the call. `events` as `_forward_cuda` takes them."""
    del eps  # the statistics are given
    args = _kernel_args(x, b1_eff, w1, p0, kd, bd, g0w, g0b, p1, w2, b2, g1w,
                        g1b, k)
    (x, b1_eff, w1, p0, kd, bd, g0w, g0b, p1, w2, b2, g1w, g1b) = args
    batch = x.shape[0]
    if tuple(dy.shape) != tuple(x.shape) or dy.device != x.device:
        raise ValueError(f"dy must be like x, got {tuple(dy.shape)}")
    if tuple(stats.shape) != (batch, 4) or stats.device != x.device:
        raise ValueError(f"stats must be [B, 4], got {tuple(stats.shape)}")
    dy = _aligned(dy.detach().to(x.dtype))
    stats = _aligned(stats.float())
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    # dx and db1_eff are per sample, the other eleven summed over slices
    return run_in_batch_chunks(
        lambda b0, b1: _backward_slice(
            x[b0:b1], stats[b0:b1], dy[b0:b1], b1_eff[b0:b1], w1, w1t, p0,
            kd, bd, g0w, g0b, p1, w2t, g1w, g1b, dilation, k, causal,
            events),
        batch, summed=range(2, 13))


def _backward_slice(x, stats, dy, b1_eff, w1, w1t, p0, kd, bd, g0w, g0b, p1,
                    w2t, g1w, g1b, dilation, k, causal, events):
    """The backward kernels over a batch they take, operands prepared."""
    batch, t_len, c = x.shape
    h = w1.shape[1]
    lib = _library("tcn_block_bwd")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    db1e = torch.empty(batch, h, **f32)
    dw1 = torch.empty(c, h, **f32)
    dw2 = torch.empty(h, c, **f32)
    dvec_dv = torch.empty(1 + k, h, **f32)  # dbd, dkd
    dvec_g0 = torch.empty(2, h, **f32)      # dg0w, dg0b
    dvec_g1 = torch.empty(2, h, **f32)      # dg1w, dg1b
    db2 = torch.empty(c, **f32)
    dscal = torch.empty(2, **f32)           # dp0, dp1
    per, n_stream, n_f32 = backward_plan(batch, t_len, c, h, k)
    stream_ws, f32_ws = _scratch(n_stream, n_f32, x.dtype, x.device)
    _launch(tcn_block_gln_backward, lib.tcn_block_backward,
            (x, dy, stats, b1_eff, w1, w1t, p0, kd, bd, g0w, g0b, p1, w2t,
             g1w, g1b, dx, db1e, dw1, dw2, dvec_dv, dvec_g0, dvec_g1, db2,
             dscal, stream_ws, f32_ws, events),
            (batch, t_len, c, h, k, dilation, _pads(dilation, k, causal)[0],
             _DTYPE_CODES[x.dtype], 0 if events is None else len(events),
             per, n_stream, n_f32), x.device)
    return (dx, db1e, dw1, dscal[0:1], dvec_dv[1:], dvec_dv[0], dvec_g0[0],
            dvec_g0[1], dscal[1:2], dw2, db2, dvec_g1[0], dvec_g1[1])


tcn_block_gln_backward.launches = 0


def launch_times(run, names):
    """One pass on the card with CUDA events between its launches: run(
    events) calls `_forward_cuda` or `tcn_block_gln_backward` with
    `events`, whose C entry point records the first before its first
    launch and one after each. -> {name: ms}, the launches of one name
    (FORWARD_LAUNCHES, BACKWARD_LAUNCHES) summed."""
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(len(names) + 1)]
    for mark in marks:
        mark.record()  # the handle exists once the event is recorded
    events = torch.tensor([mark.cuda_event for mark in marks],
                          dtype=torch.int64)
    torch.cuda.synchronize()
    run(events)
    torch.cuda.synchronize()
    times = {}
    for name, before, after in zip(names, marks, marks[1:]):
        times[name] = times.get(name, 0.0) + before.elapsed_time(after)
    return times


def _on_kernel_path(plain: bool, x) -> bool:
    if plain or x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"tcn_block_gln runs on cuda or cpu, not {x.device}")
    return True


class TCNBlockFn(torch.autograd.Function):
    """The block with its hand-written backward, on both devices.

    It takes the parameters as they are stored (f32) and casts them inside,
    so the parameter gradients come back in the parameters' dtype from f32
    sums, whatever the stream's dtype. `plain` runs the plain versions on
    any device; `save` says whether a gradient may be asked for."""

    @staticmethod
    def forward(ctx, plain, save, dilation, k, causal, eps, x, *params):
        run = _forward_cuda if _on_kernel_path(plain, x) else functools.partial(
            tcn_block_gln_reference, return_stats=True)
        y, stats = run(x, *params, dilation, k, causal, eps)
        if save:
            ctx.conf = (plain, dilation, k, causal, eps)
            ctx.save_for_backward(x, *params, stats)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        plain, dilation, k, causal, eps = ctx.conf
        x, *params, stats = ctx.saved_tensors
        run = tcn_block_gln_backward if _on_kernel_path(plain, x) \
            else tcn_block_gln_backward_reference
        dx, *dparams = run(x, *params, stats, dy, dilation, k, causal, eps)
        return (None,) * 6 + (dx,) + tuple(
            d.reshape(p.shape).to(p.dtype) for d, p in zip(dparams, params))


def tcn_block_gln(x, b1_eff, w1, p0, kd, bd, g0w, g0b, p1, w2, b2, g1w, g1b,
                  dilation, k, causal, eps, plain: bool = False):
    """Fused gLN TCN block -> y [B, T, C] in x's dtype (argument order of
    pallas_tcn.tcn_block_gln). Differentiable in x, b1_eff and every
    parameter."""
    tensors = (x, b1_eff, w1, p0, kd, bd, g0w, g0b, p1, w2, b2, g1w, g1b)
    save = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    return TCNBlockFn.apply(plain, save, int(dilation), int(k), bool(causal),
                            float(eps), *tensors)


tcn_block_gln.launches = 0
