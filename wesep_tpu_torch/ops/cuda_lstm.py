"""Fused bidirectional LSTM layer: CUDA kernel wrapper and plain version.

Counterpart of wesep_tpu/ops/pallas_lstm.py `bilstm_layer` (forward only;
the backward kernel comes with the training slice). The kernel lives in
csrc/bilstm_layer.cu, whose header says what bounds it and how it is laid
out.

`bilstm_layer` runs the kernel on CUDA tensors and the plain version on
CPU tensors, and raises for anything else: there is no fallback from a
failed build or launch. `bilstm_layer.launches` counts kernel launches.
"""

import ctypes
import functools

import torch

__all__ = ["bilstm_layer", "bilstm_layer_reference"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HIDDEN = 256  # one thread per hidden unit (csrc/bilstm_layer.cu)


def bilstm_layer_reference(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b):
    """Plain PyTorch version of the kernel, with the same dtype handling.

    x: [B, T, D]; wx_*: [D, 4H]; b_*: [4H]; wh_*: [H, 4H] -> [B, T, 2H].
    The weights are rounded to x's dtype, products accumulate in f32, the
    bias and cell state stay f32, and h is rounded to x's dtype before it
    enters the next Wh product and when it is stored.
    """
    dtype = x.dtype
    x32 = x.float()

    def one(wx, b, wh, reverse):
        wx32 = wx.to(dtype).float()
        wh32 = wh.to(dtype).float()
        xw = torch.matmul(x32, wx32) + b.float()  # [B, T, 4H], f32
        hidden = wh.shape[0]
        h = x32.new_zeros(x.shape[0], hidden)
        c = x32.new_zeros(x.shape[0], hidden)
        ys = [None] * x.shape[1]
        steps = range(x.shape[1] - 1, -1, -1) if reverse \
            else range(x.shape[1])
        for t in steps:
            g = xw[:, t] + torch.matmul(h, wh32)
            i, f, gg, o = g.split(hidden, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = (torch.sigmoid(o) * torch.tanh(c)).to(dtype).float()
            ys[t] = h
        return torch.stack(ys, dim=1)

    return torch.cat(
        [one(wx_f, b_f, wh_f, False), one(wx_b, b_b, wh_b, True)], dim=-1
    ).to(dtype)


@functools.lru_cache(maxsize=None)
def _forward_fn():
    """The kernel's C entry point, built and loaded at first use."""
    from wesep_tpu_torch.ops._build import load_library

    fn = load_library("bilstm_layer").bilstm_layer_forward
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, device):
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x is on {device}")


def bilstm_layer(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b):
    """Fused bidirectional LSTM layer -> [B, T, 2H] (argument order of
    pallas_lstm.bilstm_layer: input weight, bias, recurrent weight)."""
    if x.device.type == "cpu":
        return bilstm_layer_reference(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b)
    if x.device.type != "cuda":
        raise ValueError(f"bilstm_layer runs on cuda or cpu, not {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, D], got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"bilstm_layer takes float32 or bfloat16, not {x.dtype}")
    batch, t_len, d = x.shape
    hidden = wh_f.shape[0]
    if d % 4 or hidden % 4 or hidden > _MAX_HIDDEN:
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
    # weights in the stream's dtype (f32 params must not promote a bf16
    # stream), biases f32; contiguous copies only where needed
    x = x.contiguous()
    wx_f, wh_f, wx_b, wh_b = (
        w.to(x.dtype).contiguous() for w in (wx_f, wh_f, wx_b, wh_b)
    )
    b_f, b_b = (b.float().contiguous() for b in (b_f, b_b))
    y = torch.empty(batch, t_len, 2 * hidden, dtype=x.dtype, device=x.device)
    if batch == 0 or t_len == 0:
        return y
    fn = _forward_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), wx_f.data_ptr(), b_f.data_ptr(), wh_f.data_ptr(),
            wx_b.data_ptr(), b_b.data_ptr(), wh_b.data_ptr(), y.data_ptr(),
            batch, t_len, d, hidden, _DTYPE_CODES[x.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"bilstm_layer kernel launch failed: CUDA error {err}")
    bilstm_layer.launches += 1
    return y


bilstm_layer.launches = 0
