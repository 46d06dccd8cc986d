"""Shared building blocks: Dense, Conv1d, Conv2d, ConvTranspose, norms,
PReLU, FiLM, speaker transform/fusion, LSTM.

Counterpart of wesep_tpu/models/common.py and of the flax layers the JAX
models use directly (nn.Conv, nn.ConvTranspose, nn.LayerNorm). Layouts are
channels-last as in the JAX package, and every parameter keeps the JAX name
and shape (Dense `kernel` is [in, out], Conv1d `kernel` is [k, in / groups,
out], Conv2d `kernel` is HWIO [kh, kw, in, out]), so a JAX param tree
flattens onto the state_dict (utils/jax_params.py). Parameters are f32;
each module computes in its input's dtype, so f32 parameters never promote
a bf16 stream.
"""

import math

import torch
from torch import nn
from torch.nn import functional as F

from wesep_tpu_torch.ops.rnn import bilstm, bilstm_unfold, lstm

__all__ = ["Dense", "Conv1d", "Conv2d", "ConvTranspose", "GlobalLayerNorm",
           "ChannelLayerNorm", "LayerNorm", "BatchNorm", "BatchNorm1d",
           "PReLU", "get_norm", "norm_auto_name", "FiLM", "SpeakerTransform",
           "SpeakerFuse", "LSTM", "uniform_param"]


def uniform_param(*shape, fan_in: int) -> nn.Parameter:
    """torch's default Linear/Conv/LSTM init: U(-1/sqrt(fan_in), ...)."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return nn.Parameter(torch.empty(*shape).uniform_(-bound, bound))


class Dense(nn.Module):
    """Linear layer, kernel [in, out] (and `bias` [out] unless `use_bias`
    is false), torch-default init."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True):
        super().__init__()
        self.kernel = uniform_param(in_features, features, fan_in=in_features)
        if use_bias:
            self.bias = uniform_param(features, fan_in=in_features)
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        y = torch.matmul(x, self.kernel.to(x.dtype))
        if self.bias is None:
            return y
        return (y.float() + self.bias).to(x.dtype)


class _ConvParams(nn.Module):
    """`kernel` [k, in / groups, out] and `bias` [out] of a convolution,
    torch-default init."""

    def __init__(self, kernel_size, in_per_group, features, use_bias):
        super().__init__()
        fan_in = kernel_size * in_per_group
        self.kernel = uniform_param(kernel_size, in_per_group, features,
                                    fan_in=fan_in)
        if use_bias:
            self.bias = uniform_param(features, fan_in=fan_in)
        else:
            self.register_parameter("bias", None)


class Conv1d(nn.Module):
    """1-D convolution on [B, T, C], torch-default init.

    `padding` is an int (both sides) or a (before, after) pair. The
    parameters sit where the JAX tree has them: a depthwise convolution
    (groups == in == out, stride 1) holds `kernel` [k, 1, C] and `bias`
    itself, any other holds them in a child `Conv_0`. A pointwise
    convolution is one matrix product and a convolution of a one-channel
    input (the learned encoders on a waveform) a product over its unfolded
    frames; the rest go through `F.conv1d` in torch's own layout."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 padding=0, use_bias: bool = True):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding = (padding, padding) if isinstance(padding, int) \
            else tuple(padding)
        self.depthwise = (groups == in_channels and features == in_channels
                          and stride == 1 and kernel_size <= 8)
        params = _ConvParams(kernel_size, in_channels // groups, features,
                             use_bias)
        if self.depthwise:
            self.kernel, self.bias = params.kernel, params.bias
        else:
            self.Conv_0 = params

    def forward(self, x):
        held = self if self.depthwise else self.Conv_0
        kernel = held.kernel.to(x.dtype)
        bias = None if held.bias is None else held.bias.to(x.dtype)
        if any(self.padding):
            x = F.pad(x, (0, 0, *self.padding))
        k, in_per_group, _ = kernel.shape
        if self.groups == 1 and self.stride == 1 and k == 1:
            y = torch.matmul(x, kernel[0])
        elif self.groups == 1 and in_per_group == 1 and self.dilation == 1:
            frames = x[..., 0].unfold(-1, k, self.stride)  # [B, T', k]
            y = torch.matmul(frames, kernel[:, 0])
        else:
            y = F.conv1d(x.transpose(1, 2), kernel.permute(2, 1, 0), None,
                         self.stride, 0, self.dilation, self.groups)
            y = y.transpose(1, 2)
        return y if bias is None else y + bias


class Conv2d(nn.Module):
    """2-D convolution on [B, H, W, C] with flax nn.Conv's HWIO `kernel`
    [kh, kw, in, out] and `bias` [out] (none with `use_bias=False`),
    torch-default init; `padding` is ((top, bottom), (left, right)),
    `stride` (along H, along W)."""

    def __init__(self, in_channels: int, features: int, kernel_size=(3, 3),
                 padding=((1, 1), (1, 1)), stride=(1, 1),
                 use_bias: bool = True):
        super().__init__()
        fan_in = in_channels * kernel_size[0] * kernel_size[1]
        self.kernel = uniform_param(*kernel_size, in_channels, features,
                                    fan_in=fan_in)
        if use_bias:
            self.bias = uniform_param(features, fan_in=fan_in)
        else:
            self.register_parameter("bias", None)
        (self.top, self.bottom), (self.left, self.right) = padding
        self.stride = tuple(stride)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        if self.top == self.bottom and self.left == self.right:
            pad = (self.top, self.left)  # F.conv2d pads without a copy
        else:
            x = F.pad(x, (self.left, self.right, self.top, self.bottom))
            pad = 0
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x, self.kernel.to(x.dtype).permute(3, 2, 0, 1), bias,
                     stride=self.stride, padding=pad)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """Transposed convolution (1-D or 2-D) on channels-last input without
    padding, the output (in - 1) * stride + k long on each axis. `kernel`
    is stored as flax nn.ConvTranspose(transpose_kernel=True) stores it,
    [*k, out, in]: torch's ConvTranspose weight [in, out, *k] with its axes
    reversed, not spatially flipped. torch-default init (fan_in out * k)."""

    def __init__(self, in_channels: int, features: int, kernel_size,
                 stride):
        super().__init__()
        self.stride = tuple(stride)
        fan_in = features * math.prod(kernel_size)
        self.kernel = uniform_param(*kernel_size, features, in_channels,
                                    fan_in=fan_in)
        self.bias = uniform_param(features, fan_in=fan_in)

    def forward(self, x):
        nd = len(self.stride)
        weight = self.kernel.to(x.dtype).permute(nd + 1, nd, *range(nd))
        conv = F.conv_transpose1d if nd == 1 else F.conv_transpose2d
        y = conv(x.movedim(-1, 1), weight, self.bias.to(x.dtype),
                 stride=self.stride)
        return y.movedim(1, -1)


class GlobalLayerNorm(nn.Module):
    """gLN: normalise over all but the batch axis, per-channel affine.
    Single-pass statistics (E[x^2] - E[x]^2, clamped at 0) summed in f32
    over the stream's dtype; the affine is applied in the stream's dtype."""

    eps = 1e-5

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        axes = tuple(range(1, x.dim()))
        mean = x.float().mean(dim=axes, keepdim=True)
        meansq = (x * x).float().mean(dim=axes, keepdim=True)
        var = (meansq - mean * mean).clamp_min(0.0)
        a = self.weight * torch.rsqrt(var + self.eps)
        return a.to(x.dtype) * x + (self.bias - mean * a).to(x.dtype)


class _Affine(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


class ChannelLayerNorm(nn.Module):
    """cLN: LayerNorm over the channel (last) axis at every position, in
    f32, returned in the input's dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.LayerNorm_0 = _Affine(channels)

    def forward(self, x):
        y = F.layer_norm(x.float(), x.shape[-1:], self.LayerNorm_0.scale,
                         self.LayerNorm_0.bias, self.eps)
        return y.to(x.dtype)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm over the last axis: `scale`, `bias`; statistics in
    f32 in one pass (E[x^2] - E[x]^2, clamped at 0), the result returned in
    the input's dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32.square().mean(dim=-1, keepdim=True)
               - mean.square()).clamp_min(0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        return (y + self.bias).to(x.dtype)


def _batch_moments(x32, axes, group=None):
    """Mean and biased variance (E[x^2] - E[x]^2, clamped at 0) over
    `axes`; with a process `group`, over the rows of each of its ranks: the
    local sums and row count are all-reduced (and so, in the backward, are
    their gradients), as the JAX package's step over a batch sharded on
    the data axis reduces over the global batch."""
    if group is None:
        mean = x32.mean(dim=axes)
        return mean, ((x32 * x32).mean(dim=axes) - mean * mean).clamp_min(0.0)
    from torch.distributed.nn.functional import all_reduce

    rows = x32.new_full((1,), x32.numel() // x32.shape[-1])
    sums = all_reduce(torch.cat([x32.sum(dim=axes), (x32 * x32).sum(dim=axes),
                                 rows]), group=group)
    c = x32.shape[-1]
    mean = sums[:c] / sums[-1]
    return mean, (sums[c:2 * c] / sums[-1] - mean * mean).clamp_min(0.0)


class BatchNorm(nn.Module):
    """Batch norm over all but the channel (last) axis, in f32.

    Parameters `scale`, `bias` (flax's `use_scale` / `use_bias` drop
    them); buffers `mean`, `var`. In training mode it
    normalises with the batch's statistics (biased variance E[x^2] -
    E[x]^2, clamped at 0) and moves the buffers by
    new = momentum * old + (1 - momentum) * batch (momentum 0.9 keeps 90 %
    of the old value; torch's own BatchNorm calls that momentum 0.1 and
    would store the unbiased variance); in eval mode it uses the buffers.
    `group` (None: this process's rows) is the process group over whose
    ranks the training statistics are reduced (SyncBatchNorm's semantics),
    so every rank's buffers stay equal; the trainer's data-parallel wrapper
    sets it."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9, use_scale: bool = True,
                 use_bias: bool = True):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.scale = nn.Parameter(torch.ones(channels)) if use_scale \
            else None
        self.bias = nn.Parameter(torch.zeros(channels)) if use_bias \
            else None
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.group = None

    def forward(self, x):
        x32 = x.float()
        if self.training:
            mean, var = _batch_moments(x32, tuple(range(x.dim() - 1)),
                                       self.group)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(
                    mean, alpha=1.0 - self.momentum)
                self.var.mul_(self.momentum).add_(
                    var, alpha=1.0 - self.momentum)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps)
        if self.scale is not None:
            inv = inv * self.scale
        y = (x32 - mean) * inv
        return y if self.bias is None else y + self.bias


class BatchNorm1d(nn.Module):
    """BatchNorm over (B, T) per channel, returned in the input's dtype."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(channels, eps, momentum)

    def forward(self, x):
        return self.BatchNorm_0(x).to(x.dtype)


_NORMS = {"cLN": ChannelLayerNorm, "gLN": GlobalLayerNorm, "BN": BatchNorm1d}


def get_norm(kind: str, channels: int, eps: float = 1e-5) -> nn.Module:
    """cLN / gLN / BN selector."""
    if kind not in _NORMS:
        raise ValueError(f"Unsupported norm: {kind}")
    return _NORMS[kind](channels, eps=eps)


def norm_auto_name(kind: str, idx: int) -> str:
    """The name the JAX tree gives the idx-th norm of `kind` in a module."""
    return f"{_NORMS[kind].__name__}_{idx}"


class PReLU(nn.Module):
    """PReLU with a single shared slope `alpha` [1], initially 0.25."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), init))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


class FiLM(nn.Module):
    """(1 + gamma(e)) * x + beta(e), gamma/beta zero-initialised (identity
    at init)."""

    def __init__(self, embed_dim: int, feat_dim: int):
        super().__init__()
        self.gamma_0 = Dense(embed_dim, feat_dim)
        self.beta_0 = Dense(embed_dim, feat_dim)
        for p in self.parameters():
            nn.init.zeros_(p)

    def forward(self, embed, x):
        gamma, beta = self.gamma_0(embed), self.beta_0(embed)
        while gamma.dim() < x.dim():
            gamma = gamma.unsqueeze(1)
            beta = beta.unsqueeze(1)
        return (1.0 + gamma) * x + beta


class SpeakerTransform(nn.Module):
    """Pointwise MLP on the embedding: Dense(in, 128) -> tanh(Dense(128,
    128)) -> Dense(128, E); `in_dim` (default E) is the width of the
    embedding it is given."""

    def __init__(self, embed_dim: int = 256, hid_dim: int = 128,
                 in_dim: int | None = None):
        super().__init__()
        self.Dense_0 = Dense(in_dim or embed_dim, hid_dim)
        self.Dense_1 = Dense(hid_dim, hid_dim)
        self.Dense_2 = Dense(hid_dim, embed_dim)

    def forward(self, e):
        return self.Dense_2(torch.tanh(self.Dense_1(self.Dense_0(e))))


class SpeakerFuse(nn.Module):
    """Fuse an embedding [B, E] into features [B, ..., C].

    fuse_type: concat | additive | multiply | FiLM | None."""

    def __init__(self, feat_dim: int, embed_dim: int,
                 fuse_type: str = "concat"):
        super().__init__()
        self.fuse_type = fuse_type
        if fuse_type == "FiLM":
            self.FiLM_0 = FiLM(embed_dim, feat_dim)
        elif fuse_type == "concat":
            self.Dense_0 = Dense(feat_dim + embed_dim, feat_dim)
        elif fuse_type in ("additive", "multiply"):
            self.Dense_0 = Dense(embed_dim, feat_dim)
        elif fuse_type != "None":
            raise ValueError(f"Fuse type not defined: {fuse_type}")

    def forward(self, x, embed):
        ft = self.fuse_type
        if ft == "None":
            return x
        if ft == "FiLM":
            return self.FiLM_0(embed, x)
        e = embed
        while e.dim() < x.dim():
            e = e.unsqueeze(1)
        if ft == "concat":
            tile = e.expand(*x.shape[:-1], embed.shape[-1])
            return self.Dense_0(torch.cat([x, tile], dim=-1))
        proj = self.Dense_0(e)
        if ft == "additive":
            return x + proj
        return x * proj


class LSTM(nn.Module):
    """LSTM over [B, T, D]; bidirectional concatenates -> [B, T, 2H].

    Weights wx_* [D, 4H], wh_* [H, 4H], b_* [4H] (one summed bias), gate
    order i, f, g, o, torch LSTM init. With `unfold_ks` > 0 the input is a
    raw [B, L, C] stream and the module computes unfold(unfold_ks,
    unfold_hs) -> BiLSTM -> [B, T', 2H] with the same parameters as the
    layer over the unfolded stream (wx_* [unfold_ks * C, 4H], channel-major
    rows), through `ops.rnn.bilstm_unfold`. Setting `plain = True` runs the
    kernels' plain versions (forward and backward) on any device; it exists
    so a check on the card can hold the kernel path against it, and nothing
    on the serving or training path sets it.
    """

    def __init__(self, input_dim: int, hidden: int,
                 bidirectional: bool = True, unfold_ks: int = 0,
                 unfold_hs: int = 1):
        super().__init__()
        if unfold_ks and not bidirectional:
            raise NotImplementedError("unfold_ks requires bidirectional=True")
        self.bidirectional = bidirectional
        self.unfold_ks, self.unfold_hs = unfold_ks, unfold_hs
        self.plain = False
        h4 = 4 * hidden
        d = input_dim * unfold_ks if unfold_ks else input_dim
        dirs = ("f", "b") if bidirectional else ("f",)
        for tag in dirs:
            setattr(self, f"wx_{tag}", uniform_param(d, h4, fan_in=hidden))
            setattr(self, f"wh_{tag}", uniform_param(hidden, h4, fan_in=hidden))
            setattr(self, f"b_{tag}", uniform_param(h4, fan_in=hidden))

    def forward(self, x):
        if not self.bidirectional:
            return lstm(x, self.wx_f, self.wh_f, self.b_f, plain=self.plain)
        weights = (self.wx_f, self.wh_f, self.b_f,
                   self.wx_b, self.wh_b, self.b_b)
        if self.unfold_ks:
            return bilstm_unfold(x, *weights, self.unfold_ks, self.unfold_hs,
                                 plain=self.plain)
        return bilstm(x, *weights, plain=self.plain)
