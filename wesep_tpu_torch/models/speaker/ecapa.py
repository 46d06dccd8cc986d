"""ECAPA-TDNN speaker encoder (arXiv:2005.07143) on fbank [B, T, F],
channels-last.

Counterpart of wesep_tpu/models/speaker/ecapa.py, with its names and
shapes so a flax tree flattens onto the state_dict (utils/jax_params.py).
`make_ecapa`'s `layout` picks this "tpu" layout (the default) or
wespeaker's micro-structure (ecapa_ws.py).

conv5(F -> C) + relu + BN, three SE-Res2 blocks (kernel 3, dilations 2 / 3
/ 4, scale 8, SE bottleneck 128), the concat of the three block outputs ->
conv1(3C -> 1536) + relu, ASTP (global context for the `_GLOB` names) ->
BN -> linear. The Res2 stage keeps its first split raw and convolves the
other seven, each with the previous output added, relu only; one BN after
the stage. Frame features (`return_frame_feats`) are the last block's
output [B, T, C].

Dtypes follow the JAX package's: the convs compute in their input's
dtype, each BN returns its input's dtype, and the SE block's dense layers
promote against their f32 parameters. So an f32 fbank runs in f32 (the
BSRNN_Feats path), and a bf16 fbank runs layer1 and the second block's
convs in bf16 and the rest in f32: the frame features and the embedding
are f32 either way. `head=False` leaves out what follows the frame
features (pooling, BN, linear): the JAX tree of a model that only asks
for frame features has none of them.
"""

import torch
from torch import nn
from torch.nn import functional as F

from wesep_tpu_torch.models.common import (
    BatchNorm,
    Conv1d,
    Dense,
    flax_default,
)
from wesep_tpu_torch.models.speaker.pooling import ASTP

__all__ = ["ECAPA_TDNN", "SEBlock", "make_ecapa"]

DILATIONS = (2, 3, 4)


def f32_input(x):
    """x in the dtype flax promotes it to against f32 parameters."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _bn(bn, x):
    """A BatchNorm's output in x's dtype (flax's
    `BatchNorm(x).astype(x.dtype)`)."""
    return bn(x).to(x.dtype)


class SEBlock(nn.Module):
    """Squeeze-excitation over the channels of [B, T, C]: time mean ->
    `fc1` (relu) -> `fc2` (sigmoid) -> scale, the dense layers and the
    scaled output promoted to f32 (flax nn.Dense)."""

    def __init__(self, channels: int, bottleneck: int = 128,
                 names=("fc1", "fc2")):
        super().__init__()
        self.names = names
        self.add_module(names[0], flax_default(Dense(channels, bottleneck)))
        self.add_module(names[1], flax_default(Dense(bottleneck, channels)))

    def forward(self, x):
        first, second = (getattr(self, n) for n in self.names)
        s = f32_input(x.mean(dim=1))
        s = torch.sigmoid(second(F.relu(first(s))))
        return x * s[:, None, :]


class Res2Conv(nn.Module):
    """Split C into `scale` groups; `conv_{i}` (i >= 1) convolves group i
    plus the previous output, relu; group 0 passes through first."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: int = 1, scale: int = 8):
        super().__init__()
        if channels % scale:
            raise ValueError(f"{channels} channels do not split by {scale}")
        width, self.scale = channels // scale, scale
        pad = dilation * (kernel_size - 1) // 2
        for i in range(1, scale):
            self.add_module(f"conv_{i}", Conv1d(
                width, width, kernel_size, dilation=dilation, padding=pad))

    def forward(self, x):
        chunks = x.chunk(self.scale, dim=-1)
        outs, y = [chunks[0]], None
        for i in range(1, self.scale):
            inp = chunks[i] if y is None else chunks[i] + y
            y = F.relu(getattr(self, f"conv_{i}")(inp))
            outs.append(y)
        return torch.cat(outs, dim=-1)


class SERes2Block(nn.Module):
    """conv1 -> relu -> BN -> Res2Conv -> relu -> BN -> conv1 -> relu -> BN
    -> SE, plus the residual."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: int = 1, scale: int = 8):
        super().__init__()
        self.conv_in = Conv1d(channels, channels, 1)
        self.bn_in = BatchNorm(channels)
        self.res2 = Res2Conv(channels, kernel_size, dilation, scale)
        self.bn_mid = BatchNorm(channels)
        self.conv_out = Conv1d(channels, channels, 1)
        self.bn_out = BatchNorm(channels)
        self.se = SEBlock(channels)

    def forward(self, x):
        y = _bn(self.bn_in, F.relu(self.conv_in(x)))
        y = _bn(self.bn_mid, F.relu(self.res2(y)))
        y = _bn(self.bn_out, F.relu(self.conv_out(y)))
        return self.se(y) + x


class ECAPA_TDNN(nn.Module):
    """fbank [B, T, feat_dim] -> embedding [B, embed_dim], or with
    `return_frame_feats` the last block's output [B, T, channels]."""

    def __init__(self, feat_dim: int = 80, channels: int = 512,
                 embed_dim: int = 192, global_context_att: bool = True,
                 head: bool = True):
        super().__init__()
        self.embed_dim, self.frame_dim, self.head = embed_dim, channels, head
        self.layer1 = Conv1d(feat_dim, channels, 5, padding=2)
        self.bn1 = BatchNorm(channels)
        for i, dil in enumerate(DILATIONS):
            self.add_module(f"layer{i + 2}",
                            SERes2Block(channels, 3, dil, 8))
        if head:
            self.conv_agg = Conv1d(3 * channels, 1536, 1)
            self.pool = ASTP(1536, 128, global_context=global_context_att)
            self.pool_bn = BatchNorm(self.pool.out_dim)
            self.linear = flax_default(Dense(self.pool.out_dim, embed_dim))

    def forward(self, feats, return_frame_feats: bool = False):
        x = _bn(self.bn1, F.relu(self.layer1(feats)))
        outs = []
        for i in range(len(DILATIONS)):
            x = getattr(self, f"layer{i + 2}")(x)
            outs.append(x)
        if return_frame_feats:
            return outs[-1]
        if not self.head:
            raise ValueError("an ECAPA-TDNN built with head=False gives "
                             "frame features only")
        x = F.relu(self.conv_agg(torch.cat(outs, dim=-1)))
        return self.linear(self.pool_bn(self.pool(x)))


def make_ecapa(name: str):
    """'ECAPA_TDNN_c512' / 'ECAPA_TDNN_GLOB_c1024' ... -> the constructor:
    `_GLOB` turns on ASTP's global context, `c<N>` sets the channels, and
    `layout` picks 'tpu' (default) or 'wespeaker'."""
    glob = "_GLOB" in name
    try:
        channels = int(name.rsplit("c", 1)[-1])
    except ValueError:
        raise NotImplementedError(
            f"unknown speaker model {name!r}") from None

    def ctor(feat_dim: int = 80, embed_dim: int = 192,
             pooling_func: str = "ASTP", layout: str = "tpu",
             emb_bn: bool = False, head: bool = True, **_ignored):
        if layout == "wespeaker":
            from wesep_tpu_torch.models.speaker.ecapa_ws import ECAPA_TDNN_WS

            return ECAPA_TDNN_WS(feat_dim, channels, embed_dim, pooling_func,
                                 glob, emb_bn, head)
        if layout != "tpu":
            raise ValueError(
                f"unknown ECAPA layout {layout!r}; use 'tpu' or 'wespeaker'")
        return ECAPA_TDNN(feat_dim, channels, embed_dim, glob, head)

    return ctor
