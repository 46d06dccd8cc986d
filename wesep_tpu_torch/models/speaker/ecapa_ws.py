"""wespeaker-layout ECAPA-TDNN on fbank [B, T, F], channels-last: the
micro-structure of wespeaker's ecapa_tdnn.py, so a jointly trained
reference checkpoint maps onto it.

Counterpart of wesep_tpu/models/speaker/ecapa_ws.py, with its names and
shapes. Against the tpu layout (ecapa.py): each conv is conv -> relu -> BN;
the Res2 stage convolves splits 0..scale-2, each followed by relu and its
own BN (`bns_{i}`), split i >= 1 added to the previous output first, and
appends the last raw split at the end; a block is x + SE(CRB(Res2(CRB(x))))
with no BN around the Res2 stage; after the blocks a conv1(3C -> 3C) + relu
gives the frame features [B, T, 3C]; then ASTP (per-channel mean and
unbiased std over time + 1e-10 as global context) -> BN -> linear, and with
`emb_bn` a last BN. Its first conv computes in the fbank's dtype and
every BN returns f32, as in the JAX package, so the rest runs in f32;
`head=False` leaves out pooling, BN and linear.
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
from wesep_tpu_torch.models.speaker.ecapa import DILATIONS, SEBlock
from wesep_tpu_torch.models.speaker.pooling import ASTP

__all__ = ["ECAPA_TDNN_WS"]


class _ConvReluBn(nn.Module):
    """wespeaker Conv1dReluBn: `conv` -> relu -> `bn`."""

    def __init__(self, in_channels: int, channels: int, kernel_size: int = 1,
                 dilation: int = 1, padding: int = 0):
        super().__init__()
        self.conv = Conv1d(in_channels, channels, kernel_size,
                           dilation=dilation, padding=padding)
        self.bn = BatchNorm(channels)

    def forward(self, x):
        return self.bn(F.relu(self.conv(x)))


class _Res2ConvReluBn(nn.Module):
    """wespeaker Res2Conv1dReluBn: `convs_{i}` -> relu -> `bns_{i}` over
    splits 0..scale-2, split i >= 1 added to the previous output first;
    the last raw split is appended at the end."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: int = 1, scale: int = 8):
        super().__init__()
        if channels % scale:
            raise ValueError(f"{channels} channels do not split by {scale}")
        width, self.scale = channels // scale, scale
        self.nums = scale if scale == 1 else scale - 1
        pad = dilation * (kernel_size - 1) // 2
        for i in range(self.nums):
            self.add_module(f"convs_{i}", Conv1d(
                width, width, kernel_size, dilation=dilation, padding=pad))
            self.add_module(f"bns_{i}", BatchNorm(width))

    def forward(self, x):
        spx = x.chunk(self.scale, dim=-1)
        outs, sp = [], spx[0]
        for i in range(self.nums):
            if i >= 1:
                sp = sp + spx[i]
            sp = getattr(self, f"bns_{i}")(
                F.relu(getattr(self, f"convs_{i}")(sp)))
            outs.append(sp)
        if self.scale != 1:
            outs.append(spx[-1])
        return torch.cat(outs, dim=-1)


class _SERes2BlockWS(nn.Module):
    """wespeaker SE_Res2Block: x + SE(CRB(Res2(CRB(x))))."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: int = 1, scale: int = 8):
        super().__init__()
        self.conv_in = _ConvReluBn(channels, channels, 1)
        self.res2 = _Res2ConvReluBn(channels, kernel_size, dilation, scale)
        self.conv_out = _ConvReluBn(channels, channels, 1)
        self.se = SEBlock(channels, names=("linear1", "linear2"))

    def forward(self, x):
        return x + self.se(self.conv_out(self.res2(self.conv_in(x))))


class ECAPA_TDNN_WS(nn.Module):
    """wespeaker-layout ECAPA-TDNN: fbank [B, T, feat_dim] -> embedding
    [B, embed_dim], or with `return_frame_feats` the post-`conv` frame
    features [B, T, 3 * channels]."""

    def __init__(self, feat_dim: int = 80, channels: int = 512,
                 embed_dim: int = 192, pooling_func: str = "ASTP",
                 global_context_att: bool = False, emb_bn: bool = False,
                 head: bool = True):
        super().__init__()
        if pooling_func != "ASTP":
            raise NotImplementedError(
                "wespeaker-layout ECAPA supports ASTP pooling only "
                f"(got {pooling_func!r})")
        cat = 3 * channels
        self.embed_dim, self.frame_dim, self.head = embed_dim, cat, head
        self.emb_bn = emb_bn
        self.layer1 = _ConvReluBn(feat_dim, channels, 5, padding=2)
        for i, dil in enumerate(DILATIONS):
            self.add_module(f"layer{i + 2}",
                            _SERes2BlockWS(channels, 3, dil, 8))
        self.conv = Conv1d(cat, cat, 1)
        if head:
            self.pool = ASTP(cat, 128, global_context=global_context_att)
            self.bn = BatchNorm(self.pool.out_dim)
            self.linear = flax_default(Dense(self.pool.out_dim, embed_dim))
            if emb_bn:
                self.bn2 = BatchNorm(embed_dim)

    def forward(self, feats, return_frame_feats: bool = False):
        x = self.layer1(feats)
        outs = []
        for i in range(len(DILATIONS)):
            x = getattr(self, f"layer{i + 2}")(x)
            outs.append(x)
        out = F.relu(self.conv(torch.cat(outs, dim=-1)))
        if return_frame_feats:
            return out
        if not self.head:
            raise ValueError("an ECAPA-TDNN built with head=False gives "
                             "frame features only")
        emb = self.linear(self.bn(self.pool(out)))
        return self.bn2(emb) if self.emb_bn else emb
