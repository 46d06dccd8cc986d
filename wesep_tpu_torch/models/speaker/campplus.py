"""CAM++ speaker encoder (D-TDNN with context-aware masking,
arXiv:2303.00332) on fbank [B, T, F], channels-last, wespeaker's
micro-structure.

Counterpart of wesep_tpu/models/speaker/campplus.py, with its names and
shapes so a flax tree flattens onto the state_dict (utils/jax_params.py):

  * FCM front end `head`: conv3x3 + BN + relu, two stages of two residual
    blocks with frequency-only stride (2, 1) on the first of each, a last
    stride-(2, 1) conv3x3 + BN + relu (F -> F / 8), then a C-major flatten
    of (channels, freq): [B, F', T, C] -> [B, T, C * F'];
  * `tdnn`: conv k=5 stride 2 + BN + relu;
  * three dense stages of (12, 24, 16) layers (growth 32, 4x bottleneck,
    kernel 3, dilations 1 / 2 / 2), each followed by a channel-halving
    transition (BN + relu + 1x1);
  * BN + relu, TSTP pooling, a 1x1 without bias and a BN without scale or
    bias.

A dense layer is BN + relu + 1x1 bottleneck, BN + relu, then the CAM conv:
a dilated conv gated by sigmoid(MLP(global mean + segment means)), the
segments 100 frames in ceil mode, so the last one averages only the frames
left (F.avg_pool1d(ceil_mode=True)). Computes in f32, as flax promotes a
bf16 fbank against its f32 parameters.
"""

import torch
from torch import nn
from torch.nn import functional as F

from wesep_tpu_torch.models.common import (
    BatchNorm,
    Conv1d,
    Conv2d,
    Dense,
    flax_default,
)
from wesep_tpu_torch.models.speaker.ecapa import f32_input
from wesep_tpu_torch.models.speaker.pooling import get_pooling

__all__ = ["CAMPPlus"]

# (layers, dilation) of the dense stages; kernel 3 throughout
_STAGES = ((12, 1), (24, 2), (16, 2))


def _conv3x3(cin, cout, stride=1):
    return flax_default(Conv2d(cin, cout, (3, 3), ((1, 1), (1, 1)),
                               (stride, 1), use_bias=False))


class BasicResBlock(nn.Module):
    """3x3 convs with frequency-only stride (stride, 1); a 1x1 + BN
    shortcut when strided."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv3x3(in_planes, planes, stride)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv3x3(planes, planes)
        self.bn2 = BatchNorm(planes)
        self.shortcut = stride != 1 or in_planes != planes
        if self.shortcut:
            self.shortcut_conv = flax_default(Conv2d(
                in_planes, planes, (1, 1), ((0, 0), (0, 0)), (stride, 1),
                use_bias=False))
            self.shortcut_bn = BatchNorm(planes)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = self.shortcut_bn(self.shortcut_conv(x)) if self.shortcut else x
        return F.relu(y + res)


class FCM(nn.Module):
    """[B, T, F] -> [B, T, m_channels * F / 8] (C-major)."""

    def __init__(self, feat_dim: int, m_channels: int = 32):
        super().__init__()
        self.conv1 = _conv3x3(1, m_channels)
        self.bn1 = BatchNorm(m_channels)
        for stage in (1, 2):
            for i, stride in enumerate((2, 1)):
                self.add_module(f"layer{stage}_{i}", BasicResBlock(
                    m_channels, m_channels, stride))
        self.conv2 = _conv3x3(m_channels, m_channels, 2)
        self.bn2 = BatchNorm(m_channels)
        f = feat_dim
        for _ in range(3):  # the three stride-2 convs along frequency
            f = (f - 1) // 2 + 1
        self.out_dim = m_channels * f

    def forward(self, feats):
        x = feats.transpose(1, 2)[..., None]  # [B, F, T, 1]
        x = F.relu(self.bn1(self.conv1(x)))
        for stage in (1, 2):
            for i in range(2):
                x = getattr(self, f"layer{stage}_{i}")(x)
        x = F.relu(self.bn2(self.conv2(x)))
        b, f, t, c = x.shape
        return x.permute(0, 2, 3, 1).reshape(b, t, c * f)


def _seg_mean(x, seg_len: int):
    """Ceil-mode segment means over time, repeated back to T frames; the
    last segment averages only the T - k * seg_len frames it has."""
    b, t, c = x.shape
    n_seg = -(-t // seg_len)
    xp = F.pad(x, (0, 0, 0, n_seg * seg_len - t))
    sums = xp.reshape(b, n_seg, seg_len, c).sum(dim=2)
    starts = torch.arange(n_seg, device=x.device) * seg_len
    counts = torch.clamp(starts + seg_len, max=t) - starts
    seg = sums / counts[None, :, None].to(x.dtype)
    return seg.repeat_interleave(seg_len, dim=1)[:, :t]


class CAMLayer(nn.Module):
    """A dilated conv `linear_local` gated by sigmoid(linear2(relu(
    linear1(mean + segment means))))."""

    def __init__(self, bn_channels: int, out_channels: int, kernel_size: int,
                 dilation: int, reduction: int = 2, seg_len: int = 100):
        super().__init__()
        self.seg_len = seg_len
        pad = dilation * (kernel_size - 1) // 2
        self.linear_local = Conv1d(bn_channels, out_channels, kernel_size,
                                   dilation=dilation, padding=pad,
                                   use_bias=False)
        self.linear1 = Conv1d(bn_channels, bn_channels // reduction, 1)
        self.linear2 = Conv1d(bn_channels // reduction, out_channels, 1)

    def forward(self, x):
        y = self.linear_local(x)
        ctx = x.mean(dim=1, keepdim=True) + _seg_mean(x, self.seg_len)
        m = torch.sigmoid(self.linear2(F.relu(self.linear1(ctx))))
        return y * m


class DTDNNLayer(nn.Module):
    """BN + relu + 1x1 bottleneck, BN + relu + CAM conv; the output is
    appended to the input's channels."""

    def __init__(self, in_channels: int, growth: int, bn_size: int,
                 kernel_size: int = 3, dilation: int = 1):
        super().__init__()
        mid = growth * bn_size
        self.bn1 = BatchNorm(in_channels)
        self.conv1 = Conv1d(in_channels, mid, 1, use_bias=False)
        self.bn2 = BatchNorm(mid)
        self.cam = CAMLayer(mid, growth, kernel_size, dilation)

    def forward(self, x):
        y = self.conv1(F.relu(self.bn1(x)))
        y = self.cam(F.relu(self.bn2(y)))
        return torch.cat([x, y], dim=-1)


class CAMPPlus(nn.Module):
    """fbank [B, T, feat_dim] -> embedding [B, embed_dim]."""

    def __init__(self, feat_dim: int = 80, embed_dim: int = 192,
                 growth_rate: int = 32, bn_size: int = 4,
                 init_channels: int = 128, pooling_func: str = "TSTP",
                 **_ignored):
        super().__init__()
        self.embed_dim = embed_dim
        self.head = FCM(feat_dim)
        self.tdnn = Conv1d(self.head.out_dim, init_channels, 5, stride=2,
                           padding=2, use_bias=False)
        self.tdnn_bn = BatchNorm(init_channels)
        ch = init_channels
        self.stages = []
        for stage, (n_layers, dilation) in enumerate(_STAGES, start=1):
            names = []
            for i in range(n_layers):
                name = f"block{stage}_layer{i}"
                self.add_module(name, DTDNNLayer(ch, growth_rate, bn_size, 3,
                                                 dilation))
                ch += growth_rate
                names.append(name)
            self.add_module(f"transit{stage}_bn", BatchNorm(ch))
            self.add_module(f"transit{stage}_conv",
                            Conv1d(ch, ch // 2, 1, use_bias=False))
            ch //= 2
            self.stages.append(names)
        self.out_bn = BatchNorm(ch)
        self.pool = get_pooling(pooling_func)(ch)
        self.dense = flax_default(Dense(self.pool.out_dim, embed_dim,
                                        use_bias=False))
        self.dense_bn = BatchNorm(embed_dim, use_scale=False, use_bias=False)

    def forward(self, feats):
        x = self.head(f32_input(feats))
        x = F.relu(self.tdnn_bn(self.tdnn(x)))
        for stage, names in enumerate(self.stages, start=1):
            for name in names:
                x = getattr(self, name)(x)
            x = F.relu(getattr(self, f"transit{stage}_bn")(x))
            x = getattr(self, f"transit{stage}_conv")(x)
        x = F.relu(self.out_bn(x))
        return self.dense_bn(self.dense(self.pool(x)))
