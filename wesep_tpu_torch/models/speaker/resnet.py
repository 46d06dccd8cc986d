"""ResNet speaker encoders on fbank features, channels-last.

Counterpart of wesep_tpu/models/speaker/resnet.py (the wespeaker topology):
fbank [B, T, F] becomes the map [B, F, T, 1] (frequency as height), then
conv3x3(1 -> m) + BatchNorm + relu, four stages of Basic or Bottleneck
blocks (strides 1, 2, 2, 2; m, 2m, 4m, 8m channels), the frame-level
vector [B, T', F' * C] (C fastest, the JAX order), temporal pooling and a
linear layer to the embedding; with `two_emb_layer` a relu, a BatchNorm
without scale or bias and a second linear layer, the model then returning
(embed_a, embed_b).

The encoder computes in the dtype flax promotes its input to against f32
parameters: f32 for an f32, f16 or bf16 input, so a bf16 fbank gives f32
convolutions, statistics and embedding, as in the JAX package (where the
separator after the speaker fuse then runs in f32 too). BatchNorm is the
port's flax-momentum one (biased variance, momentum 0.9). Parameter names
are the flax scopes: `conv1`, `bn1`, `layer{s}_{i}.{conv1, bn1, conv2,
bn2, conv3, bn3, shortcut_conv, shortcut_bn}`, `pool`, `seg_1`,
`seg_bn_1`, `seg_2`.
"""

import torch
from torch import nn
from torch.nn import functional as F

from wesep_tpu_torch.models.common import (
    BatchNorm,
    Conv2d,
    Dense,
    flax_default,
)
from wesep_tpu_torch.models.speaker.pooling import get_pooling

__all__ = ["ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
           "ResNet152"]


def _conv(cin, cout, k, stride=1):
    # flax padding=1 for the 3x3 convs; "SAME" for a 1x1 conv is no padding
    p = (k - 1) // 2
    return flax_default(Conv2d(cin, cout, (k, k), ((p, p), (p, p)),
                               (stride, stride), use_bias=False))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 3, stride)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm(planes)
        self.shortcut = stride != 1 or in_planes != planes
        if self.shortcut:
            self.shortcut_conv = _conv(in_planes, planes, 1, stride)
            self.shortcut_bn = BatchNorm(planes)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = self.shortcut_bn(self.shortcut_conv(x)) if self.shortcut else x
        return F.relu(y + res)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = _conv(in_planes, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = BatchNorm(planes)
        self.conv3 = _conv(planes, out, 1)
        self.bn3 = BatchNorm(out)
        self.shortcut = stride != 1 or in_planes != out
        if self.shortcut:
            self.shortcut_conv = _conv(in_planes, out, 1, stride)
            self.shortcut_bn = BatchNorm(out)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = self.shortcut_bn(self.shortcut_conv(x)) if self.shortcut else x
        return F.relu(y + res)


class ResNet(nn.Module):
    """fbank [B, T, feat_dim] -> embedding [B, embed_dim] (or the pair of
    the two embedding layers)."""

    def __init__(self, block, num_blocks, feat_dim: int = 80,
                 m_channels: int = 32, embed_dim: int = 128,
                 pooling_func: str = "TSTP", two_emb_layer: bool = True):
        super().__init__()
        self.embed_dim, self.two_emb_layer = embed_dim, two_emb_layer
        self.conv1 = _conv(1, m_channels, 3)
        self.bn1 = BatchNorm(m_channels)
        self.stages = []
        in_planes, f = m_channels, feat_dim
        for stage, (n, stride) in enumerate(zip(num_blocks, (1, 2, 2, 2))):
            planes = m_channels * 2 ** stage
            names = []
            for i in range(n):
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, block(in_planes, planes,
                                            stride if i == 0 else 1))
                in_planes = planes * block.expansion
                names.append(name)
            self.stages.append(names)
            f = (f - 1) // stride + 1
        self.pool = get_pooling(pooling_func)(f * in_planes)
        self.seg_1 = flax_default(Dense(self.pool.out_dim, embed_dim))
        if two_emb_layer:
            self.seg_bn_1 = BatchNorm(embed_dim, use_scale=False,
                                      use_bias=False)
            self.seg_2 = flax_default(Dense(embed_dim, embed_dim))

    def forward(self, feats):
        x = feats.to(torch.promote_types(feats.dtype, torch.float32))
        x = x.transpose(1, 2)[..., None]  # [B, F, T, 1]
        x = F.relu(self.bn1(self.conv1(x)))
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
        b, f, t, c = x.shape
        x = x.transpose(1, 2).reshape(b, t, f * c)
        embed_a = self.seg_1(self.pool(x))
        if not self.two_emb_layer:
            return embed_a
        return embed_a, self.seg_2(self.seg_bn_1(F.relu(embed_a)))


def _resnet(block, blocks):
    def ctor(feat_dim: int = 80, m_channels: int = 32, embed_dim: int = 128,
             pooling_func: str = "TSTP", two_emb_layer: bool = True,
             **_ignored):
        return ResNet(block, blocks, feat_dim, m_channels, embed_dim,
                      pooling_func, two_emb_layer)

    return ctor


ResNet18 = _resnet(BasicBlock, (2, 2, 2, 2))
ResNet34 = _resnet(BasicBlock, (3, 4, 6, 3))
ResNet50 = _resnet(Bottleneck, (3, 4, 6, 3))
ResNet101 = _resnet(Bottleneck, (3, 4, 23, 3))
ResNet152 = _resnet(Bottleneck, (3, 8, 36, 3))
