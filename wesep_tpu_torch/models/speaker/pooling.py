"""Utterance-level pooling of frame-level features [B, T, D] -> [B, 2D]
(counterpart of wesep_tpu/models/speaker/pooling.py): TSTP, ASTP,
MQMHASTP, chosen by the recipes' `pooling_func`. Statistics in f32, the
result in the input's dtype."""

import torch
from torch import nn

from wesep_tpu_torch.models.common import Dense, flax_default

__all__ = ["TSTP", "ASTP", "MQMHASTP", "get_pooling"]


class TSTP(nn.Module):
    """Temporal statistics pooling: concat(mean, sqrt(unbiased var +
    1e-7)) over time."""

    def __init__(self, in_dim: int):
        super().__init__()
        self.out_dim = 2 * in_dim

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=1)
        std = torch.sqrt(xf.var(dim=1, unbiased=True) + 1e-7)
        return torch.cat([mean, std], dim=-1).to(x.dtype)


class ASTP(nn.Module):
    """Attentive statistics pooling: attention weights from
    linear2(tanh(linear1(x))) (with `global_context`, x beside its mean and
    unbiased std over time, + 1e-10), softmax over time; the weighted mean
    and std, the variance clamped at 1e-10."""

    def __init__(self, in_dim: int, bottleneck_dim: int = 128,
                 global_context: bool = False):
        super().__init__()
        self.global_context = global_context
        self.out_dim = 2 * in_dim
        self.linear1 = flax_default(Dense(
            in_dim * (3 if global_context else 1), bottleneck_dim))
        self.linear2 = flax_default(Dense(bottleneck_dim, in_dim))

    def forward(self, x):
        xf = x.float()
        attn_in = xf
        if self.global_context:
            mean = xf.mean(dim=1, keepdim=True).expand_as(xf)
            std = torch.sqrt(xf.var(dim=1, unbiased=True, keepdim=True)
                             + 1e-10).expand_as(xf)
            attn_in = torch.cat([xf, mean, std], dim=-1)
        a = self.linear2(torch.tanh(self.linear1(attn_in)))
        w = torch.softmax(a.float(), dim=1)
        mean = (w * xf).sum(dim=1)
        var = (w * xf.square()).sum(dim=1) - mean.square()
        std = torch.sqrt(var.clamp_min(1e-10))
        return torch.cat([mean, std], dim=-1).to(x.dtype)


class MQMHASTP(nn.Module):
    """Independent ASTP heads `head_{h}` on equal channel splits,
    concatenated."""

    def __init__(self, in_dim: int, n_heads: int = 4,
                 bottleneck_dim: int = 64):
        super().__init__()
        if in_dim % n_heads:
            raise ValueError(f"{in_dim} channels do not split into "
                             f"{n_heads} heads")
        self.n_heads = n_heads
        self.out_dim = 2 * in_dim
        for h in range(n_heads):
            self.add_module(f"head_{h}",
                            ASTP(in_dim // n_heads, bottleneck_dim))

    def forward(self, x):
        chunks = x.chunk(self.n_heads, dim=-1)
        return torch.cat([getattr(self, f"head_{h}")(c)
                          for h, c in enumerate(chunks)], dim=-1)


_POOL = {"TSTP": TSTP, "ASTP": ASTP, "MQMHASTP": MQMHASTP}


def get_pooling(name: str):
    if name not in _POOL:
        raise ValueError(f"unknown pooling {name!r}; have {sorted(_POOL)}")
    return _POOL[name]
