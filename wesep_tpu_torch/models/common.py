"""Shared building blocks: Dense, FiLM, speaker transform/fusion, LSTM.

Counterpart of wesep_tpu/models/common.py (Dense, FiLM, SpeakerTransform,
SpeakerFuse, LSTM). Layouts are channels-last as in the JAX package, and
every parameter keeps the JAX name and shape (Dense `kernel` is [in, out]),
so a JAX param tree flattens onto the state_dict
(utils/jax_params.py). Parameters are f32; each module computes in its
input's dtype, so f32 parameters never promote a bf16 stream.
"""

import math

import torch
from torch import nn

from wesep_tpu_torch.ops.rnn import bilstm, lstm

__all__ = ["Dense", "FiLM", "SpeakerTransform", "SpeakerFuse", "LSTM",
           "uniform_param"]


def uniform_param(*shape, fan_in: int) -> nn.Parameter:
    """torch's default Linear/Conv/LSTM init: U(-1/sqrt(fan_in), ...)."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return nn.Parameter(torch.empty(*shape).uniform_(-bound, bound))


class Dense(nn.Module):
    """Linear layer, kernel [in, out], torch-default init."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = uniform_param(in_features, features, fan_in=in_features)
        self.bias = uniform_param(features, fan_in=in_features)

    def forward(self, x):
        y = torch.matmul(x, self.kernel.to(x.dtype))
        return (y.float() + self.bias).to(x.dtype)


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
    """Pointwise MLP on the embedding that keeps its width:
    Dense(E, 128) -> tanh(Dense(128, 128)) -> Dense(128, E)."""

    def __init__(self, embed_dim: int = 256, hid_dim: int = 128):
        super().__init__()
        self.Dense_0 = Dense(embed_dim, hid_dim)
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
    order i, f, g, o, torch LSTM init. Setting `plain = True` runs the
    kernels' plain versions (forward and backward) on any device; it exists
    so a check on the card can hold the kernel path against it, and nothing
    on the serving or training path sets it.
    """

    def __init__(self, input_dim: int, hidden: int,
                 bidirectional: bool = True, unfold_ks: int = 0):
        super().__init__()
        if unfold_ks:
            raise NotImplementedError(
                "unfold_ks (TF-GridNet's fused unfold + BiLSTM, pallas_lstm "
                "bilstm_layer_unfold) is not ported yet"
            )
        self.bidirectional = bidirectional
        self.plain = False
        h4 = 4 * hidden
        dirs = ("f", "b") if bidirectional else ("f",)
        for tag in dirs:
            setattr(self, f"wx_{tag}",
                    uniform_param(input_dim, h4, fan_in=hidden))
            setattr(self, f"wh_{tag}", uniform_param(hidden, h4, fan_in=hidden))
            setattr(self, f"b_{tag}", uniform_param(h4, fan_in=hidden))

    def forward(self, x):
        if not self.bidirectional:
            return lstm(x, self.wx_f, self.wh_f, self.b_f)
        return bilstm(x, self.wx_f, self.wh_f, self.b_f,
                      self.wx_b, self.wh_b, self.b_b, plain=self.plain)
