"""BSRNN (band-split RNN) target-speaker extraction in PyTorch.

Counterpart of wesep_tpu/models/bsrnn.py, v1 path (pre-extracted speaker
embeddings, joint_training=False). The design is the JAX package's:

  * the 32 sub-bands come in 5 distinct widths, so bands are processed as
    width groups with stacked weights ([n_bands, C_in, C_out] batched
    einsums), not 32 per-band modules;
  * spectrograms are channels-last [B, T, F];
  * each BSNet runs a band RNN over time (bands folded into the batch) and a
    comm RNN over bands (frames folded into the batch), both through the
    fused BiLSTM layer (ops/cuda_lstm.py), 12 launches per 6-repeat forward.

forward(mix [B, T], embedding [B, E]) -> (est [B, T], None).
Parameter names and shapes follow the JAX param tree (see
utils/jax_params.py).
"""

from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from wesep_tpu_torch.models.common import (
    LSTM,
    Dense,
    SpeakerFuse,
    SpeakerTransform,
    uniform_param,
)
from wesep_tpu_torch.ops.stft import hann_window, istft, stft

__all__ = ["BSRNN", "band_layout"]

# GroupNorm eps of the model: float32 machine eps, not 1e-5
_EPS = float(np.finfo(np.float32).eps)

# config keys of the JAX model that only the joint speaker branch or JAX's
# memory planning read; accepted so a JAX config builds this model
_JAX_ONLY_ARGS = frozenset({
    "multi_task", "spksInTrain", "spk_model", "spk_args", "spk_model_init",
    "spk_model_freeze", "spk_feat", "feat_type", "remat",
})


def band_layout(sr: int, enc_dim: int) -> List[Tuple[int, int]]:
    """Sub-band widths -> run-length groups [(n_bands, width), ...]:
    15 x 100 Hz, 10 x 200 Hz, 5 x 500 Hz, 1 x 2 kHz, then the remainder."""
    bw100 = int(np.floor(100 / (sr / 2.0) * enc_dim))
    bw200 = int(np.floor(200 / (sr / 2.0) * enc_dim))
    bw500 = int(np.floor(500 / (sr / 2.0) * enc_dim))
    bw2k = int(np.floor(2000 / (sr / 2.0) * enc_dim))
    widths = [bw100] * 15 + [bw200] * 10 + [bw500] * 5 + [bw2k]
    widths.append(enc_dim - int(np.sum(widths)))
    groups: List[Tuple[int, int]] = []
    for w in widths:
        if groups and groups[-1][1] == w:
            groups[-1] = (groups[-1][0] + 1, w)
        else:
            groups.append((1, w))
    return groups


def _norm_stats(x32, dims):
    """Single-pass GroupNorm statistics E[x^2] - E[x]^2, as the JAX
    package computes them."""
    mean = x32.mean(dim=dims, keepdim=True)
    m2 = x32.square().mean(dim=dims, keepdim=True)
    var = (m2 - mean.square()).clamp_min(0.0)
    return mean, torch.rsqrt(var + _EPS)


class GroupedBandNorm(nn.Module):
    """Per-band GroupNorm(1, C) over (T, C) on [B, n, T, C]."""

    def __init__(self, n_bands: int, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n_bands, channels))
        self.bias = nn.Parameter(torch.zeros(n_bands, channels))

    def forward(self, x):
        x32 = x.float()
        mean, inv = _norm_stats(x32, (2, 3))
        y = (x32 - mean) * inv
        y = y * self.scale[None, :, None, :] + self.bias[None, :, None, :]
        return y.to(x.dtype)


class GroupedBandDense(nn.Module):
    """Per-band 1x1 conv as one batched einsum: [B,n,T,Cin] -> [B,n,T,Cout]."""

    def __init__(self, n_bands: int, in_features: int, features: int):
        super().__init__()
        self.kernel = uniform_param(n_bands, in_features, features,
                                    fan_in=in_features)
        self.bias = uniform_param(n_bands, features, fan_in=in_features)

    def forward(self, x):
        y = torch.einsum("bntc,ncd->bntd", x, self.kernel.to(x.dtype))
        return (y.float() + self.bias[None, :, None, :]).to(x.dtype)


class ResRNN(nn.Module):
    """GroupNorm(1, N) -> BiLSTM -> Dense -> residual, on [B', S, N]."""

    def __init__(self, channels: int, hidden: int,
                 bidirectional: bool = True):
        super().__init__()
        self.norm_scale = nn.Parameter(torch.ones(channels))
        self.norm_bias = nn.Parameter(torch.zeros(channels))
        self.rnn = LSTM(channels, hidden, bidirectional=bidirectional)
        self.proj = Dense(hidden * (2 if bidirectional else 1), channels)

    def forward(self, x):
        x32 = x.float()
        mean, inv = _norm_stats(x32, (1, 2))
        y = ((x32 - mean) * inv * self.norm_scale + self.norm_bias).to(x.dtype)
        return x + self.proj(self.rnn(y))


class BSNet(nn.Module):
    """One separator repeat on [B, nband, T, N]: band RNN over time, then
    comm RNN over bands."""

    def __init__(self, feature_dim: int, bidirectional: bool = True):
        super().__init__()
        hidden = feature_dim * 2
        self.band_rnn = ResRNN(feature_dim, hidden, bidirectional)
        self.band_comm = ResRNN(feature_dim, hidden, bidirectional)

    def forward(self, x):
        b, nband, t, n = x.shape
        y = self.band_rnn(x.reshape(b * nband, t, n)).reshape(b, nband, t, n)
        z = y.transpose(1, 2).reshape(b * t, nband, n)
        z = self.band_comm(z)
        return z.reshape(b, t, nband, n).transpose(1, 2)


class BSRNN(nn.Module):
    """Band-split RNN TSE model, pre-extracted embeddings (v1 recipe)."""

    def __init__(
        self,
        spk_emb_dim: int = 256,
        sr: int = 16000,
        win: int = 512,
        stride: int = 128,
        feature_dim: int = 128,
        num_repeat: int = 6,
        use_spk_transform: bool = True,
        use_bidirectional: bool = True,
        spk_fuse_type: str = "concat",
        multi_fuse: bool = True,
        joint_training: bool = True,
        **jax_only,
    ):
        super().__init__()
        unknown = set(jax_only) - _JAX_ONLY_ARGS
        if unknown:
            raise TypeError(f"BSRNN got unknown arguments {sorted(unknown)}")
        if joint_training:
            raise NotImplementedError(
                "joint_training=True (the v2 recipe's speaker branch) is not "
                "ported yet; see ROADMAP.md, joint v2 BSRNN"
            )
        self.win = win
        self.stride = stride
        self.num_repeat = num_repeat
        self.multi_fuse = multi_fuse
        self.use_spk_transform = use_spk_transform
        self.groups = band_layout(sr, win // 2 + 1)
        self.register_buffer("window", hann_window(win), persistent=False)
        for gi, (n, bw) in enumerate(self.groups):
            self.add_module(f"bn_norm_{gi}", GroupedBandNorm(n, 2 * bw))
            self.add_module(f"bn_proj_{gi}",
                            GroupedBandDense(n, 2 * bw, feature_dim))
        for j in range(num_repeat if multi_fuse else 1):
            self.add_module(f"fuse_{j}", SpeakerFuse(
                feature_dim, spk_emb_dim, spk_fuse_type))
        for j in range(num_repeat):
            self.add_module(f"bsnet_{j}",
                            BSNet(feature_dim, use_bidirectional))
        for gi, (n, bw) in enumerate(self.groups):
            self.add_module(f"mask_norm_{gi}", GroupedBandNorm(n, feature_dim))
            self.add_module(f"mask_fc1_{gi}", GroupedBandDense(
                n, feature_dim, feature_dim * 4))
            self.add_module(f"mask_fc2_{gi}", GroupedBandDense(
                n, feature_dim * 4, feature_dim * 4))
            self.add_module(f"mask_out_{gi}", GroupedBandDense(
                n, feature_dim * 4, bw * 4))
        if use_spk_transform:
            self.spk_transform = SpeakerTransform(spk_emb_dim)

    def _band_split(self, re, im):
        """[B, T, F] spec -> (features [B, nband, T, N],
        per-group sub-spectra [(re, im) [B, n, T, bw]])."""
        b, t_frames, _ = re.shape
        feats, sub_specs = [], []
        f0 = 0
        for gi, (n, bw) in enumerate(self.groups):
            def slice_g(a):
                g = a[..., f0:f0 + n * bw].reshape(b, t_frames, n, bw)
                return g.transpose(1, 2)

            re_g, im_g = slice_g(re), slice_g(im)
            sub_specs.append((re_g, im_g))
            x = torch.cat([re_g, im_g], dim=-1)
            x = getattr(self, f"bn_norm_{gi}")(x)
            feats.append(getattr(self, f"bn_proj_{gi}")(x))
            f0 += n * bw
        return torch.cat(feats, dim=1), sub_specs

    def _mask_reconstruct(self, x, sub_specs, nsample):
        """Per-band tanh-gated complex masks + reassembly + iSTFT."""
        b, _, t_frames, _ = x.shape
        est_re, est_im = [], []
        band0 = 0
        for gi, (n, bw) in enumerate(self.groups):
            y = getattr(self, f"mask_norm_{gi}")(x[:, band0:band0 + n])
            y = torch.tanh(getattr(self, f"mask_fc1_{gi}")(y))
            y = torch.tanh(getattr(self, f"mask_fc2_{gi}")(y))
            y = getattr(self, f"mask_out_{gi}")(y)
            # channel layout (2, 2, bw): [gate, filter] x [real, imag]
            y = y.reshape(*y.shape[:3], 2, 2, bw)
            m = y[..., 0, :, :] * torch.sigmoid(y[..., 1, :, :])
            m_re, m_im = m[..., 0, :], m[..., 1, :]
            s_re, s_im = sub_specs[gi]
            est_re.append(s_re * m_re - s_im * m_im)
            est_im.append(s_re * m_im + s_im * m_re)
            band0 += n

        def merge(parts):
            return torch.cat(
                [p.transpose(1, 2).reshape(b, t_frames, -1) for p in parts],
                dim=-1,
            )

        return istft(merge(est_re), merge(est_im), self.win, self.stride,
                     window=self.window, length=nsample)

    def forward(self, mix, embed):
        nsample = mix.shape[-1]
        re, im = stft(mix, self.win, self.stride, window=self.window)
        x, sub_specs = self._band_split(re, im)
        if self.use_spk_transform:
            embed = self.spk_transform(embed)
        for r in range(self.num_repeat):
            if r == 0 or self.multi_fuse:
                x = getattr(self, f"fuse_{r if self.multi_fuse else 0}")(
                    x, embed)
            x = getattr(self, f"bsnet_{r}")(x)
        return self._mask_reconstruct(x, sub_specs, nsample), None
