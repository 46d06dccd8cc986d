"""CMGAN metric discriminator (Interspeech 2022, arXiv:2203.15149).

Counterpart of wesep_tpu/models/discriminator.py, NCHW where the JAX
package is NHWC: the magnitude spectrograms of (reference, estimate)
stacked as [B, 2, T', F], `num_conv_blocks` spectral-norm 4x4 stride-2
convolutions each followed by an affine instance norm and a per-channel
PReLU, a max over (T', F), a spectral-norm Dense stack with dropout 0.3
before its PReLU, and a learnable sigmoid predicting the normalised metric
[B, 1].

Spectral norm is flax's `nn.SpectralNorm` (flax 0.12.3), not torch's
parametrization:

  * the kernel is viewed as a matrix [-1, out] in flax's layout (HWIO for a
    conv, [in, out] for a Dense), u is [1, out], eps 1e-12, one power step
    v = l2n(u W^T), u' = l2n(v W);
  * the power step runs on every call, in eval mode too; train mode only
    decides whether u' and sigma are stored (the buffers `u`, `sigma`);
  * sigma = v W u'^T with u' and v detached, so the gradient flows through
    W alone; W / sigma is the weight used (sigma 0 divides by 1);
  * only kernels are normalised, never the 1-D biases.

Weights are torch's layout (conv OIHW, Dense [out, in]); the bridge
`utils.jax_params.discriminator_state_dict_from_jax` maps a flax tree onto
them. PReLU is `where(x >= 0, x, a * x)` (F.prelu's input gradient differs
at 0), and the pooling is `amax`, which splits the gradient evenly among
ties as `jnp.max` does. Dropout takes explicit masks, one [B, features]
per Dense layer but the last (kept elements scaled by 1 / 0.7), so that a
caller can give every call of a step the same draw (`dropout_mask`: flax
Dropout's draw from a step's key).

`init_like_jax` gives the JAX package's initial D: `discriminator.init(
{"params": PRNGKey(1), "dropout": PRNGKey(2)}, ..., train=True)` of
wesep_tpu/bin/train_gan.py, whose parameters flax keys by their scope,
whose u each `SpectralNorm_{j}` scope draws from N(0, 1), and whose forward
stores one power step (u, sigma, and each kernel divided by its sigma).
"""

from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from wesep_tpu_torch.models.dpccn import instance_norm
from wesep_tpu_torch.ops.stft import hann_window, stft

__all__ = ["CMGANDiscriminator", "LearnableSigmoid", "SpectralNormed",
           "DROPOUT_RATE"]

DROPOUT_RATE = 0.3
_SN_EPS = 1e-12


def _lecun_normal(*shape, fan_in: int) -> nn.Parameter:
    """flax's default kernel init: truncated normal, variance 1 / fan_in
    (torch's draw; utils/jax_init draws flax's, `jax_init`, in the flax
    layout `jax_shape`, mapped to this one by `jax_to_port`)."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    w = torch.empty(*shape)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)
    param = nn.Parameter(w)
    param.jax_init = ("lecun_normal",)
    if len(shape) == 4:  # OIHW <- HWIO
        param.jax_shape = (shape[2], shape[3], shape[1], shape[0])
        param.jax_to_port = lambda t: t.permute(3, 2, 0, 1)
    else:  # [out, in] <- [in, out]
        param.jax_shape = (shape[1], shape[0])
        param.jax_to_port = lambda t: t.t()
    return param


def _l2_normalize(x):
    return x * torch.rsqrt(x.square().sum() + _SN_EPS)


class SpectralNormed(nn.Module):
    """A kernel `weight` (torch layout, out first), an optional `bias`, and
    flax's spectral-norm state: buffers `u` [1, out] and `sigma` []."""

    def __init__(self, weight_shape, fan_in: int, bias: bool):
        super().__init__()
        self.weight = _lecun_normal(*weight_shape, fan_in=fan_in)
        if bias:
            self.bias = nn.Parameter(torch.zeros(weight_shape[0]))
            self.bias.jax_init = ("zeros",)
        else:
            self.register_parameter("bias", None)
        self.register_buffer("u", torch.randn(1, weight_shape[0]))
        self.register_buffer("sigma", torch.ones(()))

    def flax_matrix(self) -> torch.Tensor:
        """The kernel as flax reshapes it: [-1, out] of HWIO or [in, out]."""
        w = self.weight
        if w.dim() == 4:  # OIHW -> HWIO
            w = w.permute(2, 3, 1, 0)
        else:  # [out, in] -> [in, out]
            w = w.t()
        return w.reshape(-1, w.shape[-1])

    def normalized_weight(self, update: bool) -> torch.Tensor:
        """weight / sigma after one power step from `u`; with `update`, the
        step's u and sigma are stored."""
        mat = self.flax_matrix()
        with torch.no_grad():
            v = _l2_normalize(self.u @ mat.detach().t())
            u = _l2_normalize(v @ mat.detach())
        sigma = ((v @ mat) @ u.t())[0, 0]
        if update:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return self.weight / torch.where(sigma != 0, sigma,
                                         torch.ones_like(sigma))


class LearnableSigmoid(nn.Module):
    def __init__(self, features: int, beta: float = 1.0):
        super().__init__()
        self.beta = beta
        self.slope = nn.Parameter(torch.ones(features))

    def forward(self, x):
        return self.beta * torch.sigmoid(self.slope * x)


class _PReLU(nn.Module):
    """Per-channel PReLU over the last axis (torch nn.PReLU(C)'s slopes)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha * x)


class CMGANDiscriminator(nn.Module):
    def __init__(self, n_fft: int = 400, hop: int = 100,
                 in_channels: int = 2, hid_chans: int = 16,
                 ksz: Tuple[int, int] = (4, 4),
                 stride: Tuple[int, int] = (2, 2),
                 padding: Tuple[int, int] = (1, 1), bias: bool = False,
                 num_conv_blocks: int = 4, num_linear_layers: int = 2):
        super().__init__()
        self.n_fft, self.hop = n_fft, hop
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.num_conv_blocks = num_conv_blocks
        self.num_linear_layers = num_linear_layers
        self.register_buffer("window", hann_window(n_fft), persistent=False)
        in_ch, out_ch = in_channels, hid_chans
        kh, kw = ksz
        for i in range(num_conv_blocks):
            self.add_module(f"conv_{i}", SpectralNormed(
                (out_ch, in_ch, kh, kw), kh * kw * in_ch, bias))
            self.register_parameter(f"in_scale_{i}",
                                    nn.Parameter(torch.ones(out_ch)))
            self.register_parameter(f"in_bias_{i}",
                                    nn.Parameter(torch.zeros(out_ch)))
            self.add_module(f"prelu_{i}", _PReLU(out_ch))
            in_ch, out_ch = out_ch, hid_chans * (2 ** (i + 1))
        for i in range(num_linear_layers - 1):
            feats = hid_chans * (2 ** (num_conv_blocks - 2 - i))
            self.add_module(f"fc_{i}", SpectralNormed((feats, in_ch), in_ch,
                                                      True))
            self.add_module(f"fc_prelu_{i}", _PReLU(feats))
            in_ch = feats
        self.dropout_features = [hid_chans * (2 ** (num_conv_blocks - 2 - i))
                                 for i in range(num_linear_layers - 1)]
        self.fc_final = SpectralNormed((1, in_ch), in_ch, True)
        self.lsigmoid = LearnableSigmoid(1)

    def init_like_jax(self, seed: int = 1, device=None):
        """The JAX package's initial D at PRNGKey(`seed`): the parameters
        (utils/jax_init.init_like_jax), each SpectralNorm_{j}'s u drawn
        from N(0, 1) with its scope's key, then the one power step that
        flax's init stores: u, sigma, and the kernel divided by sigma (flax
        writes the normalised kernel back as the parameter)."""
        from wesep_tpu_torch.utils import jax_init

        jax_init.init_like_jax(self, seed, device=device)
        root = jax_init.seed_key(seed)
        normed = [m for m in self.modules() if isinstance(m, SpectralNormed)]
        with torch.no_grad():
            for j, sn in enumerate(normed):
                key = jax_init.fold_in_static(root, (f"SpectralNorm_{j}", 1))
                sn.u.copy_(jax_init.normal(key, tuple(sn.u.shape),
                                           device or "cpu"))
                sn.weight.copy_(sn.normalized_weight(update=True))
        return self

    def dropout_mask(self, batch: int, key, device=None
                     ) -> List[torch.Tensor]:
        """flax Dropout's draw from `key` (a jax PRNG key's two words, the
        `dropout` key an apply is given), [batch, features] per dropout
        layer `Dropout_{i}`: keep where U[0, 1) < 0.7, kept elements scaled
        by 1 / 0.7. Drawn on the CPU (the same draw on every device), then
        moved to `device`."""
        from wesep_tpu_torch.utils import jax_init

        keep = 1.0 - DROPOUT_RATE
        masks = []
        for i, feats in enumerate(self.dropout_features):
            u = jax_init.uniform(
                jax_init.fold_in_static(key, (f"Dropout_{i}", 1)),
                (batch, feats), 0.0, 1.0)
            masks.append(((u < keep).float() / keep).to(
                device or self.fc_final.weight.device))
        return masks

    def forward(self, ref_wav, est_wav, dropout_mask=None):
        """(ref [B, T], est [B, T]) -> predicted normalised metric [B, 1].

        In train mode the spectral-norm state moves once and dropout applies
        `dropout_mask`, a draw of `dropout_mask()` that every call of one
        step shares; in eval mode neither."""
        train = self.training
        if train and dropout_mask is None:
            raise ValueError("CMGANDiscriminator in train mode needs the "
                             "step's dropout_mask")
        rr, ri = stft(ref_wav, self.n_fft, self.hop, window=self.window)
        er, ei = stft(est_wav, self.n_fft, self.hop, window=self.window)
        x = torch.stack([torch.sqrt(rr * rr + ri * ri),
                         torch.sqrt(er * er + ei * ei)], dim=1)  # [B,2,T',F]
        for i in range(self.num_conv_blocks):
            sn = getattr(self, f"conv_{i}")
            x = F.conv2d(x, sn.normalized_weight(train), sn.bias,
                         stride=self.stride, padding=self.padding)
            y = instance_norm(x.permute(0, 2, 3, 1))  # [B, T', F, C]
            y = y * getattr(self, f"in_scale_{i}") \
                + getattr(self, f"in_bias_{i}")
            x = getattr(self, f"prelu_{i}")(y).permute(0, 3, 1, 2)
        x = x.amax(dim=(2, 3))  # [B, C]
        for i in range(self.num_linear_layers - 1):
            sn = getattr(self, f"fc_{i}")
            x = F.linear(x, sn.normalized_weight(train), sn.bias)
            if train:
                x = x * dropout_mask[i]
            x = getattr(self, f"fc_prelu_{i}")(x)
        x = F.linear(x, self.fc_final.normalized_weight(train),
                     self.fc_final.bias)
        return self.lsigmoid(x)
