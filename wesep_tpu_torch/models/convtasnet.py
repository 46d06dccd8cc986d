"""ConvTasNet / SpEx+ target-speaker extraction, channels-last.

Counterpart of wesep_tpu/models/convtasnet.py: the same modules, the same
parameter names and shapes (so a JAX param tree and its BatchNorm
statistics flatten onto the state_dict, utils/jax_params.py) and the same
forward contract, `(mix [B, T], enroll) -> (ests, spk_logits)`: `ests` is a
list [est1, est2, est3] for the Multi decoder and one [B, T] tensor
otherwise; `spk_logits` is None unless `multi_task`. `enroll` is a waveform
[B, T_e] with `joint_training` and an embedding [B, E] without.

A TCN block with gLN and no skip connection runs as one call of the fused
block `ops/cuda_tcn.tcn_block_gln` (CUDA kernels on the card, their plain
version on the CPU); the speaker-fused block folds its embedding into that
call's per-sample bias. Blocks with cLN, BN or a skip connection are built
of the plain modules. Train or eval mode (the BatchNorm statistics of the
speaker encoder) follows `module.training`.
"""

import torch
from torch import nn
from torch.nn import functional as F

from wesep_tpu_torch.models.common import (
    BatchNorm,
    ChannelLayerNorm,
    Conv1d,
    Dense,
    GlobalLayerNorm,
    PReLU,
    SpeakerFuse,
    SpeakerTransform,
    get_norm,
    norm_auto_name,
)
from wesep_tpu_torch.ops.cuda_tcn import kernel_fits, tcn_block_gln

__all__ = ["ConvTasNet", "TCNBlock", "FuseTCNBlock", "TCNStack"]


class ConvTranspose1d(nn.Module):
    """Transposed 1-D convolution on [B, T, C] without padding: one product
    x @ W -> windows [B, T, k, F], then the windows are added at stride s.
    `ConvTranspose_0.kernel` [k, Cin, F] is stored as the JAX tree stores
    it, spatially reversed: tap j of a window uses kernel[k - 1 - j]."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int):
        super().__init__()
        self.stride = stride
        held = nn.Module()
        fan_in = features * kernel_size
        held.kernel = nn.Parameter(
            torch.empty(kernel_size, in_channels, features))
        held.bias = nn.Parameter(torch.empty(features))
        bound = fan_in ** -0.5
        for p in held.parameters():
            nn.init.uniform_(p, -bound, bound)
            p.jax_init = ("uniform", bound)
        self.ConvTranspose_0 = held

    def forward(self, x):
        kernel = self.ConvTranspose_0.kernel.to(x.dtype)
        k, _, f = kernel.shape
        b, t, _ = x.shape
        windows = torch.einsum("btc,kcf->bfkt", x, kernel.flip(0))
        out_len = (t - 1) * self.stride + k
        out = F.fold(windows.reshape(b, f * k, t), (1, out_len), (1, k),
                     stride=(1, self.stride))  # [B, F, 1, out_len]
        return out[:, :, 0].transpose(1, 2) \
            + self.ConvTranspose_0.bias.to(x.dtype)


class _TCNBlockBase(nn.Module):
    """1x1 -> PReLU -> norm -> depthwise dilated conv -> PReLU -> norm ->
    1x1, residual; `extra` input channels of the first 1x1 take a speaker
    embedding."""

    def __init__(self, in_channels, conv_channels, kernel_size, dilation,
                 norm, causal, skip_con, extra=0):
        super().__init__()
        self.in_channels = in_channels
        self.kernel_size, self.dilation = kernel_size, dilation
        self.norm, self.causal, self.skip_con = norm, causal, skip_con
        # runs the kernels' plain version on any device: for checks on the
        # card, set by nothing on the serving or training path
        self.plain = False
        span = dilation * (kernel_size - 1)
        self.Conv1d_0 = Conv1d(in_channels + extra, conv_channels, 1)
        self.PReLU_0 = PReLU()
        setattr(self, norm_auto_name(norm, 0), get_norm(norm, conv_channels))
        self.Conv1d_1 = Conv1d(
            conv_channels, conv_channels, kernel_size, dilation=dilation,
            groups=conv_channels,
            padding=(span, 0) if causal else span // 2)
        self.PReLU_1 = PReLU()
        setattr(self, norm_auto_name(norm, 1), get_norm(norm, conv_channels))
        self.Conv1d_2 = Conv1d(conv_channels, in_channels, 1)
        if skip_con:
            self.Conv1d_3 = Conv1d(conv_channels, in_channels, 1)

    @property
    def fused(self) -> bool:
        """gLN blocks without a skip connection take the fused kernel where
        it takes their shapes (`cuda_tcn.kernel_fits`); the others run the
        plain modules, as the JAX package's blocks do where its kernel does
        not apply."""
        return (self.norm == "gLN" and not self.skip_con
                and kernel_fits(self.in_channels,
                                self.Conv1d_0.Conv_0.kernel.shape[-1],
                                self.kernel_size))

    def _norm(self, idx):
        return getattr(self, norm_auto_name(self.norm, idx))

    def _fused_block(self, x, embed=None):
        """One call of the fused block; the embedding's share of the first
        1x1, embed @ W1[C:], goes into the per-sample bias."""
        conv1, conv2 = self.Conv1d_0.Conv_0, self.Conv1d_2.Conv_0
        w1_full = conv1.kernel[0]
        b1_eff = conv1.bias[None, :].expand(x.shape[0], -1)
        if embed is not None:
            b1_eff = b1_eff + torch.matmul(embed.float(),
                                           w1_full[self.in_channels:])
        gln0, gln1 = self._norm(0), self._norm(1)
        return tcn_block_gln(
            x, b1_eff, w1_full[:self.in_channels], self.PReLU_0.alpha,
            self.Conv1d_1.kernel[:, 0], self.Conv1d_1.bias, gln0.weight,
            gln0.bias, self.PReLU_1.alpha, conv2.kernel[0], conv2.bias,
            gln1.weight, gln1.bias, self.dilation, self.kernel_size,
            self.causal, GlobalLayerNorm.eps, plain=self.plain)

    def _plain_block(self, x, y):
        y = self._norm(0)(self.PReLU_0(self.Conv1d_0(y)))
        y = self._norm(1)(self.PReLU_1(self.Conv1d_1(y)))
        out = x + self.Conv1d_2(y)
        if self.skip_con:
            return self.Conv1d_3(y), out
        return out


class TCNBlock(_TCNBlockBase):
    """TCN block; returns x + out, or (skip, x + out) with `skip_con`."""

    def __init__(self, in_channels: int, conv_channels: int = 512,
                 kernel_size: int = 3, dilation: int = 1, norm: str = "gLN",
                 causal: bool = False, skip_con: bool = False):
        super().__init__(in_channels, conv_channels, kernel_size, dilation,
                         norm, causal, skip_con)

    def forward(self, x):
        if self.fused:
            return self._fused_block(x)
        return self._plain_block(x, x)


class FuseTCNBlock(_TCNBlockBase):
    """TCN block with the speaker embedding concatenated at the input 1x1
    ('concatConv' fusion)."""

    def __init__(self, in_channels: int, embed_dim: int,
                 conv_channels: int = 512, kernel_size: int = 3,
                 dilation: int = 1, norm: str = "cLN", causal: bool = False):
        super().__init__(in_channels, conv_channels, kernel_size, dilation,
                         norm, causal, False, extra=embed_dim)

    def forward(self, x, embed):
        if self.fused:
            return self._fused_block(x, embed)
        tile = embed[:, None, :].expand(-1, x.shape[1], -1).to(x.dtype)
        return self._plain_block(x, torch.cat([x, tile], dim=-1))


class TCNStack(nn.Module):
    """R x X dilated TCN blocks (dilation 2^x from `start_dilation`)."""

    def __init__(self, in_channels: int, R: int = 3, X: int = 8,
                 conv_channels: int = 512, kernel_size: int = 3,
                 norm: str = "gLN", causal: bool = False,
                 skip_con: bool = False, start_dilation: int = 0):
        super().__init__()
        self.skip_con = skip_con
        self.blocks = []
        for _ in range(R):
            for p in range(start_dilation, X):
                blk = TCNBlock(in_channels, conv_channels, kernel_size,
                               2 ** p, norm, causal, skip_con)
                setattr(self, f"TCNBlock_{len(self.blocks)}", blk)
                self.blocks.append(blk)

    def forward(self, x):
        skip_sum = 0.0
        for blk in self.blocks:
            if self.skip_con:
                skip, x = blk(x)
                skip_sum = skip_sum + skip
            else:
                x = blk(x)
        return skip_sum if self.skip_con else x


class MultiScaleEncoder(nn.Module):
    """Three parallel learned encoders (short, middle, long filters) at one
    stride L1 // 2, inputs right-padded so all give the same frames.
    Returns (bottleneck [B, T', out], w1, w2, w3 [B, T', middle])."""

    def __init__(self, middle_channels: int = 256, out_channels: int = 256,
                 L1: int = 20, L2: int = 80, L3: int = 160):
        super().__init__()
        self.lengths = (L1, L2, L3)
        stride = L1 // 2
        self.enc_short = Conv1d(1, middle_channels, L1, stride=stride)
        self.enc_middle = Conv1d(1, middle_channels, L2, stride=stride)
        self.enc_long = Conv1d(1, middle_channels, L3, stride=stride)
        self.ChannelLayerNorm_0 = ChannelLayerNorm(3 * middle_channels)
        self.proj = Conv1d(3 * middle_channels, out_channels, 1)

    def forward(self, x):
        L1, L2, L3 = self.lengths
        stride = L1 // 2
        x = x[..., None]
        t = x.shape[1]
        n_frames = (t - L1) // stride + 1
        w1 = torch.relu(self.enc_short(x))
        pad2 = max((n_frames - 1) * stride + L2 - t, 0)
        pad3 = max((n_frames - 1) * stride + L3 - t, 0)
        w2 = torch.relu(self.enc_middle(F.pad(x, (0, 0, 0, pad2))))
        w3 = torch.relu(self.enc_long(F.pad(x, (0, 0, 0, pad3))))
        e = self.proj(self.ChannelLayerNorm_0(torch.cat([w1, w2, w3], -1)))
        return e, w1, w2, w3


class DeepEncoder(nn.Module):
    """Strided conv, then four dilated convs each followed by a PReLU."""

    def __init__(self, out_channels: int, kernel_size: int, stride: int):
        super().__init__()
        self.Conv1d_0 = Conv1d(1, out_channels, kernel_size, stride=stride)
        for i, d in enumerate((1, 2, 4, 8)):
            setattr(self, f"Conv1d_{i + 1}", Conv1d(
                out_channels, out_channels, 3, dilation=d, padding=d))
            setattr(self, f"PReLU_{i}", PReLU())

    def forward(self, x):
        y = self.Conv1d_0(x[..., None])
        for i in range(4):
            y = getattr(self, f"PReLU_{i}")(
                getattr(self, f"Conv1d_{i + 1}")(y))
        return y


class ResBlockSpk(nn.Module):
    """Pointwise residual block with BatchNorm, PReLU and MaxPool1d(3)
    (windows of 3 that do not overlap, the remainder dropped)."""

    def __init__(self, in_dims: int, out_dims: int):
        super().__init__()
        self.Conv1d_0 = Conv1d(in_dims, out_dims, 1, use_bias=False)
        self.BatchNorm_0 = BatchNorm(out_dims)
        self.PReLU_0 = PReLU()
        self.Conv1d_1 = Conv1d(out_dims, out_dims, 1, use_bias=False)
        self.BatchNorm_1 = BatchNorm(out_dims)
        if in_dims != out_dims:
            self.Conv1d_2 = Conv1d(in_dims, out_dims, 1, use_bias=False)
        self.PReLU_1 = PReLU()

    def forward(self, x):
        y = self.Conv1d_0(x)
        y = self.PReLU_0(self.BatchNorm_0(y).to(y.dtype))
        y = self.Conv1d_1(y)
        y = self.BatchNorm_1(y).to(y.dtype)
        residual = self.Conv1d_2(x) if hasattr(self, "Conv1d_2") else x
        y = self.PReLU_1(y + residual)
        t = y.shape[1] - y.shape[1] % 3
        return y[:, :t].reshape(y.shape[0], t // 3, 3, y.shape[-1]).amax(2)


class SpExSpeakerEncoder(nn.Module):
    """cLN -> 1x1 -> ResBlock(256) -> ResBlock(512) -> ResBlock(512) -> 1x1
    -> mean over time -> [B, E], over the shared encoder's features."""

    def __init__(self, in_dims: int, embed_dim: int = 256):
        super().__init__()
        self.ChannelLayerNorm_0 = ChannelLayerNorm(in_dims)
        self.Conv1d_0 = Conv1d(in_dims, 256, 1)
        self.ResBlockSpk_0 = ResBlockSpk(256, 256)
        self.ResBlockSpk_1 = ResBlockSpk(256, 512)
        self.ResBlockSpk_2 = ResBlockSpk(512, 512)
        self.Conv1d_1 = Conv1d(512, embed_dim, 1)

    def forward(self, x):
        y = self.Conv1d_0(self.ChannelLayerNorm_0(x))
        y = self.ResBlockSpk_2(self.ResBlockSpk_1(self.ResBlockSpk_0(y)))
        return self.Conv1d_1(y).mean(dim=1)


class ConvTasNet(nn.Module):
    """SpEx+ / ConvTasNet TSE model; the defaults are those of
    examples/librimix/tse/v2/confs/spexplus.yaml.

    `remat`, `fuse_gln` and `pallas_tcn` steer how the JAX package computes
    the TCN blocks (rematerialisation, an algebraic rewrite, its kernel) and
    change no result; they are accepted and ignored here (a fused block
    already saves only its input and four statistics per sample for the
    backward), but for `remat`'s block names, which the JAX package's
    initial weights are drawn under (utils/jax_init.py)."""

    def __init__(self, N: int = 256, L: int = 20, B: int = 256, H: int = 512,
                 P: int = 3, X: int = 8, R: int = 4, spk_emb_dim: int = 256,
                 norm: str = "gLN", activate: str = "relu",
                 causal: bool = False, skip_con: bool = False,
                 spk_fuse_type: str = "concatConv", multi_fuse: bool = True,
                 use_spk_transform: bool = False, encoder_type="Multi",
                 decoder_type="Multi", joint_training: bool = True,
                 multi_task: bool = False, spks_in_train: int = 251,
                 spk_feat: bool = False, feat_type: str = "consistent",
                 remat: bool = False, fuse_gln: bool = True,
                 pallas_tcn: bool = True):
        super().__init__()
        if activate not in ("relu", "sigmoid", "softmax"):
            raise ValueError(activate)
        if joint_training and (spk_feat or feat_type != "consistent"):
            raise NotImplementedError(
                "SpEx+ embeds the enrollment waveform with its own encoder; "
                "the JAX package attaches no external speaker encoder or "
                "fbank cue to ConvTasNet either (see ROADMAP.md queue C)")
        self.L, self.activate = L, activate
        self.encoder_type, self.decoder_type = encoder_type, decoder_type
        self.joint_training, self.multi_task = joint_training, multi_task
        self.multi_fuse, self.spk_fuse_type = multi_fuse, spk_fuse_type
        self.norm, self.R, self.remat = norm, R, remat
        stride = L // 2

        if encoder_type == "Multi":
            self.encoder = MultiScaleEncoder(N, B, L, 80, 160)
            aux_dims = 3 * N
        else:
            self.encoder = DeepEncoder(N, L, stride) \
                if encoder_type == "Deep" else Conv1d(1, N, L, stride=stride)
            self.ln_s = ChannelLayerNorm(N)
            self.bottleneck = Conv1d(N, B, 1)
            aux_dims = B
        if joint_training:
            self.spk_model = SpExSpeakerEncoder(aux_dims, spk_emb_dim)
            if multi_task:
                self.pred_linear = Dense(spk_emb_dim, spks_in_train)
        if use_spk_transform:
            self.spk_transform = SpeakerTransform(spk_emb_dim)

        tcn = dict(conv_channels=H, kernel_size=P, norm=norm, causal=causal)
        concat_conv = spk_fuse_type == "concatConv"
        repeats = range(R) if multi_fuse else range(1)
        for r in repeats:
            if concat_conv:
                setattr(self, f"fuse_{r}", FuseTCNBlock(B, spk_emb_dim, **tcn))
            else:
                setattr(self, f"fuse_{r}",
                        SpeakerFuse(B, spk_emb_dim, spk_fuse_type))
                setattr(self, f"fuse_act_{r}", PReLU())
                setattr(self, norm_auto_name(norm, r), get_norm(norm, B))
        if multi_fuse:
            for r in range(R):
                setattr(self, f"tcn_{r}", TCNStack(
                    B, R=1, X=X, skip_con=skip_con,
                    start_dilation=1 if concat_conv else 0, **tcn))
        else:
            self.tcn = TCNStack(B, R=R, X=X, skip_con=skip_con, **tcn)

        if decoder_type == "Multi":
            for i, k in enumerate((L, 80, 160)):
                setattr(self, f"mask_{i}", Conv1d(B, N, 1))
                setattr(self, f"dec_{i}", ConvTranspose1d(N, 1, k, stride))
        else:
            self.gen_masks = Conv1d(B, N, 1)
            self.dec = ConvTranspose1d(N, 1, L, stride)

    def _activation(self, x):
        if self.activate == "relu":
            return torch.relu(x)
        if self.activate == "sigmoid":
            return torch.sigmoid(x)
        return torch.softmax(x, dim=0)

    def _encode(self, wav):
        """(bottleneck features, what the decoder masks, what the speaker
        encoder reads)."""
        if self.encoder_type == "Multi":
            e, w1, w2, w3 = self.encoder(wav)
            return e, (w1, w2, w3), torch.cat([w1, w2, w3], dim=-1)
        enc_out = self.encoder(wav) if self.encoder_type == "Deep" \
            else torch.relu(self.encoder(wav[..., None]))
        e = self.bottleneck(self.ln_s(enc_out))
        return e, (enc_out,), e

    def _fuse(self, r, x, embed):
        if self.spk_fuse_type == "concatConv":
            return getattr(self, f"fuse_{r}")(x, embed)
        x = getattr(self, f"fuse_{r}")(x, embed.to(x.dtype))
        x = getattr(self, f"fuse_act_{r}")(x)
        return getattr(self, norm_auto_name(self.norm, r))(x)

    def forward(self, mix, enroll):
        """mix [B, T] wav; enroll [B, T_e] wav (joint) or [B, E]."""
        spk_logits = None
        x, masked, _ = self._encode(mix)
        if self.joint_training:
            embed = self.spk_model(self._encode(enroll)[2])
            if self.multi_task:
                spk_logits = self.pred_linear(embed)
        else:
            embed = enroll
        if hasattr(self, "spk_transform"):
            embed = self.spk_transform(embed)

        if self.multi_fuse:
            for r in range(self.R):
                x = getattr(self, f"tcn_{r}")(self._fuse(r, x, embed))
        else:
            x = self.tcn(self._fuse(0, x, embed))

        t_len = mix.shape[-1]
        if self.decoder_type == "Multi":
            ests = []
            for i, w in enumerate(masked):
                m = self._activation(getattr(self, f"mask_{i}")(x))
                s = getattr(self, f"dec_{i}")(w * m)[..., 0]
                ests.append(s[..., :t_len])
            min_len = min(e.shape[-1] for e in ests)
            return [e[..., :min_len] for e in ests], spk_logits
        m = self._activation(self.gen_masks(x))
        est = self.dec(masked[0] * m)[..., 0][..., :t_len]
        return est, spk_logits
