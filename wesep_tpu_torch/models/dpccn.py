"""DPCCN target-speaker extraction in PyTorch, channels-last.

Counterpart of wesep_tpu/models/dpccn.py, on the v1 path (pre-extracted
speaker embeddings, joint_training=False) and the joint v2 path (a speaker
encoder `spk_model` on the enrollment, models/speaker, whose f32
embedding promotes everything after the speaker fuse to f32 under a bf16
stream, as in the JAX package): a densely connected pyramid U-Net over
the complex spectrogram. Feature maps are [B, T, F, C] as in the JAX
package. One forward:

  STFT (win 512 / hop 128) -> conv2d(2 -> 16) -> DenseBlock -> speaker fuse
  over the frequency axis -> 4 x [Conv2dBlock stride (1, 2) + DenseBlock]
  -> 3 Conv2dBlocks to 384 channels (F 257 -> 3) -> tcn_layers x
  tcn_blocks dilated TCN blocks on the flattened [B, T * F, C] -> mirror
  decoder with skip concatenation -> DenseBlock -> pyramid average pooling
  (avg_pool2d, 1x1 projection, bilinear upsampling) -> transposed conv to
  (re, im) -> iSTFT.

Every Conv2dBlock is conv -> ELU -> InstanceNorm. `conv_impl` picks how the
stride-1 3x3 pad-1 ones run, as in the JAX package:

  * "xla" (default): `models.common.Conv2d`, ELU and `instance_norm`, each
    with the JAX route's rounding (the conv's bias in the stream's dtype,
    the norm centred and scaled in the stream's dtype);
  * "patch": the JAX package's lane-packed rewrite of the same conv for
    the TPU (ops/patch_conv.py, exact to ~2e-6); it computes the same
    function, so here it takes the "xla" route;
  * "pallas": a block whose input has at most WESEP_CONV2D_CI_GATE
    channels (default 32) goes to the fused block `ops.cuda_conv2d
    .conv2d_block_in` (K5 forward, K5b backward) unless WESEP_CONV2D_PALLAS
    is "0": 7 blocks per forward at the recipe's widths. On a CUDA tensor
    that launches the kernels; on the CPU it runs their plain versions,
    which is what the JAX package computes under WESEP_CONV2D_PALLAS=force.
    WESEP_CONV2D_BUDGET_MB and WESEP_CONV2D_VMEM_MB size the TPU kernel's
    VMEM and mean nothing here.

forward(mix [B, T], cue) -> (est [B, T], speaker logits or None); the cue
is an embedding [B, E], or for joint training fbank [B, T', F_mel] or an
enrollment waveform. Parameter
names and shapes follow the JAX param tree, the same on every conv_impl.
"""

import os

import torch
from torch import nn
from torch.nn import functional as F

from wesep_tpu_torch.models.common import (
    Conv1d,
    Conv2d,
    ConvTranspose,
    Dense,
    SpeakerFuse,
    SpeakerTransform,
)
from wesep_tpu_torch.models.speaker import (
    embed_enrollment,
    speaker_encoder,
    speaker_frontend,
)
from wesep_tpu_torch.ops.cuda_conv2d import conv2d_block_in, kernel_fits
from wesep_tpu_torch.ops.stft import hann_window, istft, stft

__all__ = ["DPCCN", "Conv2dBlock", "ConvTrans2dBlock", "DenseBlock",
           "TCNBlock", "instance_norm"]


def instance_norm(x, eps: float = 1e-5):
    """torch InstanceNorm defaults: per (sample, channel) over the spatial
    axes of [B, *spatial, C], no affine. The statistics are f32 sums over
    x and over x * x taken in x's dtype (single pass, var = max(E[x^2] -
    mean^2, 0)); the centring and scaling stay in x's dtype, as the JAX
    package computes them."""
    axes = tuple(range(1, x.dim() - 1))
    mean = x.float().mean(dim=axes, keepdim=True)
    m2 = (x * x).float().mean(dim=axes, keepdim=True)
    var = (m2 - mean.square()).clamp_min(0.0)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return (x - mean.to(x.dtype)) * scale


def _fused_route(conv_impl: str, plain3x3: bool, in_ch: int,
                 out_ch: int) -> bool:
    """Whether a Conv2dBlock takes the fused kernel: the JAX package's gates
    (conv_impl "pallas", a plain 3x3 conv, in_ch <= WESEP_CONV2D_CI_GATE,
    WESEP_CONV2D_PALLAS not "0") and the kernel's limits on the channels
    (`cuda_conv2d.kernel_fits`); other blocks take the "xla" route, as
    the JAX package's do where its kernel does not apply."""
    if conv_impl != "pallas" or not plain3x3:
        return False
    if os.environ.get("WESEP_CONV2D_PALLAS", "1") == "0":
        return False
    return (in_ch <= int(os.environ.get("WESEP_CONV2D_CI_GATE", "32"))
            and kernel_fits(in_ch, out_ch))


class Conv2dBlock(nn.Module):
    """conv2d -> ELU -> InstanceNorm2d on [B, T, F, C]. Setting `plain =
    True` runs the fused kernel's plain versions on any device; it exists
    so a check on the card can hold the kernels against them, and nothing
    on the serving or training path sets it."""

    def __init__(self, in_dims: int, out_dims: int, kernel_size=(3, 3),
                 stride=(1, 1), padding=(1, 1), conv_impl: str = "xla"):
        super().__init__()
        self.conv = Conv2d(in_dims, out_dims, tuple(kernel_size),
                           tuple((p, p) for p in padding), tuple(stride))
        self.plain3x3 = (tuple(kernel_size) == (3, 3)
                         and tuple(stride) == (1, 1)
                         and tuple(padding) == (1, 1))
        self.conv_impl = conv_impl
        self.plain = False

    def forward(self, x):
        if _fused_route(self.conv_impl, self.plain3x3, x.shape[-1],
                        self.conv.kernel.shape[-1]):
            return conv2d_block_in(x, self.conv.kernel, self.conv.bias,
                                   plain=self.plain)
        return instance_norm(F.elu(self.conv(x)))


class ConvTrans2dBlock(nn.Module):
    """convtranspose2d -> ELU -> InstanceNorm2d. torch's padding p and
    output_padding op are a VALID transposed conv sliced to
    [p : (i - 1) * s + k - p + op] on each axis."""

    def __init__(self, in_dims: int, out_dims: int, kernel_size=(3, 3),
                 stride=(1, 2), padding=(1, 1), output_padding=(0, 0)):
        super().__init__()
        self.conv = ConvTranspose(in_dims, out_dims, tuple(kernel_size),
                                  tuple(stride))
        self.kernel_size, self.stride = tuple(kernel_size), tuple(stride)
        self.padding, self.output_padding = tuple(padding), \
            tuple(output_padding)

    def forward(self, x):
        y = self.conv(x)
        slices = [slice(None)]
        for d in range(2):
            full = (x.shape[1 + d] - 1) * self.stride[d] + self.kernel_size[d]
            out = full - 2 * self.padding[d] + self.output_padding[d]
            slices.append(slice(self.padding[d], self.padding[d] + out))
        return instance_norm(F.elu(y[tuple(slices)]))


class DenseBlock(nn.Module):
    """Five Conv2dBlocks, each on the concatenation of the input and every
    earlier output: `in_ch` channels in, `in_dims` out of the first four,
    `out_dims` out of the last."""

    def __init__(self, in_ch: int, in_dims: int, out_dims: int,
                 conv_impl: str = "xla"):
        super().__init__()
        for i in range(5):
            self.add_module(f"conv{i + 1}", Conv2dBlock(
                in_ch + i * in_dims, in_dims if i < 4 else out_dims,
                conv_impl=conv_impl))

    def forward(self, x):
        outs = [x]
        for i in range(5):
            outs.append(getattr(self, f"conv{i + 1}")(torch.cat(outs, dim=-1)))
        return outs[-1]


class TCNBlock(nn.Module):
    """IN -> ELU -> depthwise dilated conv -> IN -> ELU -> 1x1, residual,
    on [B, L, C]."""

    def __init__(self, dims: int = 384, kernel_size: int = 3,
                 dilation: int = 1, causal: bool = False):
        super().__init__()
        span = dilation * (kernel_size - 1)
        padding = (span, 0) if causal else (span // 2, span // 2)
        self.dconv1 = Conv1d(dims, dims, kernel_size, dilation=dilation,
                             groups=dims, padding=padding)
        self.dconv2 = Dense(dims, dims)

    def forward(self, x):
        y = self.dconv1(F.elu(instance_norm(x)))
        return x + self.dconv2(F.elu(instance_norm(y)))


class DPCCN(nn.Module):
    """DPCCN TSE model: pre-extracted embeddings (v1 recipe) or a jointly
    trained speaker encoder (v2); constructor options of the JAX class."""

    def __init__(
        self,
        win: int = 512,
        stride: int = 128,
        spk_emb_dim: int = 256,
        sr: int = 16000,
        use_spk_transform: bool = False,
        spk_fuse_type: str = "multiply",
        feature_dim: int = 257,
        kernel_size=(3, 3),
        stride1=(1, 1),
        stride2=(1, 2),
        paddings=(1, 1),
        output_padding=(0, 0),
        tcn_dims: int = 384,
        tcn_blocks: int = 10,
        tcn_layers: int = 2,
        causal: bool = False,
        pool_size=(4, 8, 16, 32),
        multi_fuse: bool = False,
        joint_training: bool = True,
        multi_task: bool = False,
        spksInTrain: int = 251,
        spk_model=None,
        spk_model_init=None,
        spk_model_freeze: bool = False,
        spk_args=None,
        spk_feat: bool = False,
        feat_type: str = "consistent",
        conv_impl: str = "xla",
    ):
        super().__init__()
        # multi_fuse is accepted as the JAX class accepts it (and reads it
        # nowhere); the train binary reads spk_model_init and
        # spk_model_freeze
        del multi_fuse, spk_model_init, spk_model_freeze
        self.joint_training = joint_training
        cue_dim = spk_emb_dim
        if joint_training:
            self.spk_model = speaker_encoder(spk_model, spk_args)
            cue_dim = self.spk_model.embed_dim
            self.spk_frontend = speaker_frontend(spk_args, spk_feat,
                                                 feat_type, sr, win, stride)
            self.pred_linear = Dense(cue_dim, spksInTrain) if multi_task \
                else None
        self.win, self.stride = win, stride
        self.paddings = tuple(paddings)
        self.pool_size = tuple(pool_size)
        self.use_spk_transform = use_spk_transform
        self.register_buffer("window", hann_window(win), persistent=False)
        k = tuple(kernel_size)

        def conv(cin, cout, stride_):
            return Conv2dBlock(cin, cout, k, stride_, paddings)

        def trans(cin, cout):
            return ConvTrans2dBlock(cin, cout, k, stride2, paddings,
                                    output_padding)

        self.conv2d = Conv2d(2, 16, k, tuple((p, p) for p in paddings),
                             stride1)
        self.enc0 = DenseBlock(16, 16, 16, conv_impl)
        if use_spk_transform:
            self.spk_transform = SpeakerTransform(spk_emb_dim, in_dim=cue_dim)
        self.spk_fuse = SpeakerFuse(
            feature_dim, spk_emb_dim if use_spk_transform else cue_dim,
            spk_fuse_type)
        for i in range(4):
            self.add_module(f"enc{i + 1}_conv",
                            conv(16 if i == 0 else 32, 32, stride2))
            self.add_module(f"enc{i + 1}_dense",
                            DenseBlock(32, 32, 32, conv_impl))
        for j, (cin, cout) in enumerate(((32, 64), (64, 128), (128, 384))):
            self.add_module(f"enc{5 + j}", conv(cin, cout, stride2))
        self.tcn_layers, self.tcn_blocks = tcn_layers, tcn_blocks
        for layer in range(tcn_layers):
            for blk in range(tcn_blocks):
                self.add_module(f"tcn_{layer}_{blk}",
                                TCNBlock(tcn_dims, 3, 2 ** blk, causal))
        # decoder inputs: the skip's channels + the previous output's
        for j, (cin, cout) in enumerate(((384 + tcn_dims, 128),
                                         (128 + 128, 64), (64 + 64, 32))):
            self.add_module(f"dec{j}", trans(cin, cout))
        for i in range(4):
            self.add_module(f"dec{3 + i}_dense",
                            DenseBlock(64, 32, 64, conv_impl))
            self.add_module(f"dec{3 + i}_conv",
                            trans(64, 32 if i != 3 else 16))
        self.dec7 = DenseBlock(32, 16, 32, conv_impl)
        for pi in range(len(self.pool_size)):
            self.add_module(f"avg_pool_{pi}", Dense(32, 8))
        self.avg_proj = Dense(32 + 8 * len(self.pool_size), 32)
        self.deconv2d = ConvTranspose(32, 2, k, stride1)

    def forward(self, mix, cue):
        re, im = stft(mix, self.win, self.stride, window=self.window)
        out = self.enc0(self.conv2d(torch.stack([re, im], dim=-1)))
        embed, spk_logits = cue, None
        if self.joint_training:
            embed, spk_logits = embed_enrollment(
                cue, self.spk_model, self.pred_linear, self.spk_frontend)
        if self.use_spk_transform:
            embed = self.spk_transform(embed)
        # the fuse acts on the frequency axis: [B, T, C, F]
        out = self.spk_fuse(out.transpose(2, 3), embed).transpose(2, 3)

        skips = [out]
        for i in range(4):
            out = getattr(self, f"enc{i + 1}_conv")(out)
            out = getattr(self, f"enc{i + 1}_dense")(out)
            skips.append(out)
        for j in range(3):
            out = getattr(self, f"enc{5 + j}")(out)
            skips.append(out)

        b, t, f, c = out.shape
        y = out.reshape(b, t * f, c)
        for layer in range(self.tcn_layers):
            for blk in range(self.tcn_blocks):
                y = getattr(self, f"tcn_{layer}_{blk}")(y)
        out = y.reshape(b, t, f, c)

        skips = skips[::-1]
        for j in range(3):
            out = getattr(self, f"dec{j}")(torch.cat([skips[j], out], dim=-1))
        for i in range(4):
            out = getattr(self, f"dec{3 + i}_dense")(
                torch.cat([skips[3 + i], out], dim=-1))
            out = getattr(self, f"dec{3 + i}_conv")(out)
        out = self.dec7(torch.cat([skips[7], out], dim=-1))

        # pyramid pooling: VALID average pools, 1x1 projection, bilinear
        # upsampling with half-pixel centres (jax.image.resize's)
        t, f = out.shape[1:3]
        pools = [out]
        nchw = out.permute(0, 3, 1, 2)
        for pi, sz in enumerate(self.pool_size):
            p = F.avg_pool2d(nchw, sz, sz).permute(0, 2, 3, 1)
            p = getattr(self, f"avg_pool_{pi}")(p).permute(0, 3, 1, 2)
            p = F.interpolate(p, size=(t, f), mode="bilinear",
                              align_corners=False)
            pools.append(p.permute(0, 2, 3, 1))
        out = self.avg_proj(torch.cat(pools, dim=-1))

        pt, pf = self.paddings
        y = self.deconv2d(out)[:, pt:pt + t, pf:pf + f]
        s = istft(y[..., 0], y[..., 1], self.win, self.stride,
                  window=self.window, length=mix.shape[1])
        return s, spk_logits
