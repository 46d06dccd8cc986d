"""TF-GridNet target-speaker extraction in PyTorch, channels-last.

Counterpart of wesep_tpu/models/tfgridnet.py: the v1 path (pre-extracted
speaker embeddings, joint_training=False) and the joint v2 path, whose
speaker encoder `spk_model` embeds the enrollment (models/speaker; the
"consistent" frontend on the model's own n_fft and stride) and promotes
the blocks after the speaker fuse to f32 under a bf16 stream, as in the
JAX package. Feature maps are [B, T, Q, C]; each GridNetBlock runs

  * an intra-frame branch over frequency (frames folded into the batch) and
    an inter-frame branch over time (frequencies folded into the batch):
    LayerNorm -> unfold(emb_ks, emb_hs) + BiLSTM -> transposed conv ->
    residual. The unfold + BiLSTM is `models.common.LSTM(unfold_ks=...)`,
    which follows the JAX package's switch WESEP_LSTM_UNFOLD: =1 takes the
    unfold-fused layer (K3 forward, K3b backward, the frames never
    materialised), otherwise the unfold in torch ops and the plain fused
    layer (K0, K0b): 12 launches of one or the other per 6-block forward;
  * full-band frame-level self-attention (per-head PReLU + layer norm over
    (E, Q), f32 logits and softmax, products in torch.matmul as the JAX
    package leaves them to XLA), then a 1x1 projection, PReLU and layer norm
    over (C, Q).

forward(mix [B, T], cue) -> (est [B, T] or [B, n_srcs, T], speaker logits
or None); the cue is an embedding [B, E], or for joint training fbank
[B, T', F_mel] or an enrollment waveform. Parameter names and shapes
follow the JAX param tree of the unrolled model (`block_{i}`);
utils/jax_params.py unstacks a `scan_layers` tree.
"""

import math

import torch
from torch import nn

from wesep_tpu_torch.models.common import (
    LSTM,
    Conv2d,
    ConvTranspose,
    Dense,
    LayerNorm,
    SpeakerFuse,
    SpeakerTransform,
)
from wesep_tpu_torch.models.speaker import (
    embed_enrollment,
    speaker_encoder,
    speaker_frontend,
)
from wesep_tpu_torch.ops.stft import hamming_window, hann_window, istft, stft

__all__ = ["TFGridNet", "GridNetBlock"]

# config keys of the JAX model that only the train binary or JAX's
# compilation and sharding read (`remat` recomputes blocks in the backward,
# `shard_model_axis` places the folded batch on a mesh: the function is the
# same); accepted and ignored so a JAX config builds this model.
# `scan_layers` is an argument: the JAX scan body fuses the embedding as an
# affine map, which this model reproduces
_JAX_ONLY_ARGS = frozenset({
    "n_imics", "activation", "spk_model_init", "spk_model_freeze", "remat",
    "shard_model_axis",
})


def _prelu(x32, alpha):
    return torch.where(x32 >= 0, x32, alpha * x32)


def _norm_stats(x32, dims, eps):
    """Single-pass mean and std over `dims` (E[x^2] - E[x]^2, clamped at 0),
    as the JAX package computes them."""
    mean = x32.mean(dim=dims, keepdim=True)
    m2 = x32.square().mean(dim=dims, keepdim=True)
    return mean, torch.sqrt((m2 - mean.square()).clamp_min(0.0) + eps)


class GridNetBlock(nn.Module):
    """Intra-frame BiLSTM + inter-frame BiLSTM + full-band self-attention
    on x [B, T, Q, C]."""

    def __init__(self, emb_dim: int, emb_ks: int, emb_hs: int, n_freqs: int,
                 hidden: int, n_head: int = 4, approx_qk_dim: int = 512,
                 eps: float = 1e-5):
        super().__init__()
        self.emb_ks, self.emb_hs, self.eps = emb_ks, emb_hs, eps
        self.n_head = n_head
        self.e_dim = math.ceil(approx_qk_dim / n_freqs)
        self.v_dim = emb_dim // n_head
        for name in ("intra", "inter"):
            self.add_module(f"{name}_norm", LayerNorm(emb_dim, eps))
            if emb_ks == emb_hs:
                rnn = LSTM(emb_ks * emb_dim, hidden)
                linear = Dense(2 * hidden, emb_ks * emb_dim)
            else:
                rnn = LSTM(emb_dim, hidden, unfold_ks=emb_ks,
                           unfold_hs=emb_hs)
                linear = ConvTranspose(2 * hidden, emb_dim, (emb_ks,),
                                       (emb_hs,))
            self.add_module(f"{name}_rnn", rnn)
            self.add_module(f"{name}_linear", linear)
        for tag, per_head in (("Q", self.e_dim), ("K", self.e_dim),
                              ("V", self.v_dim)):
            self.add_module(f"attn_conv_{tag}",
                            Dense(emb_dim, n_head * per_head))
            self.register_parameter(f"attn_norm_{tag}_prelu",
                                    nn.Parameter(torch.full((n_head,), 0.25)))
            self.register_parameter(f"attn_norm_{tag}_scale", nn.Parameter(
                torch.ones(n_head, per_head, n_freqs)))
            self.register_parameter(f"attn_norm_{tag}_bias", nn.Parameter(
                torch.zeros(n_head, per_head, n_freqs)))
        self.attn_proj = Dense(n_head * self.v_dim, emb_dim)
        self.attn_proj_prelu = nn.Parameter(torch.full((1,), 0.25))
        self.attn_proj_norm_scale = nn.Parameter(torch.ones(emb_dim, n_freqs))
        self.attn_proj_norm_bias = nn.Parameter(torch.zeros(emb_dim, n_freqs))

    def _rnn_branch(self, x, name):
        """LayerNorm -> unfold + BiLSTM -> transposed conv -> residual over
        the middle axis of [B', L, C]."""
        y = getattr(self, f"{name}_norm")(x)
        rnn, linear = getattr(self, f"{name}_rnn"), getattr(self,
                                                            f"{name}_linear")
        if self.emb_ks == self.emb_hs:
            bsz, length, c = y.shape
            y = rnn(y.reshape(bsz, length // self.emb_ks, self.emb_ks * c))
            y = linear(y).reshape(bsz, length, c)
        else:
            y = linear(rnn(y))
        return y + x

    def _qkv(self, z, tag, per_head):
        """1x1 conv, per-head PReLU and layer norm over (E, Q) per (B, H, T)
        -> [B, H, E, T, Q] in z's dtype."""
        b, t, q, _ = z.shape
        y = getattr(self, f"attn_conv_{tag}")(z)
        y = y.reshape(b, t, q, self.n_head, per_head).permute(0, 3, 4, 1, 2)
        alpha = getattr(self, f"attn_norm_{tag}_prelu")[None, :, None, None,
                                                        None]
        y32 = _prelu(y.float(), alpha)
        mean, std = _norm_stats(y32, (2, 4), self.eps)
        gamma = getattr(self, f"attn_norm_{tag}_scale")[None, :, :, None, :]
        beta = getattr(self, f"attn_norm_{tag}_bias")[None, :, :, None, :]
        return ((y32 - mean) / std * gamma + beta).to(z.dtype)

    def forward(self, x):
        b, old_t, old_q, c = x.shape
        ks, hs = self.emb_ks, self.emb_hs
        olp = ks - hs
        t_pad = math.ceil((old_t + 2 * olp - ks) / hs) * hs + ks
        q_pad = math.ceil((old_q + 2 * olp - ks) / hs) * hs + ks
        x = nn.functional.pad(x, (0, 0, olp, q_pad - old_q - olp,
                                  olp, t_pad - old_t - olp))

        y = self._rnn_branch(x.reshape(b * t_pad, q_pad, c), "intra")
        y = y.reshape(b, t_pad, q_pad, c)
        z = y.transpose(1, 2).reshape(b * q_pad, t_pad, c)
        z = self._rnn_branch(z, "inter")
        z = z.reshape(b, q_pad, t_pad, c).transpose(1, 2)
        z = z[:, olp:olp + old_t, olp:olp + old_q]

        heads, v_dim = self.n_head, self.v_dim

        def flat(t5, d):  # [B, H, E, T, Q] -> [B * H, T, E * Q]
            return t5.transpose(2, 3).reshape(b * heads, old_t, d * old_q)

        q2 = flat(self._qkv(z, "Q", self.e_dim), self.e_dim)
        k2 = flat(self._qkv(z, "K", self.e_dim), self.e_dim)
        v2 = flat(self._qkv(z, "V", v_dim), v_dim)
        # bf16 x bf16 products are exact in f32: f32 products of the rounded
        # operands are the JAX package's f32-accumulated logits
        logits = torch.matmul(q2.float(), k2.float().transpose(1, 2)) \
            * (1.0 / math.sqrt(q2.shape[-1]))
        attn = torch.softmax(logits, dim=-1).to(v2.dtype)
        out = torch.matmul(attn.float(), v2.float()).to(v2.dtype)
        out = out.reshape(b, heads, old_t, v_dim, old_q).permute(0, 2, 4, 1, 3)
        out = self.attn_proj(out.reshape(b, old_t, old_q, heads * v_dim))

        o32 = _prelu(out.float(), self.attn_proj_prelu)
        mean, std = _norm_stats(o32, (2, 3), self.eps)
        out = (o32 - mean) / std * self.attn_proj_norm_scale.t() \
            + self.attn_proj_norm_bias.t()
        return out.to(z.dtype) + z


class TFGridNet(nn.Module):
    """TF-GridNet TSE model: pre-extracted embeddings (v1 recipe) or a
    jointly trained speaker encoder (v2)."""

    def __init__(
        self,
        n_srcs: int = 1,
        sr: int = 16000,
        n_fft: int = 128,
        stride: int = 64,
        window: str = "hann",
        n_layers: int = 6,
        lstm_hidden_units: int = 192,
        attn_n_head: int = 4,
        attn_approx_qk_dim: int = 512,
        emb_dim: int = 48,
        emb_ks: int = 4,
        emb_hs: int = 1,
        eps: float = 1e-5,
        spk_emb_dim: int = 256,
        use_spk_transform: bool = False,
        spk_fuse_type: str = "multiply",
        joint_training: bool = True,
        multi_task: bool = False,
        spksInTrain: int = 251,
        spk_model=None,
        spk_args=None,
        spk_feat: bool = False,
        feat_type: str = "consistent",
        scan_layers: bool = False,
        **jax_only,
    ):
        super().__init__()
        unknown = set(jax_only) - _JAX_ONLY_ARGS
        if unknown:
            raise TypeError(f"TFGridNet got unknown arguments {sorted(unknown)}")
        self.joint_training = joint_training
        cue_dim = spk_emb_dim
        if joint_training:
            self.spk_model = speaker_encoder(spk_model, spk_args)
            cue_dim = self.spk_model.embed_dim
            self.spk_frontend = speaker_frontend(spk_args, spk_feat,
                                                 feat_type, sr, n_fft, stride)
            self.pred_linear = Dense(cue_dim, spksInTrain) if multi_task \
                else None
        if scan_layers and spk_fuse_type == "concat":
            raise NotImplementedError(
                "scan_layers supports elementwise fuse types "
                "(multiply/additive/FiLM/None); 'concat' mixes channels — "
                "use the unrolled path")
        self.n_srcs, self.n_fft, self.stride = n_srcs, n_fft, stride
        self.n_layers, self.eps = n_layers, eps
        self.scan_layers = scan_layers
        self.use_spk_transform = use_spk_transform
        n_freqs = n_fft // 2 + 1
        make_window = hann_window if window == "hann" else hamming_window
        self.register_buffer("window", make_window(n_fft), persistent=False)
        self.conv = Conv2d(2, emb_dim)
        self.conv_norm_scale = nn.Parameter(torch.ones(emb_dim))
        self.conv_norm_bias = nn.Parameter(torch.zeros(emb_dim))
        if use_spk_transform:
            self.spk_transform = SpeakerTransform(spk_emb_dim, in_dim=cue_dim)
        self.spk_fuse = SpeakerFuse(
            n_freqs, spk_emb_dim if use_spk_transform else cue_dim,
            spk_fuse_type)
        for i in range(n_layers):
            self.add_module(f"block_{i}", GridNetBlock(
                emb_dim, emb_ks, emb_hs, n_freqs, lstm_hidden_units,
                attn_n_head, attn_approx_qk_dim, eps))
        self.deconv = ConvTranspose(emb_dim, 2 * n_srcs, (3, 3), (1, 1))

    def forward(self, mix, cue):
        b, nsample = mix.shape
        # RMS normalisation with the Bessel-corrected std (torch.std)
        mix_std = mix.float().std(dim=1, keepdim=True).to(mix.dtype)
        re, im = stft(mix / mix_std, self.n_fft, self.stride,
                      window=self.window)
        t_frames, n_freqs = re.shape[1:]
        y = self.conv(torch.stack([re, im], dim=-1))
        # GroupNorm(1, C): over (T, F, C) per sample, per-channel affine
        y32 = y.float()
        mean = y32.mean(dim=(1, 2, 3), keepdim=True)
        var = (y32.square().mean(dim=(1, 2, 3), keepdim=True)
               - mean.square()).clamp_min(0.0)
        y = ((y32 - mean) * torch.rsqrt(var + self.eps)
             * self.conv_norm_scale + self.conv_norm_bias).to(y.dtype)

        embed, spk_logits = cue, None
        if self.joint_training:
            embed, spk_logits = embed_enrollment(
                cue, self.spk_model, self.pred_linear, self.spk_frontend)
        if self.use_spk_transform:
            embed = self.spk_transform(embed)
        if self.scan_layers:
            # the JAX scan body applies every elementwise fuse as the affine
            # map y * scale + shift, probed once with 0 and 1
            probe = y.new_zeros(b, 1, 1, n_freqs)
            shift = self.spk_fuse(probe, embed)
            scale = self.spk_fuse(probe + 1, embed) - shift
        for i in range(self.n_layers):
            # the fuse acts on the frequency axis: [B, T, C, Q]
            yp = y.transpose(2, 3)
            yp = yp * scale + shift if self.scan_layers \
                else self.spk_fuse(yp, embed)
            y = getattr(self, f"block_{i}")(yp.transpose(2, 3))

        y = self.deconv(y)[:, 1:1 + t_frames, 1:1 + n_freqs]
        y = y.reshape(b, t_frames, n_freqs, self.n_srcs, 2)
        est_re = y[..., 0].permute(0, 3, 1, 2).reshape(
            b * self.n_srcs, t_frames, n_freqs)
        est_im = y[..., 1].permute(0, 3, 1, 2).reshape(
            b * self.n_srcs, t_frames, n_freqs)
        s = istft(est_re, est_im, self.n_fft, self.stride, window=self.window,
                  length=nsample)
        s = s.reshape(b, self.n_srcs, nsample) * mix_std[:, None]
        if self.n_srcs == 1:
            s = s[:, 0]
        return s, spk_logits
