"""BSRNN_Feats: BSRNN with frame-level enrollment cues.

Counterpart of wesep_tpu/models/bsrnn_feats.py. Two mechanisms, which
combine:

  * `spectral_feat`: a TF map appended to every band as a third channel
    block. "tfmap_spec" scores each mixture frame against the enrollment's
    frames by cosine similarity of their magnitudes, "tfmap_emb" by cosine
    similarity of the speaker encoder's frame-level features on the two
    waveforms' fbank (reflect-padded by win // 2, frames of win / stride
    samples, dither 0, int16 scale, CMVN; no gradient into the fbank). The
    softmax weights average the enrollment's magnitudes, and the map is
    rescaled to the mixture's energy per frame.
  * `spk_fuse_type` "cross_<multiply|additive|concat>": the enrollment's
    frame-level features (the encoder's, or a [B, S, D] cue without joint
    training), projected to `feature_dim` by `cross_proj`, are attended by
    every band's frames (`cross_att`, 2 heads) and fused by `cross_fuse_*`
    before the separator; with `multi_fuse` before every repeat, attended
    again from each repeat's output. Such a model builds no embedding fuse,
    speaker transform or encoder head (the JAX tree has none).

In train mode "tfmap_emb" runs the encoder twice a forward, on the mixture
and then on the enrollment, so its BatchNorm statistics move twice, and
the cross path reuses the enrollment's features. The encoder is f32 and
its features promote what they meet: under a bf16 stream the TF map and
the band features stay bf16, and everything after the cross fuse runs in
f32, as in the JAX package (so the separator's BiLSTMs take the f32
kernels). The attention's scores, softmax and weighted sums are f32 torch
ops (plain XLA in the JAX package).

forward(mix [B, T], cue) -> (est [B, T], speaker logits or None).
"""

import math

import torch
from torch import nn
from torch.nn import functional as F

from wesep_tpu_torch.models.bsrnn import BSRNN
from wesep_tpu_torch.models.common import Dense, SpeakerFuse
from wesep_tpu_torch.ops.fbank import apply_cmvn, kaldi_fbank, speaker_feat
from wesep_tpu_torch.ops.stft import stft

__all__ = ["BSRNN_Feats", "CrossAtt", "tfmap"]

_SPECTRAL = (None, "tfmap_spec", "tfmap_emb")


class CrossAtt(nn.Module):
    """Multi-head cross-attention (torch nn.MultiheadAttention's function
    with separate `q_proj`, `k_proj`, `v_proj`, `out_proj`): query
    [B, ..., T, D], key and value [B, S, D] (shared by the query's middle
    axes) -> [B, ..., T, D]."""

    def __init__(self, embed_dim: int, num_heads: int = 2):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"{embed_dim} does not split into {num_heads} "
                             "heads")
        self.num_heads = num_heads
        self.q_proj = Dense(embed_dim, embed_dim)
        self.k_proj = Dense(embed_dim, embed_dim)
        self.v_proj = Dense(embed_dim, embed_dim)
        self.out_proj = Dense(embed_dim, embed_dim)

    def forward(self, q, k, v):
        h = self.num_heads

        def heads(x):  # [..., T, D] -> [..., H, T, dh]
            return x.unflatten(-1, (h, -1)).transpose(-3, -2)

        qh, kh, vh = heads(self.q_proj(q)), heads(self.k_proj(k)), \
            heads(self.v_proj(v))
        for _ in range(q.dim() - k.dim()):  # share k, v over q's middle axes
            kh, vh = kh.unsqueeze(1), vh.unsqueeze(1)
        scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        scores = scores / math.sqrt(qh.shape[-1])
        attn = torch.softmax(scores, dim=-1).to(vh.dtype)
        y = torch.matmul(attn.float(), vh.float()).to(vh.dtype)
        return self.out_proj(y.transpose(-3, -2).flatten(-2))


def _unit(x, eps: float = 1e-12):
    return x / torch.linalg.vector_norm(x, dim=-1,
                                        keepdim=True).clamp_min(eps)


def tfmap(mix_mag, enroll_mag, scores_q=None, scores_k=None):
    """The attention TF map [B, T, F] from magnitudes [B, T, F] / [B, S, F]:
    scored by the normalised magnitudes, or by frame features scores_q
    [B, T, D] / scores_k [B, S, D] when given; the weights (softmax over S,
    f32) average the enrollment's normalised magnitudes (or, with frame
    features, its magnitudes), and the unit map is scaled by its projection
    on the mixture's frame. Computed in mix_mag's dtype, the products
    summed in f32."""
    dtype = mix_mag.dtype
    if scores_q is None:
        q, k = _unit(mix_mag), _unit(enroll_mag)
        value = k
    else:
        q, k = _unit(scores_q), _unit(scores_k)
        value = enroll_mag
    att = torch.matmul(q.float(), k.float().transpose(1, 2))
    w = torch.softmax(att, dim=-1).to(dtype)
    out = _unit(torch.matmul(w.float(), value.float()).to(dtype))
    return (mix_mag * out).sum(dim=-1, keepdim=True) * out


class BSRNN_Feats(BSRNN):
    """BSRNN's arguments, and `spectral_feat` (None / False, "tfmap_spec",
    "tfmap_emb") and `spk_emb_frame_dim` (the width of a frame-level cue
    without joint training)."""

    def __init__(self, spectral_feat=None, spk_emb_frame_dim: int = 512,
                 **kwargs):
        spectral_feat = spectral_feat or None
        if spectral_feat not in _SPECTRAL:
            raise ValueError(f"unknown spectral_feat {spectral_feat!r}")
        fuse = kwargs.get("spk_fuse_type", "concat")
        # read by the hooks that BSRNN.__init__ calls
        self.spectral_feat = spectral_feat
        self.cross = bool(fuse) and fuse.startswith("cross_")
        super().__init__(**kwargs)
        joint = self.joint_training
        if spectral_feat == "tfmap_emb" and not joint:
            raise ValueError("spectral_feat='tfmap_emb' needs the joint "
                             "speaker encoder (joint_training=True)")
        encoder = self.spk_model_net if joint else None
        if (spectral_feat == "tfmap_emb" or self.cross and joint) \
                and not hasattr(encoder, "frame_dim"):
            raise ValueError(f"speaker model {kwargs.get('spk_model')!r} "
                             "gives no frame-level features (ECAPA-TDNN "
                             "does)")
        sr = kwargs.get("sr", 16000)
        self.fbank_args = dict(
            sample_rate=sr,
            num_mel_bins=(kwargs.get("spk_args") or {}).get("feat_dim", 80),
            frame_length_ms=self.win * 1e3 / sr,
            frame_shift_ms=self.stride * 1e3 / sr, dither=0.0,
            input_scale=32768.0)
        if self.cross:
            feature_dim = kwargs.get("feature_dim", 128)
            frame_dim = encoder.frame_dim if joint else spk_emb_frame_dim
            self.cross_proj = Dense(frame_dim, feature_dim)
            self.cross_att = CrossAtt(feature_dim, 2)
            base = fuse[len("cross_"):]
            for j in range(self.num_repeat if self.multi_fuse else 1):
                self.add_module(f"cross_fuse_{j}", SpeakerFuse(
                    feature_dim, feature_dim, base))

    def _spec_map(self) -> int:
        return 3 if self.spectral_feat else 2

    def _uses_embedding(self) -> bool:
        return not self.cross

    def _frame_feats(self, wav):
        """The encoder's frame-level features of a waveform's fbank
        (reflect-padded by win // 2, CMVN; no gradient into the fbank)."""
        pad = self.win // 2
        with torch.no_grad():
            padded = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
            feats = apply_cmvn(kaldi_fbank(padded, **self.fbank_args))
        return self.spk_model_net(feats, return_frame_feats=True)

    def _cross_embedding(self, x, frame_feats):
        """Every band's frames [B, nband, T, N] attend over the projected
        frame features [B, S, N] -> [B, nband, T, N]."""
        spk = self.cross_proj(frame_feats)
        return self.cross_att(x, spk, spk)

    def _separate_cross(self, x, sub_specs, frame_feats, nsample):
        """Cross fuse, separator repeats (with `multi_fuse` each attended
        and fused again), masks and iSTFT -> [B, T]."""
        spk = self._cross_embedding(x, frame_feats)
        for r in range(self.num_repeat):
            if r == 0 or self.multi_fuse:
                x = getattr(self, f"cross_fuse_{r}")(x, spk)
            x = getattr(self, f"bsnet_{r}")(x)
            if self.multi_fuse and r + 1 < self.num_repeat:
                spk = self._cross_embedding(x, frame_feats)
        return self._mask_reconstruct(x, sub_specs, nsample)

    def forward(self, mix, cue):
        nsample = mix.shape[-1]
        re, im = stft(mix, self.win, self.stride, window=self.window)
        tf_map = frame_feats = None
        if self.spectral_feat:
            if cue.dim() != 2:
                raise ValueError("spectral_feat needs the raw enrollment "
                                 f"waveform [B, T], got {tuple(cue.shape)}")
            ere, eim = stft(cue, self.win, self.stride, window=self.window)
            mix_mag = torch.sqrt(re * re + im * im)
            enroll_mag = torch.sqrt(ere * ere + eim * eim)
            if self.spectral_feat == "tfmap_spec":
                tf_map = tfmap(mix_mag, enroll_mag)
            else:
                mix_frame = self._frame_feats(mix)
                frame_feats = self._frame_feats(cue)
                s_len = min(enroll_mag.shape[1], frame_feats.shape[1])
                q_len = min(mix_mag.shape[1], mix_frame.shape[1])
                tf_map = tfmap(mix_mag[:, :q_len], enroll_mag[:, :s_len],
                               mix_frame[:, :q_len], frame_feats[:, :s_len])
                tf_map = F.pad(tf_map, (0, 0, 0, re.shape[1] - q_len))
        x, sub_specs = self._band_split(re, im, extra=tf_map)
        if not self.cross:
            embed, spk_logits = self._spk_embedding(cue)
            return self._separate(x, sub_specs, embed, nsample), spk_logits
        if frame_feats is None:
            frame_feats = cue  # a frame-level cue [B, S, D]
            if self.joint_training:
                if self.spk_frontend is not None:
                    with torch.no_grad():
                        cue = speaker_feat(cue, **self.spk_frontend)
                frame_feats = self.spk_model_net(cue, return_frame_feats=True)
        return self._separate_cross(x, sub_specs, frame_feats, nsample), None
