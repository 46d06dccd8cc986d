"""Speaker encoders of the joint models (counterpart of
wesep_tpu/models/speaker).

Registry names are the recipes' `spk_model` strings. A model maps fbank
features [B, T, F_mel] to an embedding [B, embed_dim] (or a tuple whose
last element is the embedding: the two-embedding-layer ResNets) and has
an `embed_dim` attribute: the ResNets, ECAPA-TDNN in its two layouts
(which also give frame-level features [B, T, `frame_dim`] with
`return_frame_feats=True`) and CAM++.

`speaker_encoder`, `speaker_frontend` and `embed_enrollment` are the joint
models' enrollment branch (the JAX models' `_spk_embedding`).
"""

import torch

from wesep_tpu_torch.ops.fbank import speaker_feat

__all__ = ["get_speaker_model", "speaker_encoder", "speaker_frontend",
           "embed_enrollment"]


def get_speaker_model(model_name: str):
    """The constructor of `model_name` (keyword arguments: `feat_dim` and
    the recipe's `spk_args`)."""
    if model_name is None:
        raise ValueError(
            "joint_training=True requires spk_model (e.g. 'ResNet34', "
            "'ECAPA_TDNN_GLOB_c512', 'CAMPPlus')")
    if model_name.startswith("ResNet"):
        from wesep_tpu_torch.models.speaker import resnet

        if model_name in resnet.__all__ and model_name != "ResNet":
            return getattr(resnet, model_name)
    if model_name.startswith("ECAPA_TDNN"):
        from wesep_tpu_torch.models.speaker.ecapa import make_ecapa

        return make_ecapa(model_name)
    if model_name.startswith("CAMPPlus"):
        from wesep_tpu_torch.models.speaker.campplus import CAMPPlus

        return CAMPPlus
    raise NotImplementedError(f"unknown speaker model {model_name!r}")


def speaker_encoder(spk_model: str, spk_args=None) -> torch.nn.Module:
    """A joint model's encoder from its config: `spk_args` with `feat_dim`
    as the width of the fbank it takes (default 80)."""
    args = dict(spk_args or {})
    return get_speaker_model(spk_model)(feat_dim=args.pop("feat_dim", 80),
                                        **args)


def speaker_frontend(spk_args, spk_feat: bool, feat_type: str, sr: int,
                     n_fft: int, hop: int):
    """The `speaker_feat` arguments of the "consistent" frontend, which a
    joint model runs on an enrollment waveform (`spk_feat` false), or None
    when the cue is fbank already."""
    if spk_feat or feat_type != "consistent":
        return None
    return dict(sample_rate=sr, n_fft=n_fft, hop_length=hop,
                n_mels=(spk_args or {}).get("feat_dim", 80))


def embed_enrollment(enroll, encoder, pred_linear=None, frontend=None):
    """enroll (fbank, or a waveform through `frontend` with no gradient)
    -> (embedding: the last of a tuple, speaker logits or None)."""
    if frontend is not None:
        with torch.no_grad():
            enroll = speaker_feat(enroll, **frontend)
    embed = encoder(enroll)
    if isinstance(embed, (tuple, list)):
        embed = embed[-1]
    return embed, None if pred_linear is None else pred_linear(embed)
