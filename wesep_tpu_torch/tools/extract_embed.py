"""Speaker embeddings of a wav list with one of the port's speaker encoders.

Counterpart of wesep_tpu/tools/extract_embed.py: loads a speaker encoder's
bundle (the port's torch bundle or the JAX package's msgpack one, through
train/checkpoint.load_checkpoint; `--subtree` takes the encoder out of a
joint model's, e.g. spk_model_net of BSRNN or spk_model of TF-GridNet and
DPCCN), computes each wav's Kaldi fbank (int16 scale, no dither) and its
CMVN, and writes the embeddings as embed.ark / embed.scp (kaldi binary
float vectors). It runs on the card unless `--device cpu` is given.

    python -m wesep_tpu_torch.tools.extract_embed --wav_scp wav.scp \
        --checkpoint ckpt.ckpt --spk_model ResNet34 \
        --spk_args '{"embed_dim": 256, "pooling_func": "TSTP", "two_emb_layer": false}' \
        --out_base exp/embed
"""

import argparse
import json


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="extract embeddings")
    parser.add_argument("--wav_scp", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--spk_model", required=True)
    parser.add_argument("--spk_args", default="{}")
    parser.add_argument("--out_base", required=True)
    parser.add_argument("--num_mel_bins", type=int, default=80)
    parser.add_argument("--model_index", type=int, default=0)
    parser.add_argument(
        "--subtree", default=None,
        help="scope of the speaker model in a joint TSE bundle (e.g. "
             "spk_model_net)")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def encoder_state(bundle, model_index=0, subtree=None):
    """The speaker encoder's state_dict in a bundle: model `model_index`'s
    parameters and buffers, those under `subtree.` with that prefix cut."""
    from wesep_tpu_torch.train.checkpoint import model_state

    state = model_state(bundle, model_index)
    if subtree:
        prefix = subtree + "."
        state = {k[len(prefix):]: v for k, v in state.items()
                 if k.startswith(prefix)}
        if not state:
            raise ValueError(f"no parameters under {subtree!r} in the bundle")
    return state


def extract(wav_scp, checkpoint, spk_model, spk_args, out_base,
            num_mel_bins=80, model_index=0, subtree=None, device=None):
    """Embed every wav of `wav_scp` -> (ark, scp, {utt: embedding})."""
    import numpy as np
    import torch

    from wesep_tpu_torch.data.wav_io import read_wav
    from wesep_tpu_torch.device import resolve_device
    from wesep_tpu_torch.models.speaker import get_speaker_model
    from wesep_tpu_torch.ops.fbank import apply_cmvn, kaldi_fbank
    from wesep_tpu_torch.train.checkpoint import load_checkpoint
    from wesep_tpu_torch.utils.file_utils import (
        read_2columns_text,
        write_vec_ark_scp,
    )

    device = resolve_device(device)
    spk_args = dict(spk_args)
    spk_args.pop("feat_dim", None)
    model = get_speaker_model(spk_model)(feat_dim=num_mel_bins, **spk_args)
    model.load_state_dict(encoder_state(load_checkpoint(checkpoint),
                                        model_index, subtree))
    model.to(device).eval()

    embeds = {}
    with torch.inference_mode():
        for utt, path in read_2columns_text(wav_scp).items():
            wav, sr = read_wav(path)
            feats = kaldi_fbank(torch.from_numpy(wav[0]).to(device),
                                sample_rate=sr, num_mel_bins=num_mel_bins,
                                input_scale=32768.0)
            out = model(apply_cmvn(feats)[None])
            if isinstance(out, (tuple, list)):
                out = out[-1]
            embeds[utt] = out[0].float().cpu().numpy().astype(np.float32)
    ark, scp = write_vec_ark_scp(out_base, embeds)
    return ark, scp, embeds


def main(argv=None):
    args = get_args(argv)
    ark, scp, embeds = extract(
        args.wav_scp, args.checkpoint, args.spk_model,
        json.loads(args.spk_args), args.out_base, args.num_mel_bins,
        args.model_index, args.subtree, args.device)
    print(f"wrote {len(embeds)} embeddings to {ark} / {scp}")


if __name__ == "__main__":
    main()
