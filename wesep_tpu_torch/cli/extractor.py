"""Target speaker extraction from a mixture: the Python API and the
command line.

Counterpart of wesep_tpu/cli/extractor.py for a local model dir
(config.yaml + avg_model.ckpt, the port's torch bundle or the JAX
package's msgpack one; a dir with only the reference's avg_model.pt is
converted first, cli/hub.py). The forward runs on the card unless the
caller passes device "cpu". The steps, as in the JAX package: optional
energy-VAD trimming of the enrollment (data/vad.py), resampling to the
model's rate, the enrollment's Kaldi fbank and CMVN when the model takes
speaker features, the forward, peak normalisation to 0.9.

Decoding keeps the JAX package's shape policy, so that both give the same
output: a mixture of up to `chunk_sec` (30 s) is zero-padded to a multiple
of `length_bucket` (16000 samples) and decoded at once; a longer one is
decoded in windows of chunk_sec, the last anchored at the end, cross-faded
over `chunk_overlap_sec` (2 s) with positive trapezoid weights and
normalised by their sum. The padding changes the output (a BiLSTM's
backward direction starts in it), so it is part of the policy.

A bundle that lacks whole subtrees of the model (a converted checkpoint
whose speaker branch is not of a wespeaker layout) is loaded over the
seeded fresh model, with a warning; a bundle whose wespeaker-layout ECAPA
branch the config does not say is run with `spk_args: {layout:
wespeaker}`.

    python -m wesep_tpu_torch.cli.extractor mixture.wav enrollment.wav \
        -p MODEL_DIR -o out.wav
"""

import os

import numpy as np
import yaml

__all__ = ["Extractor", "load_model", "load_model_local", "main"]


def _tops(names):
    return {n.split(".", 1)[0] for n in names}


class Extractor:
    def __init__(self, model_dir: str, device=None):
        import torch

        from wesep_tpu_torch.device import resolve_device
        from wesep_tpu_torch.models import get_model
        from wesep_tpu_torch.train.checkpoint import (
            load_checkpoint,
            model_state,
        )
        from wesep_tpu_torch.utils.config import set_seed

        set_seed()
        self.device = resolve_device(device)
        with open(os.path.join(model_dir, "config.yaml")) as fin:
            configs = yaml.safe_load(fin)
        model_args = dict(configs["model_args"]["tse_model"])
        model_args.pop("spk_model_init", None)
        loaded = model_state(load_checkpoint(
            os.path.join(model_dir, "avg_model.ckpt")))
        # a converted joint checkpoint may carry a wespeaker-layout ECAPA
        # branch (per-split Res2 BatchNorms) that its config predates
        if any(f"{scope}.layer2.res2.bns_0." in name for name in loaded
               for scope in ("spk_model_net", "spk_model")):
            model_args["spk_args"] = dict(model_args.get("spk_args") or {},
                                          layout="wespeaker")
        self.model = get_model(configs["model"]["tse_model"])(**model_args)
        missing = _tops(self.model.state_dict()) - _tops(loaded)
        if missing:
            # the reference's load_pretrained_model(strict=False): the
            # subtrees the bundle lacks keep the seeded initial values
            print("WARNING: checkpoint missing param subtrees "
                  f"{sorted(missing)}; initializing them randomly (quality "
                  "degraded until those weights are trained or converted)")
        result = self.model.load_state_dict(loaded, strict=False)
        stray = [n for n in result.missing_keys
                 if n.split(".", 1)[0] not in missing]
        if stray or result.unexpected_keys:
            raise KeyError(f"bundle does not fit the model: missing {stray}, "
                           f"unexpected {result.unexpected_keys}")
        self.model.to(self.device).eval()
        self._torch = torch

        self.resample_rate = configs["dataset_args"].get("resample_rate",
                                                         16000)
        self.apply_vad = False
        self.wavform_norm = True
        self.output_norm = True
        self.length_bucket = 16000
        self.chunk_sec = 30.0
        self.chunk_overlap_sec = 2.0
        self.speaker_feat = model_args.get("spk_feat", False)
        self.joint_training = model_args.get("joint_training", False)

    def _forward(self, mix: np.ndarray, cue: np.ndarray) -> np.ndarray:
        """One forward of [1, T] against the cue on the device -> est [T]
        (the short-window estimate of a multi-scale model)."""
        torch = self._torch
        with torch.inference_mode():
            est = self.model(torch.from_numpy(mix).to(self.device),
                             torch.from_numpy(cue).to(self.device))[0]
        if isinstance(est, (list, tuple)):
            est = est[0]
        return est[0].float().cpu().numpy()

    def set_wavform_norm(self, wavform_norm: bool):
        self.wavform_norm = wavform_norm

    def set_resample_rate(self, resample_rate: int):
        self.resample_rate = resample_rate

    def set_vad(self, apply_vad: bool):
        self.apply_vad = apply_vad

    def set_output_norm(self, output_norm: bool):
        self.output_norm = output_norm

    def set_chunk_decode(self, chunk_sec: float, overlap_sec: float = 2.0):
        self.chunk_sec = float(chunk_sec)
        self.chunk_overlap_sec = float(overlap_sec)

    def _decode(self, mix: np.ndarray, cue: np.ndarray) -> np.ndarray:
        """The length-bucket or cross-faded window policy (see above)."""
        sr = self.resample_rate
        t = mix.shape[-1]
        win = int(self.chunk_sec * sr)
        cue = np.ascontiguousarray(cue, np.float32)
        if t <= win:
            bucket = int(self.length_bucket)
            pad_len = max((t + bucket - 1) // bucket * bucket, bucket)
            mix_p = np.zeros((1, pad_len), np.float32)
            mix_p[0, :t] = mix
            return self._forward(mix_p, cue)[:t]

        hop = max(win - int(self.chunk_overlap_sec * sr), 1)
        ov = win - hop
        window = np.ones(win, np.float32)
        if ov > 0:
            ramp = np.arange(1, ov + 1, dtype=np.float32) / (ov + 1)
            window[:ov] = ramp
            window[win - ov:] = ramp[::-1]
        out = np.zeros(t, np.float32)
        wsum = np.zeros(t, np.float32)
        starts = list(range(0, max(t - win, 0), hop)) + [t - win]
        for s in starts:
            est = self._forward(
                np.ascontiguousarray(mix[None, s:s + win], np.float32), cue)
            out[s:s + win] += est * window
            wsum[s:s + win] += window
        return out / np.maximum(wsum, 1e-12)

    def compute_fbank(self, wav: np.ndarray, sample_rate: int = 16000):
        """Kaldi fbank (int16 scale, no dither) and CMVN of a wav, computed
        on the device -> [T', 80] numpy."""
        from wesep_tpu_torch.ops.fbank import apply_cmvn, kaldi_fbank

        torch = self._torch
        wav = torch.from_numpy(np.asarray(wav, np.float32)).to(self.device)
        feats = kaldi_fbank(wav, sample_rate=sample_rate, input_scale=32768.0)
        return apply_cmvn(feats).cpu().numpy()

    def extract_speech(self, audio_path: str, audio_path_2: str):
        from wesep_tpu_torch.data.wav_io import read_wav

        pcm_mix, sr_mix = read_wav(audio_path)
        pcm_enroll, sr_enroll = read_wav(audio_path_2)
        return self.extract_speech_from_pcm(pcm_mix, sr_mix, pcm_enroll,
                                            sr_enroll)

    def extract_speech_from_pcm(self, pcm_mix, sr_mix, pcm_enroll,
                                sr_enroll):
        """pcm_mix [1, T] at sr_mix, pcm_enroll [1, T'] at sr_enroll ->
        (the target's estimate [T], the model's sample rate)."""
        from wesep_tpu_torch.data.processor import _resample_wav
        from wesep_tpu_torch.data.vad import trim_silence

        mix = np.asarray(pcm_mix)[0]
        enroll = np.asarray(pcm_enroll)[0]
        if self.apply_vad:
            enroll = trim_silence(enroll, sr_enroll)
        if sr_mix != self.resample_rate:
            mix = _resample_wav(mix[None], sr_mix, self.resample_rate)[0]
        if sr_enroll != self.resample_rate:
            enroll = _resample_wav(enroll[None], sr_enroll,
                                   self.resample_rate)[0]
        if self.joint_training and self.speaker_feat:
            cue = self.compute_fbank(enroll, self.resample_rate)[None]
        elif self.joint_training:
            cue = enroll[None]
        else:
            raise ValueError(
                "pre-extracted-embedding models need an embedding input; "
                "use a joint-training model with the CLI")
        est = self._decode(mix, np.asarray(cue))
        if self.output_norm:
            est = est / np.max(np.abs(est)) * 0.9
        return est, self.resample_rate


def load_model(language: str) -> Extractor:
    """The released model of `language`: raises, as this port downloads
    nothing (cli/hub.py)."""
    from wesep_tpu_torch.cli.hub import Hub

    return Extractor(Hub.get_model(language))


def load_model_local(model_dir: str, device=None) -> Extractor:
    """The extractor of a local model dir (an unpacked release with only
    avg_model.pt is converted first)."""
    from wesep_tpu_torch.cli.hub import Hub

    if not os.path.exists(os.path.join(model_dir, "avg_model.ckpt")):
        Hub._normalize_model_dir(model_dir)
    return Extractor(model_dir, device=device)


def main(argv=None):
    from wesep_tpu_torch.cli.hub import Hub
    from wesep_tpu_torch.cli.utils import get_args
    from wesep_tpu_torch.data.wav_io import write_wav

    args = get_args(argv)
    if args.pretrain == "":
        model_dir = Hub.get_model(args.language)
    else:
        model_dir = args.pretrain
    extractor = load_model_local(model_dir, device=args.device)
    extractor.set_vad(args.vad)
    extractor.set_output_norm(args.output_norm)
    if args.resample_rate:
        extractor.set_resample_rate(args.resample_rate)
    est, sr = extractor.extract_speech(args.audio_file, args.audio_file2)
    write_wav(args.output_file, est, sr)
    print(f"wrote {args.output_file}")


if __name__ == "__main__":
    main()
