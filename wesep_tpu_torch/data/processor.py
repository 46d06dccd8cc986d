"""Streaming transforms of the serving and training paths, numpy-native.

The subset of wesep_tpu/data/processor.py that bin/infer and bin/train run
on premixed data: open local shards, group premixed shard members, parse
raw json lists, filter by length, shuffle, resample, cut random or leading
chunks and attach random (train) or fixed (validation, test) speaker cues:
pre-extracted embeddings or, for joint training, enrollment waveforms with
the speaker's class label; then, for the fbank recipes, Kaldi fbank of
every enrollment (ops/fbank on the host), CMVN and SpecAugment. Each
transform is a generator over sample dicts; waveforms are float32 [1, T],
fbank float32 [1, T', n_mels]. Every random draw comes from Python's
`random`, in the JAX package's order, so one seed gives both packages the
same samples; only the dither noise comes from a torch generator, which
`compute_fbank` seeds from one such draw.

Online mixing reads single-speaker shards or lists, pairs each utterance
with interferers of other speakers from a buffer (`mix_speakers`), and
then either simulates on the host, sample by sample (FRAM-RIR reverb of
each source, `snr_mixer`, additive noise from a noise store: the JAX
package's reference-semantics path), or, for the simulation on the device
(data/augment.py, inside the train step), only fetches a raw noise chunk
per mixture (`fetch_noise_chunk`). Host noise draws its SNR, offset and
channel from numpy's global generator and its key from `random`, as the
JAX package does; `add_reverb` draws each RIR from an unseeded numpy
generator, as the JAX package's does.
"""

import json
import logging
import random
import tarfile
from typing import Iterable, Iterator
from urllib.parse import urlparse

import numpy as np
import torch
from scipy import signal as sp_signal

from wesep_tpu_torch.data.wav_io import read_wav
from wesep_tpu_torch.ops.fbank import kaldi_fbank

AUDIO_FORMAT_SETS = {"flac", "mp3", "m4a", "ogg", "opus", "wav", "wma"}

# the FRAM-RIR envelope of host reverberation (rooms, RT60, distances)
simu_config = {
    "min_max_room": [[3, 3, 2.5], [10, 6, 4]],
    "rt60": [0.1, 0.7],
    "sr": 16000,
    "mic_dist": [0.2, 5.0],
    "num_src": 1,
}

__all__ = ["url_opener", "tar_file_and_group",
           "tar_file_and_group_single_spk", "parse_raw",
           "parse_raw_single_spk", "mix_speakers", "snr_mixer", "shuffle",
           "resample", "spk_to_id", "sample_spk_embedding",
           "sample_fix_spk_embedding", "sample_enrollment",
           "sample_fix_spk_enrollment", "compute_fbank", "apply_cmvn",
           "spec_aug",
           "get_random_chunk", "filter_len", "random_chunk", "fix_chunk",
           "add_noise", "fetch_noise_chunk", "add_reverb",
           "add_noise_on_enroll", "add_reverb_on_enroll"]


def url_opener(data: Iterable[dict]) -> Iterator[dict]:
    """Open local shard files into byte streams."""
    for sample in data:
        url = sample["src"]
        if urlparse(url).scheme not in ("", "file"):
            raise ValueError(f"only local shards are supported, got {url}")
        sample.update(stream=open(url, "rb"))
        yield sample


def _group_complete(example, valid, num_speakers, prefix) -> bool:
    """Yield only whole groups: one that failed to parse or has no mixture
    (stray members in the tar) is dropped with a warning."""
    if valid and "wav_mix" in example and num_speakers > 0:
        return True
    if valid:
        logging.warning("dropping incomplete shard group %s", prefix)
    return False


def tar_file_and_group(data: Iterable[dict]) -> Iterator[dict]:
    """Premixed shards: {key}.wav + {key}_spk{i}.wav + {key}.spk{i},
    grouped per key."""
    for sample in data:
        stream = tarfile.open(fileobj=sample["stream"], mode="r:*")
        prev_prefix = None
        example = {}
        num_speakers = 0
        valid = True
        for tarinfo in stream:
            name = tarinfo.name
            pos = name.rfind(".")
            if pos <= 0:
                raise ValueError(f"shard member without extension: {name}")
            prefix, postfix = name[:pos], name[pos + 1:]
            if prev_prefix is not None and prev_prefix not in prefix:
                example["key"] = prev_prefix
                if _group_complete(example, valid, num_speakers, prev_prefix):
                    example["num_speaker"] = num_speakers
                    yield example
                num_speakers = 0
                example = {}
                valid = True
            with stream.extractfile(tarinfo) as file_obj:
                try:
                    if "spk" in postfix:
                        example[postfix] = file_obj.read().decode("utf8").strip()
                        num_speakers += 1
                    elif postfix in AUDIO_FORMAT_SETS:
                        waveform, sample_rate = read_wav(file_obj.read())
                        if prefix[-5:-1] == "_spk":
                            example["wav" + prefix[-5:]] = waveform
                            prefix = prefix[:-5]
                        else:
                            example["wav_mix"] = waveform
                            example["sample_rate"] = sample_rate
                    else:
                        example[postfix] = file_obj.read()
                except (ValueError, EOFError):
                    valid = False
                    logging.warning("error to parse %s", name)
            prev_prefix = prefix
        if prev_prefix is not None:
            example["key"] = prev_prefix
            example["num_speaker"] = num_speakers
            if _group_complete(example, valid, num_speakers, prev_prefix):
                yield example
        stream.close()
        sample["stream"].close()


def parse_raw(data: Iterable[dict]) -> Iterator[dict]:
    """json lines {key, wav_mix, wav_spk1.., spk1..} of file paths."""
    for sample in data:
        obj = json.loads(sample["src"])
        try:
            example = {"key": obj["key"]}
            example["wav_mix"], example["sample_rate"] = read_wav(obj["wav_mix"])
            n = 0
            while f"wav_spk{n + 1}" in obj:
                n += 1
                example[f"wav_spk{n}"], _ = read_wav(obj[f"wav_spk{n}"])
                example[f"spk{n}"] = obj.get(f"spk{n}", "")
            example["num_speaker"] = n
            yield example
        except (OSError, ValueError, KeyError):
            logging.warning("Failed to read %s", obj.get("key"))


def _single_complete(example, valid, prefix) -> bool:
    if valid and "wav" in example and "spk" in example:
        return True
    if valid:
        logging.warning("dropping incomplete shard group %s", prefix)
    return False


def tar_file_and_group_single_spk(data: Iterable[dict]) -> Iterator[dict]:
    """Single-speaker shards: {key}.wav + {key}.spk, grouped per key into
    {key, wav, spk, sample_rate}."""
    for sample in data:
        stream = tarfile.open(fileobj=sample["stream"], mode="r|*")
        prev_prefix = None
        example = {}
        valid = True
        for tarinfo in stream:
            name = tarinfo.name
            pos = name.rfind(".")
            if pos <= 0:
                raise ValueError(f"shard member without extension: {name}")
            prefix, postfix = name[:pos], name[pos + 1:]
            if prev_prefix is not None and prefix != prev_prefix:
                example["key"] = prev_prefix
                if _single_complete(example, valid, prev_prefix):
                    yield example
                example = {}
                valid = True
            with stream.extractfile(tarinfo) as file_obj:
                try:
                    if postfix == "spk":
                        example["spk"] = file_obj.read().decode(
                            "utf8").strip()
                    elif postfix in AUDIO_FORMAT_SETS:
                        example["wav"], example["sample_rate"] = read_wav(
                            file_obj.read())
                    else:
                        example[postfix] = file_obj.read()
                except (ValueError, EOFError):
                    valid = False
                    logging.warning("error to parse %s", name)
            prev_prefix = prefix
        if prev_prefix is not None:
            example["key"] = prev_prefix
            if _single_complete(example, valid, prev_prefix):
                yield example
        stream.close()
        sample["stream"].close()


def parse_raw_single_spk(data: Iterable[dict]) -> Iterator[dict]:
    """json lines {key, wav, spk} of single-speaker files."""
    for sample in data:
        obj = json.loads(sample["src"])
        try:
            waveform, sample_rate = read_wav(obj["wav"])
            yield dict(key=obj["key"], spk=obj["spk"], wav=waveform,
                       sample_rate=sample_rate)
        except (OSError, ValueError, KeyError):
            logging.warning("Failed to read %s", obj.get("wav"))


def mix_speakers(data: Iterable[dict], num_speaker: int = 2,
                 shuffle_size: int = 1000) -> Iterator[dict]:
    """Online mixing: fill a buffer of `shuffle_size` single-speaker
    samples, shuffle it, and give each sample (the target, wav_spk1) its
    num_speaker - 1 interferers, each drawn from the buffer until its
    speaker differs from the target's. A buffer of one speaker only never
    ends, as in the JAX package. -> {key, wav_spk1.., spk1.., num_speaker,
    sample_rate}."""

    def emit(buf):
        random.shuffle(buf)
        for x in buf:
            cur_spk = x["spk"]
            example = {"key": "mix_" + x["key"], "wav_spk1": x["wav"],
                       "spk1": x["spk"], "sample_rate": x["sample_rate"]}
            key = example["key"]
            interference_idx = 1
            while interference_idx < num_speaker:
                interference = random.choice(buf)
                while interference["spk"] == cur_spk:
                    interference = random.choice(buf)
                key = key + "_" + interference["key"]
                interference_idx += 1
                example[f"wav_spk{interference_idx}"] = interference["wav"]
                example[f"spk{interference_idx}"] = interference["spk"]
            example["key"] = key
            example["num_speaker"] = num_speaker
            yield example

    buf = []
    for sample in data:
        buf.append(sample)
        if len(buf) >= shuffle_size:
            yield from emit(buf)
            buf = []
    if buf:
        yield from emit(buf)


def snr_mixer(data: Iterable[dict],
              use_random_snr: bool = False) -> Iterator[dict]:
    """Mix the sources: each interferer scaled to the target's energy times
    10^(snr / 20), snr uniform in [-10, 10] dB (`use_random_snr`) or 0;
    then the mixture and every source divided by the largest absolute
    value among them. The reverberant sources (wav_spk*_reverb) are mixed
    where present."""
    for sample in data:
        suffix = "_reverb" if "wav_spk1_reverb" in sample else ""
        num_speaker = sample["num_speaker"]
        wavs_to_mix = [sample["wav_spk1" + suffix]]
        target_energy = np.sum(wavs_to_mix[0] ** 2, axis=-1, keepdims=True)
        for i in range(1, num_speaker):
            interference = sample[f"wav_spk{i + 1}" + suffix]
            snr = random.uniform(-10, 10) if use_random_snr else 0
            energy = np.sum(interference ** 2, axis=-1, keepdims=True)
            interference = interference * np.sqrt(
                target_energy / np.maximum(energy, 1e-10)) * 10 ** (snr / 20)
            sample[f"wav_spk{i + 1}" + suffix] = interference
            wavs_to_mix.append(interference)
        stacked = np.stack(wavs_to_mix)
        mix = np.sum(stacked, 0)
        max_amp = max(float(np.abs(mix).max()),
                      *[float(np.abs(x).max()) for x in stacked])
        mix_scaling = 1.0 / max_amp if max_amp != 0 else 1.0
        sample["wav_mix"] = mix * mix_scaling
        for i in range(num_speaker):
            sample[f"wav_spk{i + 1}" + suffix] = (
                sample[f"wav_spk{i + 1}" + suffix] * mix_scaling)
        yield sample


def shuffle(data: Iterable[dict], shuffle_size: int = 2500) -> Iterator[dict]:
    """Local buffer shuffle."""
    buf = []
    for sample in data:
        buf.append(sample)
        if len(buf) >= shuffle_size:
            random.shuffle(buf)
            yield from buf
            buf = []
    random.shuffle(buf)
    yield from buf


def _resample_wav(wav: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy) along the last axis, as float32."""
    g = np.gcd(int(orig_sr), int(new_sr))
    return sp_signal.resample_poly(
        wav, new_sr // g, orig_sr // g, axis=-1).astype(np.float32)


def resample(data: Iterable[dict],
             resample_rate: int = 16000) -> Iterator[dict]:
    """Resample every wav* entry (polyphase, scipy)."""
    for sample in data:
        sample_rate = sample["sample_rate"]
        if sample_rate != resample_rate:
            sample["sample_rate"] = resample_rate
            for key in list(sample.keys()):
                if "wav" in key:
                    sample[key] = _resample_wav(sample[key], sample_rate,
                                                resample_rate)
        yield sample


def sample_spk_embedding(data: Iterable[dict],
                         spk_embeds: dict) -> Iterator[dict]:
    """Random pre-extracted embedding per target speaker, for training."""
    for sample in data:
        for key in list(sample.keys()):
            if key.startswith("spk"):
                sample["embed_" + key] = np.atleast_2d(
                    random.choice(spk_embeds[sample[key]]))
        yield sample


def sample_fix_spk_embedding(
    data: Iterable[dict], spk2embed_dict, spk1_embed, spk2_embed
) -> Iterator[dict]:
    """Deterministic pre-extracted embedding per target, for test sets."""
    for sample in data:
        for key in list(sample.keys()):
            if key.startswith("spk"):
                emap = spk1_embed if key == "spk1" else spk2_embed
                sample["embed_" + key] = np.atleast_2d(
                    spk2embed_dict[emap[sample["key"]]]
                )
        yield sample


def spk_to_id(data: Iterable[dict], spk2id: dict) -> Iterator[dict]:
    """spk string -> integer `label`, -1 if unknown."""
    for sample in data:
        sample["label"] = spk2id.get(sample["spk"], -1)
        yield sample


def _attach_enrollment(sample, key, path, dict_spk):
    enrollment, _ = read_wav(path)
    sample["embed_" + key] = enrollment[:1]  # [1, T]
    if dict_spk:
        sample[key + "_label"] = dict_spk[sample[key]]


def sample_enrollment(data: Iterable[dict], spk_embeds: dict,
                      dict_spk=None) -> Iterator[dict]:
    """Random enrollment wav per target speaker (spk_embeds: spk ->
    [(utt, wav path), ...]) and, with `dict_spk`, the speaker's label, for
    joint training."""
    for sample in data:
        for key in list(sample.keys()):
            if key.startswith("spk"):
                path = random.choice(spk_embeds[sample[key]])[1]
                _attach_enrollment(sample, key, path, dict_spk)
        yield sample


def sample_fix_spk_enrollment(data: Iterable[dict], spk2embed_dict,
                              spk1_embed, spk2_embed,
                              dict_spk=None) -> Iterator[dict]:
    """Deterministic enrollment wav per target (utt -> wav path), for
    validation and test sets."""
    for sample in data:
        for key in list(sample.keys()):
            if key.startswith("spk"):
                emap = spk1_embed if key == "spk1" else spk2_embed
                path = spk2embed_dict[emap[sample["key"]]]
                _attach_enrollment(sample, key, path, dict_spk)
        yield sample


def compute_fbank(data: Iterable[dict], num_mel_bins: int = 80,
                  frame_length: int = 25, frame_shift: int = 10,
                  dither: float = 1.0) -> Iterator[dict]:
    """Kaldi fbank of every embed_* enrollment wav -> [T', num_mel_bins],
    on the int16 scale (input_scale 32768).

    One `random.randint` when the chain starts seeds the dither's torch
    generator, where the JAX package seeds its PRNG key: later draws of
    `random` then match the JAX chain's. The noise itself differs from
    the JAX package's (another generator); at dither 0 the features
    agree."""
    seed = random.randint(0, 2**31 - 1)
    gen = torch.Generator().manual_seed(seed)
    for sample in data:
        sr = sample["sample_rate"]
        for k in list(sample.keys()):
            if k.startswith("embed"):
                wav = torch.from_numpy(np.asarray(sample[k], np.float32)[0])
                mat = kaldi_fbank(
                    wav, sample_rate=sr, num_mel_bins=num_mel_bins,
                    frame_length_ms=frame_length, frame_shift_ms=frame_shift,
                    dither=dither, generator=gen if dither > 0 else None,
                    input_scale=32768.0)
                sample[k] = mat.numpy()
        yield sample


def apply_cmvn(data: Iterable[dict], norm_mean: bool = True,
               norm_var: bool = False) -> Iterator[dict]:
    """Per-utterance CMVN of every embed_* fbank -> [1, T', F]."""
    for sample in data:
        for k in list(sample.keys()):
            if k.startswith("embed"):
                mat = sample[k]
                if norm_mean:
                    mat = mat - mat.mean(axis=0)
                if norm_var:
                    mat = mat / np.sqrt(mat.var(axis=0) + 1e-8)
                sample[k] = mat[None].astype(np.float32)
        yield sample


def spec_aug(data: Iterable[dict], num_t_mask: int = 1, num_f_mask: int = 1,
             max_t: int = 10, max_f: int = 8,
             prob: float = 0) -> Iterator[dict]:
    """With probability `prob` per sample, zero `num_t_mask` random runs of
    frames and `num_f_mask` of mel bins of every embed_* fbank [1, T, F]."""
    for sample in data:
        if random.random() < prob:
            for key in list(sample.keys()):
                if key.startswith("embed"):
                    y = np.array(sample[key])
                    max_frames, max_freq = y.shape[1], y.shape[2]
                    for _ in range(num_t_mask):
                        start = random.randint(0, max_frames - 1)
                        length = random.randint(1, max_t)
                        y[:, start:min(max_frames, start + length), :] = 0
                    for _ in range(num_f_mask):
                        start = random.randint(0, max_freq - 1)
                        length = random.randint(1, max_f)
                        y[:, :, start:min(max_freq, start + length)] = 0
                    sample[key] = y
        yield sample


def get_random_chunk(data_list, chunk_len: int):
    """One random chunk position shared by a list of [1, T] wavs; a chunk
    that is all zero is redrawn (at most 10 times); shorter inputs are
    tiled to chunk_len."""
    if any(d.shape[-1] != data_list[0].shape[-1] for d in data_list):
        raise ValueError("wavs of one sample differ in length")
    arrays = [d[0] for d in data_list]
    data_len = arrays[0].shape[0]
    if data_len >= chunk_len:
        chunk_start = random.randint(0, data_len - chunk_len)
        for i in range(len(arrays)):
            temp = arrays[i][chunk_start:chunk_start + chunk_len]
            guard = 0
            while not np.any(temp) and guard < 10:
                chunk_start = random.randint(0, data_len - chunk_len)
                temp = arrays[i][chunk_start:chunk_start + chunk_len]
                guard += 1
            arrays[i] = temp.copy()
    else:
        repeat_factor = chunk_len // data_len + 1
        for i in range(len(arrays)):
            arrays[i] = np.tile(arrays[i], repeat_factor)[:chunk_len]
    return [a[None] for a in arrays]


def filter_len(data: Iterable[dict], min_num_seconds: float = 1,
               max_num_seconds: float = 1000) -> Iterator[dict]:
    """Drop utterances that are too short, chunk those that are too long
    (single-speaker samples with a `wav` entry)."""
    for sample in data:
        sample_rate = sample["sample_rate"]
        wav = sample["wav"]
        if wav.shape[1] < min_num_seconds * sample_rate:
            continue
        max_len = int(max_num_seconds * sample_rate)
        if wav.shape[1] > max_len:
            wav = get_random_chunk([wav], max_len)[0]
        sample["wav"] = wav
        yield sample


def random_chunk(data: Iterable[dict], chunk_len: int) -> Iterator[dict]:
    """The same random chunk of every wav* entry."""
    for sample in data:
        wav_keys = [k for k in list(sample.keys()) if "wav" in k]
        chunks = get_random_chunk([sample[k] for k in wav_keys], chunk_len)
        sample.update(zip(wav_keys, chunks))
        yield sample


def fix_chunk(data: Iterable[dict], chunk_len: int) -> Iterator[dict]:
    """The leading chunk of every wav* entry."""
    for sample in data:
        for k in list(sample.keys()):
            if k.startswith("wav"):
                sample[k] = sample[k][:, :chunk_len]
        yield sample


def _fit_noise(noise_wav, noise_sr, tgt_sr, nsamples, single_channel=True):
    """Noise [C, T] at `noise_sr` -> [C', nsamples] at `tgt_sr`: wrap-padded
    at a random offset when short, a random window when long (numpy's
    global generator), one random channel with `single_channel`, then
    resampled and wrap-padded or trimmed to nsamples."""
    if noise_sr != tgt_sr:
        nsamples_ = int(nsamples / tgt_sr * noise_sr) + 1
    else:
        nsamples_ = nsamples
    noise = noise_wav.T  # [T, C]
    frames = noise.shape[0]
    if frames < nsamples_:
        offset = np.random.randint(0, nsamples_ - frames) \
            if nsamples_ > frames else 0
        noise = np.pad(noise, [(offset, nsamples_ - frames - offset), (0, 0)],
                       mode="wrap")
    elif frames > nsamples_:
        offset = np.random.randint(0, frames - nsamples_)
        noise = noise[offset:offset + nsamples_]
    if single_channel and noise.shape[1] > 1:
        noise = noise[:, [np.random.randint(noise.shape[1])]]
    noise = noise.T  # [C, T]
    if noise_sr != tgt_sr:
        noise = _resample_wav(noise, noise_sr, tgt_sr)
        if noise.shape[1] < nsamples:
            noise = np.pad(noise, [(0, 0), (0, nsamples - noise.shape[1])],
                           mode="wrap")
        else:
            noise = noise[:, :nsamples]
    return noise


def _add_noise_to(speech, noise_key, noise_data, tgt_sr, db_low, db_high,
                  single_channel=True):
    """speech [C, T] plus the noise `noise_data` (wav bytes) at an SNR
    uniform in [10, 30] dB for a `speech*` key, else [db_low, db_high]
    (numpy's global generator) -> (noisy, scaled noise, snr)."""
    nsamples = speech.shape[1]
    power = (speech ** 2).mean()
    snr_range = [10, 30] if noise_key.startswith("speech") \
        else [db_low, db_high]
    noise_db = np.random.uniform(snr_range[0], snr_range[1])
    noise_wav, noise_sr = read_wav(noise_data)
    noise = _fit_noise(noise_wav, noise_sr, tgt_sr, nsamples, single_channel)
    noise_power = (noise ** 2).mean()
    scale = 10 ** (-noise_db / 20) * np.sqrt(power) / np.sqrt(
        max(noise_power, 1e-10))
    scaled = (scale * noise).astype(np.float32)
    return (speech + scaled).astype(np.float32), scaled, noise_db


def add_noise(data: Iterable[dict], noise_lmdb_file: str,
              noise_prob: float = 0.0, noise_db_low: int = -5,
              noise_db_high: int = 25,
              single_channel: bool = True) -> Iterator[dict]:
    """With probability `noise_prob` per sample, noise from the store added
    to wav_mix (the scaled noise and its SNR kept as `noise`, `snr`)."""
    from wesep_tpu_torch.data.noise_store import NoiseStore

    noise_source = NoiseStore(noise_lmdb_file)
    for sample in data:
        if noise_prob > random.random():
            noise_key, noise_data = noise_source.random_one()
            mixed, scaled, noise_db = _add_noise_to(
                sample["wav_mix"], noise_key, noise_data,
                sample["sample_rate"], noise_db_low, noise_db_high,
                single_channel)
            sample["wav_mix"] = mixed
            sample["noise"] = scaled
            sample["snr"] = noise_db
        yield sample


def fetch_noise_chunk(data: Iterable[dict], noise_lmdb_file: str,
                      single_channel: bool = True) -> Iterator[dict]:
    """For the simulation on the device: a raw (unscaled) noise chunk of the
    sources' length per sample, `noise_chunk` [1, T]; its SNR scaling and
    the add run in the train step (augment.add_noise_snr). The noise's key
    is not kept, so speech noise gets the configured SNR range there, as
    in the JAX package."""
    from wesep_tpu_torch.data.noise_store import NoiseStore

    noise_source = NoiseStore(noise_lmdb_file)
    for sample in data:
        nsamples = np.asarray(sample["wav_spk1"]).shape[-1]
        _, noise_data = noise_source.random_one()
        noise_wav, noise_sr = read_wav(noise_data)
        noise = _fit_noise(noise_wav, noise_sr, sample["sample_rate"],
                           nsamples, single_channel)
        sample["noise_chunk"] = noise[:1].astype(np.float32)
        yield sample


def _reverberate(audio, rir):
    """audio [1, T] convolved with rir [1, L], trimmed to T, peak 0.9."""
    rir_audio = sp_signal.convolve(audio, rir, mode="full")[:, :audio.shape[1]]
    max_scale = np.max(np.abs(rir_audio))
    return (rir_audio / max(max_scale, 1e-10) * 0.9).astype(np.float32)


def add_reverb(data: Iterable[dict], reverb_prob: float = 0) -> Iterator[dict]:
    """FRAM-RIR reverberation of each source with probability `reverb_prob`
    (one room per sample, one RIR per source; the reverberant source
    replaces the dry one, so it is both mixed and the target)."""
    from wesep_tpu_torch.data.fram_rir import single_channel as rir_sim

    for sample in data:
        cfg = dict(simu_config)
        cfg["num_src"] = sample["num_speaker"]
        cfg["sr"] = sample["sample_rate"]
        rirs = rir_sim(cfg)[0][0]  # [n_src, L] of the one microphone
        for i in range(sample["num_speaker"]):
            if reverb_prob > random.random():
                sample[f"wav_spk{i + 1}"] = _reverberate(
                    np.asarray(sample[f"wav_spk{i + 1}"]), rirs[i:i + 1, :])
        yield sample


def add_noise_on_enroll(data: Iterable[dict], noise_lmdb_file: str,
                        noise_enroll_prob: float = 0.0,
                        noise_db_low: int = 0, noise_db_high: int = 25,
                        single_channel: bool = True) -> Iterator[dict]:
    """With probability `noise_enroll_prob` per target, noise from the store
    added to its enrollment wav."""
    from wesep_tpu_torch.data.noise_store import NoiseStore

    noise_source = NoiseStore(noise_lmdb_file)
    for sample in data:
        for key in list(sample.keys()):
            if key.startswith("spk") and "label" not in key:
                if noise_enroll_prob > random.random():
                    noise_key, noise_data = noise_source.random_one()
                    sample["embed_" + key], _, _ = _add_noise_to(
                        sample["embed_" + key], noise_key, noise_data,
                        sample["sample_rate"], noise_db_low, noise_db_high,
                        single_channel)
        yield sample


def add_reverb_on_enroll(data: Iterable[dict],
                         reverb_enroll_prob: float = 0) -> Iterator[dict]:
    """With probability `reverb_enroll_prob` per target, its enrollment wav
    reverberated by a FRAM-RIR of its own room."""
    from wesep_tpu_torch.data.fram_rir import single_channel as rir_sim

    for sample in data:
        for i in range(sample["num_speaker"]):
            if reverb_enroll_prob > random.random():
                cfg = dict(simu_config)
                cfg["sr"] = sample["sample_rate"]
                cfg["num_src"] = 1
                rir = rir_sim(cfg)[0][0]  # [1, L]
                sample[f"embed_spk{i + 1}"] = _reverberate(
                    np.asarray(sample[f"embed_spk{i + 1}"]), rir)
        yield sample
