"""Streaming transforms of the serving and training paths, numpy-native.

The subset of wesep_tpu/data/processor.py that bin/infer and bin/train run
on premixed data: open local shards, group premixed shard members, parse
raw json lists, filter by length, shuffle, resample, cut random or leading
chunks and attach random (train) or fixed (validation, test) speaker cues:
pre-extracted embeddings or, for joint training, enrollment waveforms with
the speaker's class label. Each transform is a generator over sample
dicts; waveforms are float32 [1, T]. Every random draw comes from Python's
`random`, in the JAX package's order, so one seed gives both packages the
same samples.
"""

import json
import logging
import random
import tarfile
from typing import Iterable, Iterator
from urllib.parse import urlparse

import numpy as np
from scipy import signal as sp_signal

from wesep_tpu_torch.data.wav_io import read_wav

AUDIO_FORMAT_SETS = {"flac", "mp3", "m4a", "ogg", "opus", "wav", "wma"}

__all__ = ["url_opener", "tar_file_and_group", "parse_raw", "shuffle",
           "resample", "spk_to_id", "sample_spk_embedding",
           "sample_fix_spk_embedding", "sample_enrollment",
           "sample_fix_spk_enrollment",
           "get_random_chunk", "filter_len", "random_chunk", "fix_chunk"]


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


def resample(data: Iterable[dict], resample_rate: int = 16000) -> Iterator[dict]:
    """Resample every wav* entry (polyphase, scipy)."""
    for sample in data:
        sample_rate = sample["sample_rate"]
        if sample_rate != resample_rate:
            g = np.gcd(int(sample_rate), int(resample_rate))
            sample["sample_rate"] = resample_rate
            for key in list(sample.keys()):
                if "wav" in key:
                    sample[key] = sp_signal.resample_poly(
                        sample[key], resample_rate // g, sample_rate // g,
                        axis=-1,
                    ).astype(np.float32)
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
