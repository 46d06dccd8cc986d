"""Port parity: online mixing's host stages, chains, collate and tools
against the JAX package, on the CPU.

Every stage of wesep_tpu_torch.data.processor that online mixing and host
augmentation add (single-speaker shards and lists, speaker pairing, SNR
mixing, noise from a store, FRAM-RIR reverb, the enrollment's reverb and
noise) against wesep_tpu.data.processor under the same `random` and
`np.random` seeds; both Dataset chains (the simulation on the device and
the host's reference-semantics path) on shards and raw lists, batch for
batch against the JAX chain with prefetch 0; `tse_collate_fn_device`; the
two data tools against the JAX tools' outputs; ThroughputMeter on device
batches. Host reverb draws its RIRs from an unseeded
`np.random.default_rng()` in both packages (ROADMAP C.5 (a)), so these
tests replace that function by one seeded from a counter. Host outputs are
compared exactly: both packages run the same numpy and scipy code.
"""

import copy
import functools
import io
import itertools
import json
import os
import random
import sys
import tarfile

import numpy as np
import pytest
import torch

from wesep_tpu.data import BatchLoader as JaxBatchLoader
from wesep_tpu.data import Dataset as JaxDataset
from wesep_tpu.data import processor as jax_processor
from wesep_tpu.data import tse_collate_fn as jax_collate
from wesep_tpu.data import tse_collate_fn_device as jax_collate_device
from wesep_tpu_torch.data import (
    BatchLoader,
    Dataset,
    processor,
    tse_collate_fn,
    tse_collate_fn_device,
)
from wesep_tpu_torch.data.noise_store import build_pack
from wesep_tpu_torch.data.wav_io import wav_bytes, write_wav
from wesep_tpu_torch.utils.profiling import ThroughputMeter

torch.set_num_threads(1)  # one intra-op thread per test worker

SPEAKERS = {"spkA": 110.0, "spkB": 170.0, "spkC": 230.0, "spkD": 290.0}
SR = 16000
CHUNK = 4000  # at the chains' resample rate, 8 kHz


def _voice(rng, f0, n, sr=SR):
    t = np.arange(n) / sr
    s = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6)) / k
            for k in range(1, 4))
    return (0.1 * s + 0.005 * rng.standard_normal(n)).astype(np.float32)


def _add(tar, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Single-speaker utterances (3 per speaker, 0.8-1.4 s at 16 kHz) as a
    shard and as a raw list, 1 s enrollment wavs per speaker, a premixed
    shard, and a noise pack of a short mono noise, a long 22.05 kHz music
    and a stereo speech."""
    root = tmp_path_factory.mktemp("online")
    rng = np.random.default_rng(0)
    tar_path = str(root / "single.tar")
    raw = []
    with tarfile.open(tar_path, "w") as tar:
        for i in range(12):
            spk = sorted(SPEAKERS)[i % 4]
            key = f"utt{i:02d}"
            wav = _voice(rng, SPEAKERS[spk], int(SR * (0.8 + 0.05 * i)))
            path = str(root / f"{key}.wav")
            write_wav(path, wav, SR)
            _add(tar, f"{key}.spk", spk.encode())
            _add(tar, f"{key}.wav", wav_bytes(wav, SR))
            raw.append(json.dumps({"key": key, "wav": path, "spk": spk}))
    paths = {"shard": str(root / "shard.list"), "raw": str(root / "raw.list")}
    with open(paths["shard"], "w") as f:
        f.write(tar_path + "\n")
    with open(paths["raw"], "w") as f:
        f.write("\n".join(raw) + "\n")
    spk2enroll = {}
    for spk, f0 in SPEAKERS.items():
        path = str(root / f"enroll_{spk}.wav")
        write_wav(path, _voice(rng, f0, SR), SR)
        spk2enroll[spk] = [(f"enroll_{spk}", path)]
    premixed = str(root / "premixed.tar")
    with tarfile.open(premixed, "w") as tar:
        for i in range(4):
            a, b = sorted(SPEAKERS)[i], sorted(SPEAKERS)[(i + 1) % 4]
            s1 = _voice(rng, SPEAKERS[a], SR)
            s2 = _voice(rng, SPEAKERS[b], SR)
            key = f"mix{i}"
            for name, blob in ((f"{key}.spk1", a.encode()),
                               (f"{key}.spk2", b.encode()),
                               (f"{key}.wav", wav_bytes(s1 + s2, SR)),
                               (f"{key}_spk1.wav", wav_bytes(s1, SR)),
                               (f"{key}_spk2.wav", wav_bytes(s2, SR))):
                _add(tar, name, blob)
    paths["premixed"] = str(root / "premixed.list")
    with open(paths["premixed"], "w") as f:
        f.write(premixed + "\n")
    noise = []
    for name, n, sr, ch in (("noise_0", 2000, SR, 1),
                            ("music_1", 44100, 22050, 1),
                            ("speech_2", 30000, SR, 2)):
        path = str(root / f"{name}.wav")
        write_wav(path, (rng.standard_normal((ch, n)) * 0.05).astype(
            np.float32), sr)
        noise.append(path)
    paths["noise"] = build_pack(noise, str(root / "noise.pack"))
    paths["noise_wavs"] = noise
    paths["root"] = str(root)
    return paths, spk2enroll, {s: i for i, s in enumerate(sorted(SPEAKERS))}


@pytest.fixture
def seeded_rirs(monkeypatch):
    """np.random.default_rng() (no seed: host reverb's RIR generator) seeded
    from a counter, reset by calling the fixture's value."""
    real = np.random.default_rng
    counter = [itertools.count(100)]

    def default_rng(seed=None):
        return real(next(counter[0]) if seed is None else seed)

    monkeypatch.setattr(np.random, "default_rng", default_rng)

    def reset():
        counter[0] = itertools.count(100)
    return reset


def _same(got, want):
    """Two samples or batches: equal keys, equal numbers and arrays."""
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


def _run_stage(fn, samples, *args, seed=3, **kw):
    random.seed(seed)
    np.random.seed(seed)
    return list(fn(iter(copy.deepcopy(samples)), *args, **kw))


def _singles(paths, data_type="shard"):
    src = [{"src": s} for s in open(paths[data_type]).read().split("\n")
           if s]
    if data_type == "shard":
        return list(processor.tar_file_and_group_single_spk(
            processor.url_opener(src)))
    return list(processor.parse_raw_single_spk(src))


@pytest.mark.parametrize("data_type", ["shard", "raw"])
def test_single_speaker_readers_match_jax(data, data_type):
    paths, _, _ = data
    src = [{"src": s} for s in open(paths[data_type]).read().split("\n")
           if s]
    if data_type == "shard":
        got = list(processor.tar_file_and_group_single_spk(
            processor.url_opener(copy.deepcopy(src))))
        want = list(jax_processor.tar_file_and_group_single_spk(
            jax_processor.url_opener(copy.deepcopy(src))))
    else:
        got = list(processor.parse_raw_single_spk(src))
        want = list(jax_processor.parse_raw_single_spk(src))
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        _same(g, w)


def _pairs(paths):
    singles = [dict(s, wav=s["wav"][:, :CHUNK]) for s in _singles(paths)]
    return _run_stage(processor.mix_speakers, singles, 2, 5)


@pytest.mark.parametrize("stage", [
    "mix_speakers", "snr_mixer", "snr_mixer_random", "add_reverb",
    "add_noise", "fetch_noise_chunk", "add_noise_on_enroll",
    "add_reverb_on_enroll"])
def test_processor_stage_matches_jax(data, stage, seeded_rirs):
    """Each stage on the same samples under the same seeds (and the same
    counter-seeded RIR generators): equal outputs."""
    paths, spk2enroll, _ = data
    singles = [dict(s, wav=s["wav"][:, :CHUNK]) for s in _singles(paths)]
    pairs = _pairs(paths)
    enrolled = _run_stage(processor.sample_enrollment, pairs, spk2enroll)
    fn, samples, args = {
        "mix_speakers": ("mix_speakers", singles, (3, 5)),
        "snr_mixer": ("snr_mixer", pairs, (False,)),
        "snr_mixer_random": ("snr_mixer", pairs, (True,)),
        "add_reverb": ("add_reverb", pairs, (0.6,)),
        "add_noise": ("add_noise",
                      _run_stage(processor.snr_mixer, pairs, True),
                      (paths["noise"], 0.7)),
        "fetch_noise_chunk": ("fetch_noise_chunk", pairs, (paths["noise"],)),
        "add_noise_on_enroll": ("add_noise_on_enroll", enrolled,
                                (paths["noise"], 0.6)),
        "add_reverb_on_enroll": ("add_reverb_on_enroll", enrolled, (0.6,)),
    }[stage]
    seeded_rirs()
    got = _run_stage(getattr(processor, fn), samples, *args)
    seeded_rirs()
    want = _run_stage(getattr(jax_processor, fn), samples, *args)
    assert len(got) == len(want) == len(samples)
    for g, w in zip(got, want):
        _same(g, w)
    if stage == "mix_speakers":
        assert all(g["num_speaker"] == 3 and g["spk1"] != g["spk2"]
                   and g["spk1"] != g["spk3"] for g in got)
    if stage in ("add_reverb", "add_noise", "add_noise_on_enroll",
                 "add_reverb_on_enroll"):
        # the probability left some samples as they were and changed others
        field = {"add_reverb": "wav_spk1", "add_noise": "wav_mix"}.get(
            stage, "embed_spk1")
        changed = [not np.array_equal(g[field], s[field])
                   for g, s in zip(got, samples)]
        assert any(changed) and not all(changed), changed


@pytest.mark.parametrize("case", ["short", "long_resampled", "stereo"])
def test_fit_noise_and_resample_match_jax(data, case):
    paths, _, _ = data
    from wesep_tpu_torch.data.wav_io import read_wav

    wav, sr = read_wav(paths["noise_wavs"][
        {"short": 0, "long_resampled": 1, "stereo": 2}[case]])
    for tgt_sr, n in ((SR, 5000), (8000, 3000)):
        np.random.seed(4)
        got = processor._fit_noise(wav, sr, tgt_sr, n)
        np.random.seed(4)
        want = jax_processor._fit_noise(wav, sr, tgt_sr, n)
        assert got.shape == (1, n)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(processor._resample_wav(wav, sr, 8000),
                                  jax_processor._resample_wav(wav, sr, 8000))


def _configs(**extra):
    configs = {"resample_rate": 8000, "shuffle": True,
               "shuffle_args": {"shuffle_size": 4}, "chunk_len": CHUNK,
               "num_speakers": 2, "online_buffer_size": 8,
               "use_random_snr": True, "filter_len": True,
               "filter_args": {"min_num_seconds": 0.5,
                               "max_num_seconds": 1.2},
               "speaker_feat": False}
    configs.update(extra)
    return configs


def _chain_batches(pkg, data, data_type, device_augment, seeded_rirs,
                   n_batches=3):
    paths, spk2enroll, dict_spk = data
    dataset_fn, loader_fn, collate = pkg[device_augment]
    ds = dataset_fn(
        data_type, paths[data_type], _configs(), spk2enroll, None, None,
        state="train", joint_training=True, dict_spk=dict_spk,
        repeat_dataset=True, noise_prob=0.7, reverb_prob=0.5,
        noise_enroll_prob=0.5, reverb_enroll_prob=0.5,
        noise_lmdb_file=paths["noise"], online_mix=True,
        device_augment=device_augment, rank=0, world_size=1)
    loader = loader_fn(ds, batch_size=2, prefetch=0, collate_fn=(
        functools.partial(collate, fixed_enroll_len=8000)))
    loader.set_epoch(1)
    seeded_rirs()
    random.seed(21)
    np.random.seed(22)
    return list(itertools.islice(iter(loader), n_batches))


PORT = {True: (Dataset, BatchLoader, tse_collate_fn_device),
        False: (Dataset, BatchLoader, tse_collate_fn)}
JAX = {True: (JaxDataset, JaxBatchLoader, jax_collate_device),
       False: (JaxDataset, JaxBatchLoader, jax_collate)}


@pytest.mark.parametrize("device_augment", [True, False],
                         ids=["device", "host"])
@pytest.mark.parametrize("data_type", ["shard", "raw"])
def test_online_chain_matches_jax(data, data_type, device_augment,
                                  seeded_rirs):
    """Both chains of online mixing with reverb, noise and the
    enrollment's reverb and noise, three batches of 2 mixtures, equal to
    the JAX chain's: dry sources + noise chunks for the device, mixtures
    and targets for the host."""
    got = _chain_batches(PORT, data, data_type, device_augment, seeded_rirs)
    want = _chain_batches(JAX, data, data_type, device_augment, seeded_rirs)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same(g, w)
        assert g["spk_embeds"].shape == (4, 8000)
        assert g["spk_label"].shape == (4,)
        if device_augment:
            assert g["wav_srcs"].shape == (2, 2, CHUNK)
            assert g["wav_noise"].shape == (2, CHUNK)
            assert "wav_mix" not in g
        else:
            assert g["wav_mix"].shape == (4, CHUNK)
        # rows are sample-major, speaker-minor
        assert g["key"][0] == g["key"][1] and g["spk"][0] != g["spk"][1]


def test_premixed_chain_with_noise_matches_jax(data):
    """Premixed data with noise_prob: the host adds noise to the mixture,
    batch for batch as the JAX chain does."""
    paths, _, _ = data
    emb = {s: [np.full(8, i, np.float32)] for i, s in enumerate(SPEAKERS)}

    def batches(dataset_fn, loader_fn, collate):
        ds = dataset_fn("shard", paths["premixed"],
                        _configs(shuffle=False, filter_len=False), emb,
                        state="train",
                        repeat_dataset=True, noise_prob=0.6,
                        noise_lmdb_file=paths["noise"], rank=0, world_size=1)
        loader = loader_fn(ds, batch_size=2, collate_fn=collate, prefetch=0)
        loader.set_epoch(1)
        random.seed(5)
        np.random.seed(6)
        return list(itertools.islice(iter(loader), 3))

    for g, w in zip(batches(Dataset, BatchLoader, tse_collate_fn),
                    batches(JaxDataset, JaxBatchLoader, jax_collate)):
        _same(g, w)
    with pytest.raises(ValueError, match="noise_lmdb_file"):
        Dataset("shard", paths["premixed"], _configs(), emb, noise_prob=0.5)


def test_device_collate_matches_jax(data, seeded_rirs):
    paths, spk2enroll, dict_spk = data
    pairs = _run_stage(processor.fetch_noise_chunk, _pairs(paths),
                       paths["noise"])
    samples = _run_stage(processor.sample_enrollment, pairs, spk2enroll,
                         dict_spk)
    for kw in ({}, {"fixed_enroll_len": 12000}, {"mode": "max"}):
        got = tse_collate_fn_device(copy.deepcopy(samples[:3]), **kw)
        _same(got, jax_collate_device(copy.deepcopy(samples[:3]), **kw))
    assert got["wav_srcs"].shape == (3, 2, CHUNK)
    assert got["wav_noise"].shape == (3, CHUNK)
    assert got["spk_label"].tolist() == [
        dict_spk[s] for s in got["spk"]]
    without = tse_collate_fn_device(
        [{k: v for k, v in s.items() if k != "noise_chunk"}
         for s in samples[:2]])
    assert "wav_noise" not in without


def test_device_path_loses_the_noise_key(data):
    """ROADMAP C.5 (b): the chunks the device path fetches carry no key, so
    the simulation gives speech noise the configured SNR range, not the
    host path's [10, 30] dB."""
    paths, _, _ = data
    speech_only = build_pack([paths["noise_wavs"][2]],
                             os.path.join(paths["root"], "speech.pack"))
    out = _run_stage(processor.fetch_noise_chunk, _pairs(paths)[:2],
                     speech_only)
    assert all(set(s) - {"noise_chunk"} == set(p) for s, p in zip(
        out, _pairs(paths)[:2]))
    from wesep_tpu_torch.data import augment

    draws = augment.draw_augment(augment.step_generator(0, 0, 0, "cpu"), 64,
                                 2, noise_prob=1.0)
    assert draws["noise_snr"].min() < 10.0


def test_host_reverb_draws_from_an_unseeded_generator(data, monkeypatch):
    """ROADMAP C.5 (a): add_reverb and add_reverb_on_enroll call
    np.random.default_rng() without a seed, once for the room and once for
    the images, in both packages."""
    paths, spk2enroll, _ = data
    calls = []
    real = np.random.default_rng

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(7)

    monkeypatch.setattr(np.random, "default_rng", spy)
    pairs = _pairs(paths)[:2]
    _run_stage(processor.add_reverb, pairs, 1.0)
    assert calls == [((), {})] * 4
    calls.clear()
    _run_stage(jax_processor.add_reverb, pairs, 1.0)
    assert calls == [((), {})] * 4


def test_throughput_meter_counts_device_batches():
    meter = ThroughputMeter(sample_rate=8000)
    meter.update({"wav_srcs": np.zeros((8, 2, 24000), np.float32)})
    assert meter.audio_sec == 8 * 2 * 3.0
    meter.update({"wav_mix": np.zeros((16, 24000), np.float32)})
    assert meter.audio_sec == 2 * 8 * 2 * 3.0 and meter.steps == 2


def test_make_noise_db_writes_the_jax_tools_pack(data, tmp_path,
                                                 monkeypatch):
    from wesep_tpu.tools import make_noise_db as jax_tool
    from wesep_tpu_torch.tools import make_noise_db

    paths, _, _ = data
    scp = tmp_path / "noise.scp"
    scp.write_text("".join(f"n{i}_{os.path.basename(p)[:-4]} {p}\n"
                           for i, p in enumerate(paths["noise_wavs"])))
    make_noise_db.main([str(scp), str(tmp_path / "port.pack")])
    monkeypatch.setattr(sys, "argv", ["make_noise_db", str(scp),
                                      str(tmp_path / "jax.pack")])
    jax_tool.main()
    assert (tmp_path / "port.pack").read_bytes() == \
        (tmp_path / "jax.pack").read_bytes()
    try:
        import lmdb  # noqa: F401
    except ImportError:
        with pytest.raises(SystemExit, match="lmdb package"):
            make_noise_db.main([str(scp), str(tmp_path / "db"),
                                "--format", "lmdb"])
    else:
        from wesep_tpu_torch.data.noise_store import NoiseStore

        make_noise_db.main([str(scp), str(tmp_path / "db"),
                            "--format", "lmdb"])
        assert len(NoiseStore(str(tmp_path / "db")).keys) == 3


def test_make_shard_online_writes_the_jax_tools_shards(data, tmp_path,
                                                       monkeypatch):
    from wesep_tpu.tools import make_shard_online as jax_tool
    from wesep_tpu_torch.tools import make_shard_online

    paths, _, _ = data
    raw = [json.loads(line) for line in open(paths["raw"])]
    (tmp_path / "wav.scp").write_text(
        "".join(f"{r['key']} {r['wav']}\n" for r in raw))
    (tmp_path / "utt2spk").write_text(
        "".join(f"{r['key']} {r['spk']}\n" for r in raw))
    common = ["--num_utts_per_shard", "5", str(tmp_path / "wav.scp"),
              str(tmp_path / "utt2spk")]
    make_shard_online.main(common + [str(tmp_path / "port"),
                                     str(tmp_path / "port.list")])
    monkeypatch.setattr(sys, "argv", ["make_shard_online"] + common + [
        str(tmp_path / "jax"), str(tmp_path / "jax.list")])
    jax_tool.main()
    ours = open(tmp_path / "port.list").read().split()
    theirs = open(tmp_path / "jax.list").read().split()
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert os.path.basename(a) == os.path.basename(b)
        assert open(a, "rb").read() == open(b, "rb").read()
    # and the shards read back as the raw list's utterances
    got = _singles({"shard": str(tmp_path / "port.list")})
    assert [g["key"] for g in got] == [r["key"] for r in raw]
