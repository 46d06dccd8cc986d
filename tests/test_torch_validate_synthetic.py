"""tools/validate_synthetic in the port against the JAX package's: the
corpus builders byte for byte, the three configs key for key (the training
and decoding entry points stubbed in both packages, so nothing trains),
the floors table against tests/test_quality_floors.py, and each row of the
battery end to end on the CPU at 1 epoch of one step."""

import argparse
import math
import os
import sys
import types

import pytest
import torch
import yaml

import test_quality_floors
from wesep_tpu.tools import validate_synthetic as jax_vs
from wesep_tpu_torch.tools import validate_synthetic as port_vs

torch.set_num_threads(1)  # one intra-op thread per test worker

TINY = dict(num_spk=3, utts_per_spk=1)


def _args(work_dir, **kw):
    base = dict(work_dir=str(work_dir), model="BSRNN", num_epochs=1,
                batch_size=8, feature_dim=32, num_repeat=2, chunk_len=8000,
                seed=0, online_mix=False, gan=False, **TINY)
    base.update(kw)
    return argparse.Namespace(**base)


def _tree(root):
    """{path relative to root: bytes with root's path replaced}."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                data = f.read()
            out[os.path.relpath(path, root)] = data.replace(
                str(root).encode(), b"<work_dir>")
    return out


def test_premixed_corpus_matches_jax(tmp_path):
    got = port_vs.build_corpus(_args(tmp_path / "port"))
    want = jax_vs.build_corpus(_args(tmp_path / "jax"))
    assert os.path.relpath(got[0], tmp_path / "port") == \
        os.path.relpath(want[0], tmp_path / "jax")
    assert got[1] == want[1]
    port, jax = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(port) == sorted(jax) == sorted(
        ["embed.ark", "embed.scp", "single.utt2spk"]
        + [f"{s}.{ext}" for s in ("train", "dev", "test")
           for ext in ("tar", "list", "spk1_enroll", "spk2_enroll")])
    for name, data in jax.items():
        assert port[name] == data, name


def test_online_corpus_matches_jax(tmp_path):
    n = port_vs.build_corpus_online(_args(tmp_path / "port"))
    assert n == jax_vs.build_corpus_online(_args(tmp_path / "jax"))
    port, jax = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(port) == sorted(jax)
    for name in ("spk2enroll.json", "train.tar", "utt2spk", "train.list",
                 "enroll_wav.scp", "enroll/spk00.wav", "dev.tar"):
        assert name in jax, name
    for name, data in jax.items():
        assert port[name] == data, name


def _stub_entry_points(monkeypatch, package):
    """Replace package's bin.train / train_gan / infer by stubs that record
    the config path they are handed and train nothing."""
    calls = []

    def train(cfg, *a, **k):
        calls.append(("train", cfg))

    def train_gan(cfg, *a, **k):
        calls.append(("train_gan", cfg))

    def infer(cfg, *a, **k):
        calls.append(("infer", cfg, sorted(k.items())))
        return 1.0, 2.0

    for name, fn in (("train", train), ("train_gan", train_gan),
                     ("infer", infer)):
        module = types.ModuleType(f"{package}.bin.{name}")
        setattr(module, name, fn)
        monkeypatch.setitem(sys.modules, f"{package}.bin.{name}", module)
    return calls


@pytest.mark.parametrize("name,kwargs,floor", port_vs.FLOORS,
                         ids=[r[0] for r in port_vs.FLOORS])
def test_config_matches_jax_key_for_key(tmp_path, monkeypatch, name, kwargs,
                                        floor):
    """Each row's config.yaml equals the JAX tool's but for `device`, the
    one key the port adds; the same entry points get the same arguments."""
    configs, calls = {}, {}
    for tag, module, package in (("port", port_vs, "wesep_tpu_torch"),
                                 ("jax", jax_vs, "wesep_tpu")):
        calls[tag] = _stub_entry_points(monkeypatch, package)
        root = tmp_path / tag
        extra = {"device": "cpu"} if tag == "port" else {}
        assert module.run(str(root), **TINY, **kwargs, **extra) == 2.0
        with open(root / "config.yaml") as f:
            text = f.read().replace(str(root), "<work_dir>")
        configs[tag] = yaml.safe_load(text)
        calls[tag] = [tuple(str(x).replace(str(root), "<work_dir>")
                            for x in c) for c in calls[tag]]
    assert configs["port"].pop("device") == "cpu"
    assert configs["port"] == configs["jax"]
    assert calls["port"] == calls["jax"]
    trainer = "train_gan" if kwargs.get("gan") else "train"
    assert [c[0] for c in calls["port"]] == [trainer, "infer"]


def test_port_default_device_is_the_card(tmp_path, monkeypatch):
    _stub_entry_points(monkeypatch, "wesep_tpu_torch")
    port_vs.run(str(tmp_path), **TINY)
    with open(tmp_path / "config.yaml") as f:
        assert yaml.safe_load(f)["device"] == "cuda"


def test_floors_table_matches_the_jax_battery():
    fn = test_quality_floors.test_synthetic_convergence_floor
    (mark,) = [m for m in fn.pytestmark if m.name == "parametrize"]
    assert mark.args[0] == "name,kwargs,floor"
    assert [tuple(r) for r in mark.args[1]] == list(port_vs.FLOORS)
    assert test_quality_floors._SMALL == port_vs.SMALL
    assert "slow" in [m.name for m in fn.pytestmark]


@pytest.mark.parametrize("name,kwargs,floor", port_vs.FLOORS,
                         ids=[r[0] for r in port_vs.FLOORS])
def test_row_runs_end_to_end_on_cpu(tmp_path, name, kwargs, floor):
    """One epoch of one train step (2 speakers, 2 utterances, batch 2) of
    each row through the port's entry points: a finite SI-SNRi, the final
    checkpoint and the decoded wavs of every test row."""
    kw = dict(kwargs, num_epochs=1)
    sisnri = port_vs.run(str(tmp_path), num_spk=2, utts_per_spk=1,
                         chunk_len=8000, batch_size=2, device="cpu", **kw)
    assert math.isfinite(sisnri)
    exp = tmp_path / "exp"
    assert (exp / "models" / "final_checkpoint.ckpt").exists()
    # 2 test mixtures, each decoded for both of its speakers
    for i in (1, 2):
        with open(exp / "audio" / f"spk{i}.scp") as f:
            paths = [line.split()[1] for line in f]
        assert len(paths) == 2 and all(os.path.exists(p) for p in paths)
