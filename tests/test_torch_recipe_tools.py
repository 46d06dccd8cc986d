"""The recipes' data tools in the port against the JAX package's:
make_shard_list_premix's shards byte for byte at the same seed,
extract_embed's embeddings (a narrow ResNet34, from the JAX package's own
msgpack bundle, alone and as a joint model's subtree) within 1e-4 rel.,
and test_dataset over those shards."""

import json
import os
import random
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_ecapa import port_variables
from wesep_tpu.models.speaker import get_speaker_model as jax_speaker_model
from wesep_tpu.tools import extract_embed as jax_extract
from wesep_tpu.tools import make_shard_list_premix as jax_premix
from wesep_tpu.train.checkpoint import save_checkpoint as jax_save
from wesep_tpu_torch.data.wav_io import write_wav
from wesep_tpu_torch.models.speaker import get_speaker_model
from wesep_tpu_torch.tools import extract_embed, make_shard_list_premix
from wesep_tpu_torch.tools import test_dataset as port_test_dataset
from wesep_tpu_torch.utils.file_utils import read_vec_scp_file

torch.set_num_threads(1)  # one intra-op thread per test worker

SPK_ARGS = {"m_channels": 8, "embed_dim": 16, "pooling_func": "TSTP",
            "two_emb_layer": False}


def _wavs(root, rng, n, seconds=1.0, prefix="w"):
    """n noisy harmonic wavs -> {key: path}."""
    out = {}
    t = np.arange(int(16000 * seconds)) / 16000
    for i in range(n):
        f0 = rng.uniform(90, 250)
        v = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in range(1, 5))
        v = (0.1 * v + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
        path = os.path.join(root, f"{prefix}{i}.wav")
        write_wav(path, v, 16000)
        out[f"{prefix}{i}"] = path
    return out


def _scp(path, entries):
    with open(path, "w") as f:
        f.writelines(f"{k} {v}\n" for k, v in entries.items())
    return path


def _run_jax_main(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()


def _premix_inputs(root, rng, n=5):
    mix = _wavs(root, rng, n, 0.5, "mix")
    s1 = _wavs(root, rng, n, 0.5, "s1_")
    s2 = _wavs(root, rng, n, 0.5, "s2_")
    keys = list(mix)
    return [_scp(os.path.join(root, "wav.scp"), mix),
            _scp(os.path.join(root, "spk1.scp"),
                 dict(zip(keys, s1.values()))) + "," +
            _scp(os.path.join(root, "spk2.scp"),
                 dict(zip(keys, s2.values()))),
            _scp(os.path.join(root, "utt2spks"),
                 {k: f"spkA{i} spkB{i}" for i, k in enumerate(keys)})]


@pytest.mark.parametrize("threads", [1, 2])
def test_make_shard_list_premix_matches_jax(tmp_path, monkeypatch, threads):
    rng = np.random.default_rng(0)
    inputs = _premix_inputs(str(tmp_path), rng)
    shards = {}
    for name, run in (("port", lambda a: make_shard_list_premix.main(a)),
                      ("jax", lambda a: _run_jax_main(monkeypatch,
                                                      jax_premix, a))):
        random.seed(11)
        out = tmp_path / name
        run(["--num_utts_per_shard", "2", "--num_threads", str(threads),
             "--shuffle", *inputs, str(out / "shards"),
             str(out / "shards.list")])
        with open(out / "shards.list") as f:
            paths = [line.strip() for line in f]
        shards[name] = [(os.path.basename(p), open(p, "rb").read())
                        for p in paths]
    assert len(shards["port"]) == 3
    assert shards["port"] == shards["jax"]


def _encoder_bundles(root, seed=5):
    """A narrow ResNet34's weights as a JAX msgpack bundle, alone and as
    the spk_model_net subtree of a joint bundle -> (plain, joint)."""
    jm = jax_speaker_model("ResNet34")(**SPK_ARGS)
    torch.manual_seed(seed)
    params, stats = port_variables(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 98, 80)),
                        train=False),
        get_speaker_model("ResNet34")(feat_dim=80, **SPK_ARGS), seed)
    plain = os.path.join(root, "spk.ckpt")
    joint = os.path.join(root, "joint.ckpt")
    jax_save(plain, [params], batch_stats=[stats])
    other = {"kernel": np.ones((2, 3), np.float32)}
    jax_save(joint, [{"spk_model_net": params, "mask_out_0": other}],
             batch_stats=[{"spk_model_net": stats}])
    return plain, joint


def test_extract_embed_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    root = str(tmp_path)
    wav_scp = _scp(os.path.join(root, "wav.scp"), _wavs(root, rng, 3, 1.2))
    plain, joint = _encoder_bundles(root)
    for ckpt, subtree in ((plain, None), (joint, "spk_model_net")):
        extra = ["--subtree", subtree] if subtree else []
        common = ["--wav_scp", wav_scp, "--checkpoint", ckpt,
                  "--spk_model", "ResNet34", "--spk_args",
                  json.dumps(SPK_ARGS), *extra]
        tag = subtree or "plain"
        extract_embed.main(common + ["--out_base",
                                     os.path.join(root, f"port_{tag}"),
                                     "--device", "cpu"])
        _run_jax_main(monkeypatch, jax_extract,
                      common + ["--out_base", os.path.join(root, f"jax_{tag}")])
        got = read_vec_scp_file(os.path.join(root, f"port_{tag}.scp"))
        want = read_vec_scp_file(os.path.join(root, f"jax_{tag}.scp"))
        assert list(got) == list(want) == ["w0", "w1", "w2"]
        for k, w in want.items():
            assert got[k].shape == (16,)
            err = np.linalg.norm(got[k] - w) / np.linalg.norm(w)
            assert err < 1e-4, (k, err)
    with pytest.raises(ValueError, match="no parameters under"):
        extract_embed.extract(wav_scp, joint, "ResNet34", SPK_ARGS,
                              os.path.join(root, "x"), subtree="spk_model",
                              device="cpu")


def test_test_dataset_runs_over_premixed_shards(tmp_path, capsys):
    """The joint chain (spk2enroll.json: speaker -> [[utt, wav], ...])
    over the premixed shards: batches of 2 mixtures, 2 rows each."""
    rng = np.random.default_rng(2)
    inputs = _premix_inputs(str(tmp_path), rng, n=4)
    make_shard_list_premix.main([*inputs, str(tmp_path / "shards"),
                                 str(tmp_path / "shards.list")])
    enroll = _wavs(str(tmp_path), rng, 2, 0.5, "enr")
    spk2enroll = {f"spk{c}{i}": [[f"enr{j}", enroll[f"enr{j}"]]
                                 for j in range(2)]
                  for c in "AB" for i in range(4)}
    with open(tmp_path / "spk2enroll.json", "w") as f:
        json.dump(spk2enroll, f)
    shapes = port_test_dataset.main(
        ["--data_list", str(tmp_path / "shards.list"), "--spk2enroll",
         str(tmp_path / "spk2enroll.json"), "--batch_size", "2",
         "--num_batches", "2", "--chunk_len", "4000"])
    assert len(shapes) == 2
    for batch in shapes:
        assert tuple(batch["wav_mix"]) == (4, 4000)
        assert tuple(batch["wav_targets"]) == (4, 4000)
        assert batch["spk_embeds"][0] == 4
    assert "batch 1:" in capsys.readouterr().out
