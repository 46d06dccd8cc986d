"""The port's extractor, VAD and hub against the JAX package's.

One model dir of a joint fbank BSRNN (a narrow ResNet18 on the
enrollment's 80-bin fbank) holds the JAX package's own msgpack
avg_model.ckpt and config.yaml, as tests/test_tools_cli.py builds it; the
port's Extractor and the JAX Extractor decode the same wavs from it: a
short mixture (the length-bucket path, with the enrollment's VAD) and one
past `chunk_sec` (the cross-faded windows), within 5e-4 of the largest
sample. Also: the VAD's segments, the hub's error without the network,
and an unpacked release with only the reference's avg_model.pt.
"""

import os
import socket

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from test_torch_ecapa import port_variables
from torch_reference_layouts import reference_state_dict
from wesep_tpu.cli.extractor import Extractor as JaxExtractor
from wesep_tpu.data import vad as jax_vad
from wesep_tpu.models.bsrnn import BSRNN as JaxBSRNN
from wesep_tpu.train.checkpoint import save_checkpoint as jax_save
from wesep_tpu_torch.cli import extractor as port_extractor
from wesep_tpu_torch.cli.extractor import Extractor, load_model_local
from wesep_tpu_torch.cli.hub import Hub
from wesep_tpu_torch.data import vad
from wesep_tpu_torch.data.wav_io import read_wav, write_wav
from wesep_tpu_torch.models.bsrnn import BSRNN
from wesep_tpu_torch.train.checkpoint import save_checkpoint, split_state

torch.set_num_threads(1)  # one intra-op thread per test worker

JOINT = dict(spk_emb_dim=32, feature_dim=8, num_repeat=1, joint_training=True,
             use_spk_transform=False, spk_fuse_type="multiply",
             multi_fuse=False, spk_model="ResNet18",
             spk_args={"feat_dim": 80, "embed_dim": 32, "m_channels": 8,
                       "two_emb_layer": False},
             spk_feat=True, remat=False)
LIMIT = 5e-4  # of the largest sample


def _voice(rng, n, f0, sr=16000):
    t = np.arange(n) / sr
    v = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6)) / k
            for k in range(1, 5))
    v = 0.1 * v + 0.01 * rng.standard_normal(n)
    v[n // 4: n // 4 + n // 8] *= 0.001  # a pause for the VAD
    return v.astype(np.float32)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """The JAX package's msgpack bundle and config of a joint fbank BSRNN
    (the port's seeded weights, perturbed, in the JAX tree)."""
    root = tmp_path_factory.mktemp("mdl")
    jm = JaxBSRNN(**JOINT)
    torch.manual_seed(0)
    params, stats = port_variables(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4000)),
                        jnp.zeros((1, 50, 80)), train=False),
        BSRNN(**JOINT), seed=1)
    jax_save(str(root / "avg_model.ckpt"), [params], batch_stats=[stats])
    config = {"model": {"tse_model": "BSRNN"},
              "model_args": {"tse_model": dict(JOINT)},
              "dataset_args": {"resample_rate": 16000}}
    with open(root / "config.yaml", "w") as f:
        yaml.dump(config, f)
    return str(root)


def _wavs(root, n_mix, seed):
    rng = np.random.default_rng(seed)
    mix = _voice(rng, n_mix, 120) + _voice(rng, n_mix, 210)
    enroll = _voice(rng, 12000, 120)
    paths = (os.path.join(root, f"mix{seed}.wav"),
             os.path.join(root, f"enr{seed}.wav"))
    write_wav(paths[0], mix, 16000)
    write_wav(paths[1], enroll, 16000)
    return paths


def _close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= LIMIT * np.abs(want).max(), err


def test_extractor_matches_jax_short_and_chunked(model_dir, tmp_path):
    ours = Extractor(model_dir, device="cpu")
    theirs = JaxExtractor(model_dir)
    # a short mixture: one padded forward, the enrollment trimmed by VAD
    mix, enroll = _wavs(str(tmp_path), 7000, 0)
    for ex in (ours, theirs):
        ex.set_vad(True)
    got, sr = ours.extract_speech(mix, enroll)
    want, _ = theirs.extract_speech(mix, enroll)
    assert sr == 16000 and got.shape == (7000,)
    _close(got, want)
    # past chunk_sec: three cross-faded windows of 4000 samples
    mix, enroll = _wavs(str(tmp_path), 10700, 1)
    for ex in (ours, theirs):
        ex.set_vad(False)
        ex.set_chunk_decode(chunk_sec=0.25, overlap_sec=0.05)
    got, _ = ours.extract_speech(mix, enroll)
    want, _ = theirs.extract_speech(mix, enroll)
    assert got.shape == (10700,)
    _close(got, want)
    # the windows' weights add back to the input under an identity forward
    rng = np.random.default_rng(3)
    x = rng.standard_normal(10700).astype(np.float32)
    ours._forward = lambda m, e: m[0]
    np.testing.assert_allclose(ours._decode(x, np.zeros((1, 50, 80))), x,
                               atol=1e-6)


def test_extractor_command_line(model_dir, tmp_path):
    mix, enroll = _wavs(str(tmp_path), 5000, 2)
    out = str(tmp_path / "out.wav")
    port_extractor.main([mix, enroll, "-p", model_dir, "-o", out,
                         "--device", "cpu", "--vad"])
    wav, sr = read_wav(out)
    assert sr == 16000 and wav.shape == (1, 5000)
    assert np.isclose(np.abs(wav).max(), 0.9, atol=1e-3)
    with pytest.raises(ValueError, match="pre-extracted-embedding"):
        ours = Extractor(model_dir, device="cpu")
        ours.joint_training = False
        ours.extract_speech(mix, enroll)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vad_matches_jax(seed):
    rng = np.random.default_rng(seed)
    wav = _voice(rng, 16000 + 997 * seed, 150)
    wav[:3000] *= 0.0001
    got = vad.energy_vad_segments(wav, 16000)
    assert got == jax_vad.energy_vad_segments(wav, 16000)
    assert len(got) >= 2
    np.testing.assert_array_equal(vad.trim_silence(wav),
                                  jax_vad.trim_silence(wav))
    for a, b in zip(vad.VoiceActivityDetection(wav).select(0.3),
                    jax_vad.VoiceActivityDetection(wav).select(0.3)):
        np.testing.assert_array_equal(a, b)
    assert vad.energy_vad_segments(wav[:100]) == [(0, 100)]


def test_hub_raises_without_touching_the_network(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the hub opened a connection")

    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(socket.socket, "connect", refuse)
    with pytest.raises(RuntimeError, match="downloads no models"):
        Hub.get_model("english")
    with pytest.raises(ValueError, match="no pretrained model"):
        Hub.get_model("klingon")
    with pytest.raises(RuntimeError, match="-p/--pretrain"):
        port_extractor.load_model("chinese")


def test_release_dir_with_a_reference_pt(tmp_path, capsys):
    """An unpacked release: one folder with config.yaml and the reference's
    avg_model.pt of a joint BSRNN whose wespeaker ECAPA branch the config
    does not name. load_model_local lifts the folder, converts the .pt
    (the bundle equals the model's weights), detects the layout and
    extracts; a bundle without the encoder warns and keeps its seeded
    initial weights."""
    args = dict(sr=16000, win=512, stride=128, feature_dim=16, num_repeat=1,
                spk_fuse_type="multiply", use_spk_transform=False,
                multi_fuse=False, spk_feat=True, joint_training=True,
                spk_model="ECAPA_TDNN_GLOB_c32", spk_emb_dim=16,
                spk_args=dict(feat_dim=80, embed_dim=16,
                              pooling_func="ASTP"))
    torch.manual_seed(2)
    model = BSRNN(**dict(args, spk_args=dict(args["spk_args"],
                                             layout="wespeaker")))
    ref = reference_state_dict("bsrnn", model.state_dict(), num_repeat=1,
                               scope="spk_model_net", speaker="ECAPA")
    release = tmp_path / "release" / "bsrnn_ecapa_vox1"
    release.mkdir(parents=True)
    torch.save({"models": [{k: torch.from_numpy(v) for k, v in ref.items()}]},
               release / "avg_model.pt")
    config = {"model": {"tse_model": "BSRNN"},
              "model_args": {"tse_model": args},
              "dataset_args": {"resample_rate": 16000}}
    with open(release / "config.yaml", "w") as f:
        yaml.dump(config, f)
    root = str(tmp_path / "release")
    ex = load_model_local(root, device="cpu")
    assert sorted(os.listdir(root)) == ["avg_model.ckpt", "avg_model.pt",
                                        "config.yaml"]
    for k, v in model.state_dict().items():
        assert torch.equal(ex.model.state_dict()[k], v), k
    mix, enroll = _wavs(str(tmp_path), 4000, 4)
    est, _ = ex.extract_speech(mix, enroll)
    assert est.shape == (4000,) and np.isfinite(est).all()

    params, buffers = split_state(model)
    save_checkpoint(str(tmp_path / "release" / "avg_model.ckpt"), [{
        k: v for k, v in params.items() if not k.startswith("spk_model_net")
    }])
    capsys.readouterr()
    torch.manual_seed(9)
    ex = Extractor(root, device="cpu")
    assert "missing param subtrees ['spk_model_net']" in capsys.readouterr(
        ).out
    assert torch.equal(ex.model.state_dict()["bsnet_0.band_rnn.rnn.wx_f"],
                       model.state_dict()["bsnet_0.band_rnn.rnn.wx_f"])
