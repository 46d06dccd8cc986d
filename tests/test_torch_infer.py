"""Port end to end: wesep_tpu_torch bin/infer against wesep_tpu bin/infer.

One tiny premixed shard, one set of numpy-seeded BSRNN weights (saved as a
JAX msgpack bundle for the JAX entry point and, through the weight bridge,
as a torch bundle for the port); both decode it on the CPU with the same
config and must report the same average SI-SNR and SI-SNRi.
"""

import io
import os
import tarfile

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from wesep_tpu.bin.infer import infer as jax_infer
from wesep_tpu.models.bsrnn import BSRNN as JaxBSRNN
from wesep_tpu.train.checkpoint import save_checkpoint as jax_save
from wesep_tpu_torch.bin.infer import infer
from wesep_tpu_torch.data.wav_io import read_wav, wav_bytes
from wesep_tpu_torch.device import resolve_device
from wesep_tpu_torch.train.checkpoint import save_checkpoint
from wesep_tpu_torch.utils.file_utils import write_vec_ark_scp
from wesep_tpu_torch.utils.jax_params import bsrnn_state_dict_from_jax

torch.set_num_threads(1)  # one intra-op thread per test worker

MODEL_ARGS = dict(sr=16000, win=512, stride=128, feature_dim=16,
                  num_repeat=2, spk_fuse_type="multiply",
                  use_spk_transform=False, multi_fuse=False,
                  joint_training=False, spk_emb_dim=16)


def _write_shard(tmp_path, lengths, emb_dim, seed=0):
    """Premixed shard (mixture, sources, speaker ids) + embedding scp +
    enrollment lists, as the recipes lay them out."""
    rng = np.random.default_rng(seed)
    embeds = {
        f"utt_spk{c}": rng.standard_normal(emb_dim).astype(np.float32)
        for c in "AB"
    }
    _, scp_path = write_vec_ark_scp(str(tmp_path / "embed"), embeds)
    keys = [f"g{i:02d}" for i in range(len(lengths))]
    with tarfile.open(tmp_path / "test.tar", "w") as tar:
        for key, t in zip(keys, lengths):
            s1 = rng.standard_normal(t).astype(np.float32) * 0.2
            s2 = rng.standard_normal(t).astype(np.float32) * 0.2
            for name, data in (
                (f"{key}.spk1", b"spkA"), (f"{key}.spk2", b"spkB"),
                (f"{key}.wav", wav_bytes(s1 + s2, 16000)),
                (f"{key}_spk1.wav", wav_bytes(s1, 16000)),
                (f"{key}_spk2.wav", wav_bytes(s2, 16000)),
            ):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
    (tmp_path / "test.list").write_text(str(tmp_path / "test.tar") + "\n")
    for i, spk in ((1, "A"), (2, "B")):
        (tmp_path / f"spk{i}_enroll").write_text(
            "".join(f"{k} utt_spk{spk}\n" for k in keys))
    return dict(
        test_data=str(tmp_path / "test.list"),
        test_spk_embeds=scp_path,
        test_spk1_enroll=str(tmp_path / "spk1_enroll"),
        test_spk2_enroll=str(tmp_path / "spk2_enroll"),
    )


def test_infer_matches_jax_infer(tmp_path):
    data = _write_shard(tmp_path, lengths=(6000, 7100), emb_dim=16)
    mix = np.zeros((1, 2000), np.float32)
    emb = np.zeros((1, 16), np.float32)
    params = JaxBSRNN(**MODEL_ARGS).init(
        jax.random.PRNGKey(3), jnp.asarray(mix), jnp.asarray(emb),
        train=False,
    )["params"]
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.standard_normal(p.shape).astype(
            np.float32) * 0.05,
        params,
    )
    jax_ckpt = str(tmp_path / "model.ckpt")
    jax_save(jax_ckpt, [params])
    port_ckpt = str(tmp_path / "model.pt")
    save_checkpoint(port_ckpt, [bsrnn_state_dict_from_jax(params)])

    config = {
        "model": {"tse_model": "BSRNN"},
        "model_args": {"tse_model": dict(MODEL_ARGS)},
        "data_type": "shard",
        "dataset_args": {"resample_rate": 16000},
    }
    cfg_path = str(tmp_path / "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.dump(config, f)

    want = jax_infer(cfg_path, checkpoint=jax_ckpt,
                     exp_dir=str(tmp_path / "exp_jax"), length_bucket=2000,
                     **data)
    got = infer(cfg_path, checkpoint=port_ckpt,
                exp_dir=str(tmp_path / "exp_port"), length_bucket=2000,
                device="cpu", **data)
    assert abs(got[0] - want[0]) < 1e-3 and abs(got[1] - want[1]) < 1e-3, \
        (got, want)

    audio = tmp_path / "exp_port" / "audio"
    wavs = sorted(p for p in os.listdir(audio) if p.endswith(".wav"))
    assert wavs == ["Utt1-g00-T0.wav", "Utt1-g00-T1.wav",
                    "Utt2-g01-T0.wav", "Utt2-g01-T1.wav"]
    wav, sr = read_wav(str(audio / "Utt2-g01-T1.wav"))
    assert sr == 16000 and wav.shape == (1, 7100)
    assert np.isclose(np.abs(wav).max(), 0.9, atol=1e-3)
    scp = (audio / "spk2.scp").read_text().split()
    assert scp[0] == "g00" and scp[1].endswith("Utt1-g00-T1.wav")

    # a dict config works too, and agrees with the path config
    again = infer(dict(config), checkpoint=port_ckpt,
                  exp_dir=str(tmp_path / "exp_dict"), length_bucket=2000,
                  device="cpu", save_wav=False, **data)
    assert again == got


def test_cuda_is_required_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the host without one")
    with pytest.raises(RuntimeError, match="GPU"):
        resolve_device()
    with pytest.raises(RuntimeError, match="GPU"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="GPU"):
        infer({"model": {"tse_model": "BSRNN"}}, checkpoint="unused")
