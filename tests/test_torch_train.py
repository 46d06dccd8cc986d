"""Port end to end: wesep_tpu_torch bin/train on the CPU on a tiny shard.

Two epochs through the port's own entry point (device: cpu, so every kernel
runs its plain version): the loss falls, checkpoints, links and config.yaml
appear, a resumed run starts at epoch 2 from the saved optimizer state,
bin/average_model averages the epochs and bin/infer decodes from the
result. The train chain must also yield the same batches as the JAX
package's under the same `random` seed.
"""

import io
import os
import random
import re
import tarfile

import numpy as np
import pytest
import torch

from wesep_tpu.data import BatchLoader as JaxBatchLoader
from wesep_tpu.data import Dataset as JaxDataset
from wesep_tpu.data import tse_collate_fn as jax_collate
from wesep_tpu_torch.bin import average_model
from wesep_tpu_torch.bin.infer import infer
from wesep_tpu_torch.bin.train import train
from wesep_tpu_torch.data import (
    BatchLoader,
    Dataset,
    MultiWorkerLoader,
    tse_collate_fn,
)
from wesep_tpu_torch.data import processor
from wesep_tpu_torch.data.datalist import DataList
from wesep_tpu_torch.data.wav_io import wav_bytes
from wesep_tpu_torch.train.checkpoint import (
    find_epoch_checkpoints,
    load_checkpoint,
    save_checkpoint,
)
from wesep_tpu_torch.utils.file_utils import (
    load_speaker_embeddings,
    norm_embeddings,
    read_label_file,
    read_vec_scp_file,
    write_vec_ark_scp,
)

torch.set_num_threads(1)  # one intra-op thread per test worker

EMB = 16
SPEAKERS = {"spkA": 110.0, "spkB": 170.0, "spkC": 230.0}
MODEL_ARGS = dict(sr=16000, win=512, stride=128, feature_dim=16,
                  num_repeat=2, spk_fuse_type="multiply",
                  use_spk_transform=False, multi_fuse=False,
                  joint_training=False, spk_emb_dim=EMB)


def _voice(rng, f0, n):
    t = np.arange(n) / 16000.0
    s = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6)) / k
            for k in range(1, 4))
    return (0.1 * s + 0.005 * rng.standard_normal(n)).astype(np.float32)


def _write_set(root, name, n_mix, n_samples, rng):
    """One premixed shard `name`.tar with its list, utt2spk, embedding scp
    (two utterances per speaker) and enrollment lists."""
    os.makedirs(root, exist_ok=True)
    # a speaker's embedding is the same in every set: seeded by its pitch
    base = {s: np.random.default_rng(int(f0)).standard_normal(EMB)
            for s, f0 in SPEAKERS.items()}
    embeds, utt2spk = {}, {}
    for spk in SPEAKERS:
        for u in range(2):
            utt = f"{name}_{spk}_u{u}"
            embeds[utt] = base[spk] + 0.05 * rng.standard_normal(EMB)
            utt2spk[utt] = spk
    _, scp = write_vec_ark_scp(os.path.join(root, f"{name}_embed"), embeds)
    with open(os.path.join(root, f"{name}.utt2spk"), "w") as f:
        f.writelines(f"{u} {s}\n" for u, s in utt2spk.items())
    keys, pairs = [], []
    names = sorted(SPEAKERS)
    tar_path = os.path.join(root, f"{name}.tar")
    with tarfile.open(tar_path, "w") as tar:
        for i in range(n_mix):
            key = f"{name}{i:02d}"
            a, b = names[i % 3], names[(i + 1) % 3]
            s1 = _voice(rng, SPEAKERS[a], n_samples)
            s2 = _voice(rng, SPEAKERS[b], n_samples)
            for member, data in (
                (f"{key}.spk1", a.encode()), (f"{key}.spk2", b.encode()),
                (f"{key}.wav", wav_bytes(s1 + s2, 16000)),
                (f"{key}_spk1.wav", wav_bytes(s1, 16000)),
                (f"{key}_spk2.wav", wav_bytes(s2, 16000)),
            ):
                info = tarfile.TarInfo(member)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
            keys.append(key)
            pairs.append((a, b))
    with open(os.path.join(root, f"{name}.list"), "w") as f:
        f.write(tar_path + "\n")
    for i in (0, 1):
        with open(os.path.join(root, f"{name}_spk{i + 1}_enroll"), "w") as f:
            f.writelines(f"{k} {name}_{p[i]}_u0\n"
                         for k, p in zip(keys, pairs))
    return dict(
        data=os.path.join(root, f"{name}.list"), spk_embeds=scp,
        utt2spk=os.path.join(root, f"{name}.utt2spk"),
        spk1_enroll=os.path.join(root, f"{name}_spk1_enroll"),
        spk2_enroll=os.path.join(root, f"{name}_spk2_enroll"))


def _config(root, tr, va, **extra):
    config = {
        "device": "cpu",
        "exp_dir": os.path.join(root, "exp"),
        "data_type": "shard",
        "train_data": tr["data"], "train_spk_embeds": tr["spk_embeds"],
        "train_utt2spk": tr["utt2spk"],
        "val_data": va["data"], "val_spk_embeds": va["spk_embeds"],
        "val_spk1_enroll": va["spk1_enroll"],
        "val_spk2_enroll": va["spk2_enroll"],
        "dataloader_args": {"batch_size": 2, "prefetch_factor": 2},
        "dataset_args": {"resample_rate": 16000, "sample_num_per_epoch": 12,
                         "shuffle": True,
                         "shuffle_args": {"shuffle_size": 4},
                         "chunk_len": 4000},
        "loss": "SISDR", "loss_args": {},
        "model": {"tse_model": "BSRNN"},
        "model_args": {"tse_model": dict(MODEL_ARGS)},
        "model_init": {"tse_model": None},
        "num_avg": 2, "num_epochs": 2, "log_batch_interval": 2,
        "optimizer": {"tse_model": "Adam"},
        "optimizer_args": {"tse_model": {"lr": 0.003, "weight_decay": 1e-4}},
        "clip_grad": 5.0, "save_epoch_interval": 1,
        "scheduler": {"tse_model": "ExponentialDecrease"},
        "scheduler_args": {"tse_model": {
            "final_lr": 1e-3, "initial_lr": 0.003, "warm_from_zero": False,
            "warm_up_epoch": 0}},
        "seed": 42,
    }
    config.update(extra)
    return config


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_data"))
    rng = np.random.default_rng(0)
    tr = _write_set(root, "train", n_mix=6, n_samples=8000, rng=rng)
    va = _write_set(root, "dev", n_mix=4, n_samples=6000, rng=rng)
    return root, tr, va


@pytest.fixture(scope="module")
def trained(sets, tmp_path_factory):
    """Two epochs of bin/train on the CPU."""
    _, tr, va = sets
    root = str(tmp_path_factory.mktemp("train_run"))
    config = _config(root, tr, va)
    state = train(config)
    return root, config, state


def _epoch_losses(exp_dir, log="train.log"):
    text = open(os.path.join(exp_dir, log)).read()
    return [(int(e), float(t), float(v)) for e, t, v in re.findall(
        r"Epoch (\d+) train_loss (-?[\d.]+) val_loss (-?[\d.]+)", text)]


def test_train_two_epochs_loss_falls_and_files_appear(trained):
    root, config, state = trained
    exp = config["exp_dir"]
    losses = _epoch_losses(exp)
    assert [e for e, _, _ in losses] == [1, 2]
    assert all(np.isfinite([t, v]).all() for _, t, v in losses)
    assert losses[1][1] < losses[0][1]  # the train loss falls
    models = os.path.join(exp, "models")
    assert [e for e, _ in find_epoch_checkpoints(models)] == [1, 2]
    assert os.readlink(os.path.join(models, "latest_checkpoint.ckpt")) \
        == "checkpoint_2.ckpt"
    assert os.readlink(os.path.join(models, "final_checkpoint.ckpt")) \
        == "checkpoint_2.ckpt"
    assert os.path.exists(os.path.join(exp, "config.yaml"))
    assert state.step == 12 and state.optimizer.count == 12
    bundle = load_checkpoint(os.path.join(models, "checkpoint_1.ckpt"))
    assert bundle["step"] == 6
    assert bundle["opt_states"][0]["count"] == 6
    assert set(bundle["opt_states"][0]["mu"]) == set(bundle["models"][0])
    log = open(os.path.join(exp, "train.log")).read()
    assert "TRAIN" in log and "epoch iteration number: 6" in log


def test_resume_starts_at_epoch_two_with_saved_optimizer_state(trained, sets):
    """Resuming from checkpoint_1 runs epoch 2 only, from the saved step
    and the saved optimizer state."""
    root, config, state = trained
    _, tr, va = sets
    resumed_cfg = dict(config, exp_dir=os.path.join(root, "exp_resume"))
    ckpt = os.path.join(config["exp_dir"], "models", "checkpoint_1.ckpt")
    resumed = train(resumed_cfg, checkpoint=ckpt)
    log = open(os.path.join(resumed_cfg["exp_dir"], "train.log")).read()
    assert "start_epoch: 2" in log
    assert [e for e, _, _ in _epoch_losses(resumed_cfg["exp_dir"])] == [2]
    assert resumed.step == 12 and resumed.optimizer.count == 12
    # the moments in the file are the ones epoch 1 left, and they are what
    # the resumed run started from: restoring them into a fresh optimizer
    # reproduces the file
    saved = load_checkpoint(ckpt)["opt_states"][0]
    assert saved["count"] == 6
    assert all(v.abs().max() > 0 for v in saved["nu"].values())
    from wesep_tpu_torch.train.checkpoint import restore_train_state
    from wesep_tpu_torch.train.trainer import TrainState, make_optimizer

    fresh = TrainState(resumed.model, make_optimizer(resumed.model, None))
    restore_train_state(fresh, ckpt)
    assert fresh.step == 6 and fresh.optimizer.count == 6
    for name, v in saved["mu"].items():
        assert torch.equal(fresh.optimizer.mu[name], v)


def test_average_model_then_infer(trained, sets):
    root, config, _ = trained
    _, _, va = sets
    models = os.path.join(config["exp_dir"], "models")
    dst = os.path.join(root, "avg_model.ckpt")
    average_model.main(["--dst_model", dst, "--src_path", models,
                        "--num", "2"])
    avg = load_checkpoint(dst)
    one = load_checkpoint(os.path.join(models, "checkpoint_1.ckpt"))
    two = load_checkpoint(os.path.join(models, "checkpoint_2.ckpt"))
    for k, v in avg["models"][0].items():
        torch.testing.assert_close(
            v, (one["models"][0][k] + two["models"][0][k]) / 2)
    assert avg["step"] == 12
    sisnr, sisnri = infer(
        {"model": config["model"], "model_args": config["model_args"],
         "data_type": "shard", "dataset_args": {"resample_rate": 16000}},
        checkpoint=dst, exp_dir=os.path.join(root, "exp_infer"),
        device="cpu", save_wav=False, length_bucket=2000,
        test_data=va["data"], test_spk_embeds=va["spk_embeds"],
        test_spk1_enroll=va["spk1_enroll"],
        test_spk2_enroll=va["spk2_enroll"])
    assert np.isfinite(sisnr) and np.isfinite(sisnri)


def test_old_bundles_still_load(tmp_path):
    """A bundle with only models and step (as the serving slice wrote
    them) loads, and the new keys default to empty."""
    path = str(tmp_path / "old.pt")
    torch.save({"models": [{"w": torch.ones(2)}], "step": 3}, path)
    old = load_checkpoint(path)
    assert old["step"] == 3 and "opt_states" not in old
    save_checkpoint(path, [{"w": torch.ones(2)}])
    new = load_checkpoint(path)
    assert new["opt_states"] == [] and new["extra"] == {}


def _dataset_args():
    return {"resample_rate": 16000, "shuffle": True,
            "shuffle_args": {"shuffle_size": 4}, "chunk_len": 4000}


@pytest.mark.parametrize("state", ["train", "val"])
def test_chain_yields_the_same_batches_as_the_jax_package(sets, state):
    """Same lists, same `random` seed: the port's chain and the JAX
    package's draw the same chunks and embeddings, batch by batch."""
    _, tr, va = sets
    if state == "train":
        emb = load_speaker_embeddings(tr["spk_embeds"], tr["utt2spk"])
        args = (tr["data"], _dataset_args(), emb, None, None)
    else:
        args = (va["data"], _dataset_args(),
                read_vec_scp_file(va["spk_embeds"]),
                read_label_file(va["spk1_enroll"]),
                read_label_file(va["spk2_enroll"]))

    def batches(dataset_fn, loader_fn, collate):
        ds = dataset_fn("shard", *args, state=state, repeat_dataset=True,
                        rank=0, world_size=1)
        loader = loader_fn(ds, batch_size=2, collate_fn=collate, prefetch=0)
        loader.set_epoch(3)
        random.seed(11)
        out = []
        for i, b in enumerate(loader):
            out.append(b)
            if i == 4:  # five batches: past one pass over the shard
                break
        return out

    want = batches(JaxDataset, JaxBatchLoader, jax_collate)
    got = batches(Dataset, BatchLoader, tse_collate_fn)
    for g, w in zip(got, want):
        assert g["key"] == w["key"] and g["spk"] == w["spk"]
        for k in ("wav_mix", "wav_targets", "spk_embeds"):
            np.testing.assert_array_equal(g[k], w[k])
        assert g["wav_mix"].shape == (4, 4000)
        assert g["spk_embeds"].shape == (4, EMB)


def test_datalist_partition_and_epoch_shuffle():
    lists = [f"s{i}" for i in range(10)]
    a = DataList(lists, shuffle=True, rank=1, world_size=2, worker_id=0,
                 num_workers=2)
    a.set_epoch(5)
    order = list(range(10))
    random.Random(5).shuffle(order)
    want = [lists[i] for i in order[1::2][0::2]]
    assert [d["src"] for d in a] == want
    b = DataList(["only"], repeat_dataset=True, rank=3, world_size=4)
    it = iter(b)
    assert [next(it)["src"] for _ in range(3)] == ["only"] * 3


def test_chunking_and_filtering():
    random.seed(0)
    wav = np.arange(10, dtype=np.float32)[None] + 1
    a, b = processor.get_random_chunk([wav, wav * 2], 4)
    assert a.shape == (1, 4) and np.array_equal(b, a * 2)
    tiled, = processor.get_random_chunk([wav[:, :3]], 7)
    assert tiled[0].tolist() == [1, 2, 3, 1, 2, 3, 1]
    fixed = next(processor.fix_chunk(iter([{"wav_mix": wav}]), 6))
    assert fixed["wav_mix"].shape == (1, 6)
    kept = list(processor.filter_len(
        iter([{"sample_rate": 4, "wav": wav[:, :3]},
              {"sample_rate": 4, "wav": wav}]),
        min_num_seconds=1, max_num_seconds=2))
    assert len(kept) == 1 and kept[0]["wav"].shape == (1, 8)
    v = norm_embeddings(np.array([[3.0, 4.0]]))
    assert np.allclose(np.linalg.norm(v), np.sqrt(2))


def test_unported_data_options_raise(sets):
    _, tr, _ = sets
    for kw in (dict(online_mix=True), dict(noise_prob=0.5),
               dict(reverb_prob=0.5), dict(noise_enroll_prob=0.5)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Dataset("shard", tr["data"], _dataset_args(), {}, **kw)
    # joint training on enrollment wavs is ported; on fbank features not yet
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Dataset("shard", tr["data"], dict(_dataset_args(), speaker_feat=True),
                {}, joint_training=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train(_config("/nonexistent", tr, tr, model_axis=2))


def test_multi_worker_loader_covers_the_shards(sets):
    """Two spawned workers, each with its own dataset: together they yield
    every mixture of the shard once (one shard: both read it, so here each
    worker yields all three batches)."""
    _, tr, _ = sets
    emb = load_speaker_embeddings(tr["spk_embeds"], tr["utt2spk"])
    workers = [Dataset("shard", tr["data"], {"resample_rate": 16000,
                                             "chunk_len": 4000},
                       emb, state="train", rank=0, world_size=1,
                       worker_id=w, num_workers=2) for w in range(2)]
    loader = MultiWorkerLoader(workers, batch_size=2,
                               collate_fn=tse_collate_fn)
    loader.set_epoch(1)
    keys = sorted(k for b in loader for k in b["key"])
    assert keys == sorted([f"train{i:02d}" for i in range(6)] * 4)
