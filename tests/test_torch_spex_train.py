"""Port parity: joint training of SpEx+ (ConvTasNet) end to end.

The joint data chain (enrollment wavs and speaker labels) batch for batch
against wesep_tpu.data; two whole multi-task train steps and an eval step
against the JAX package's, from the same parameters, BatchNorm statistics
and batch; and the port's bin/train (two short epochs, resume),
bin/average_model and bin/infer on a tiny shard on the CPU.
"""

import io
import json
import os
import random
import re
import tarfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wesep_tpu.data import BatchLoader as JaxBatchLoader
from wesep_tpu.data import Dataset as JaxDataset
from wesep_tpu.data import tse_collate_fn as jax_collate
from wesep_tpu.models import get_model as jax_get_model
from wesep_tpu.train import trainer as jax_trainer
from wesep_tpu.train.losses import parse_loss as jax_parse_loss
from wesep_tpu.train.schedulers import exponential_decrease as jax_exp
from wesep_tpu_torch.bin import average_model
from wesep_tpu_torch.bin.infer import infer
from wesep_tpu_torch.bin.train import load_enroll_maps, train
from wesep_tpu_torch.data import BatchLoader, Dataset, tse_collate_fn
from wesep_tpu_torch.data import processor
from wesep_tpu_torch.data.wav_io import wav_bytes, write_wav
from wesep_tpu_torch.models.convtasnet import ConvTasNet
from wesep_tpu_torch.train import trainer
from wesep_tpu_torch.train.checkpoint import (
    find_epoch_checkpoints,
    load_checkpoint,
    model_state,
)
from wesep_tpu_torch.train.losses import parse_loss
from wesep_tpu_torch.train.schedulers import exponential_decrease
from wesep_tpu_torch.utils.jax_params import (
    convtasnet_state_dict_from_jax,
    load_jax_params,
)

torch.set_num_threads(1)  # one intra-op thread per test worker

SPEAKERS = {"spkA": 110.0, "spkB": 170.0, "spkC": 230.0}
ENROLL_LEN = 4000
MODEL_ARGS = dict(N=16, L=20, B=16, H=32, P=3, X=2, R=1, spk_emb_dim=8,
                  norm="gLN", causal=False, skip_con=False,
                  spk_fuse_type="concatConv", multi_fuse=True,
                  encoder_type="Multi", decoder_type="Multi",
                  joint_training=True, multi_task=True, spks_in_train=3)
LOSS = dict(loss=["SISDR", "CE"],
            loss_args={"loss_posi": [[0, 1, 2], [3]],
                       "loss_weight": [[0.8, 0.1, 0.1], [0.5]]})
SCHED = dict(num_epochs=2, epoch_iter=6, initial_lr=1e-3, final_lr=2.5e-5,
             warm_up_epoch=0)


def _voice(rng, f0, n):
    t = np.arange(n) / 16000.0
    s = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6)) / k
            for k in range(1, 4))
    return (0.1 * s + 0.005 * rng.standard_normal(n)).astype(np.float32)


def _write_set(root, name, n_mix, n_samples, rng):
    """One premixed shard `name`.tar with its list and utt2spk, two
    enrollment wavs per speaker (one shorter, one longer than ENROLL_LEN),
    spk2enroll.json, the utt -> wav scp and the enrollment lists."""
    os.makedirs(os.path.join(root, "enroll"), exist_ok=True)
    spk2enroll, utt2wav, utt2spk = {}, {}, {}
    for spk, f0 in SPEAKERS.items():
        for u, n in enumerate((3000, 5000)):
            utt = f"{name}_{spk}_u{u}"
            path = os.path.join(root, "enroll", utt + ".wav")
            write_wav(path, _voice(rng, f0, n), 16000)
            spk2enroll.setdefault(spk, []).append([utt, path])
            utt2wav[utt], utt2spk[utt] = path, spk
    paths = {k: os.path.join(root, f"{name}.{k}") for k in (
        "list", "utt2spk", "spk2enroll.json", "enroll_wav.scp",
        "spk1_enroll", "spk2_enroll")}
    with open(paths["spk2enroll.json"], "w") as f:
        json.dump(spk2enroll, f)
    with open(paths["enroll_wav.scp"], "w") as f:
        f.writelines(f"{u} {p}\n" for u, p in utt2wav.items())
    with open(paths["utt2spk"], "w") as f:
        f.writelines(f"{u} {s}\n" for u, s in utt2spk.items())
    names = sorted(SPEAKERS)
    keys, pairs = [], []
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
    with open(paths["list"], "w") as f:
        f.write(tar_path + "\n")
    for i in (0, 1):
        with open(paths[f"spk{i + 1}_enroll"], "w") as f:
            f.writelines(f"{k} {name}_{p[i]}_u{i}\n"
                         for k, p in zip(keys, pairs))
    return paths


def _config(root, tr, va, **extra):
    config = {
        "device": "cpu",
        "exp_dir": os.path.join(root, "exp"),
        "data_type": "shard",
        "train_data": tr["list"], "train_utt2spk": tr["utt2spk"],
        "train_spk2utt": tr["spk2enroll.json"],
        "val_data": va["list"], "val_spk2utt": va["enroll_wav.scp"],
        "val_spk1_enroll": va["spk1_enroll"],
        "val_spk2_enroll": va["spk2_enroll"],
        "dataloader_args": {"batch_size": 2, "prefetch_factor": 2},
        "dataset_args": {"resample_rate": 16000, "sample_num_per_epoch": 12,
                         "shuffle": True,
                         "shuffle_args": {"shuffle_size": 4},
                         "chunk_len": 2000, "speaker_feat": False,
                         "enroll_sec": ENROLL_LEN / 16000},
        "model": {"tse_model": "ConvTasNet"},
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
        "seed": 42, **LOSS,
    }
    config.update(extra)
    return config


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spex_data"))
    rng = np.random.default_rng(0)
    tr = _write_set(root, "train", n_mix=6, n_samples=4000, rng=rng)
    va = _write_set(root, "dev", n_mix=4, n_samples=3000, rng=rng)
    return root, tr, va


@pytest.fixture(scope="module")
def trained(sets, tmp_path_factory):
    """Two epochs of bin/train on the CPU."""
    _, tr, va = sets
    root = str(tmp_path_factory.mktemp("spex_run"))
    config = _config(root, tr, va)
    return root, config, train(config)


# --- the joint data chain ------------------------------------------------


@pytest.mark.parametrize("state", ["train", "val"])
def test_joint_chain_yields_the_same_batches_as_the_jax_package(sets, state):
    """Same lists, same `random` seed: both chains draw the same chunks,
    the same enrollment wavs (wrapped or trimmed to one length) and the
    same speaker labels, batch by batch."""
    _, tr, va = sets
    maps = load_enroll_maps(_config("", tr, va), True, True)
    tr_map, dict_spk, n_utts, val_map, val1, val2 = maps
    assert dict_spk == {"spkA": 0, "spkB": 1, "spkC": 2} and n_utts == 6
    dataset_args = {"resample_rate": 16000, "shuffle": True,
                    "shuffle_args": {"shuffle_size": 4}, "chunk_len": 2000}
    if state == "train":
        args = (tr["list"], dataset_args, tr_map, None, None)
    else:
        args = (va["list"], dataset_args, val_map, val1, val2)

    def batches(dataset_fn, loader_fn, collate):
        ds = dataset_fn("shard", *args, state=state, joint_training=True,
                        dict_spk=dict_spk, repeat_dataset=True, rank=0,
                        world_size=1)
        loader = loader_fn(
            ds, batch_size=2, prefetch=0,
            collate_fn=lambda b: collate(b, fixed_enroll_len=ENROLL_LEN))
        loader.set_epoch(3)
        random.seed(11)
        out = []
        for i, b in enumerate(loader):
            out.append(b)
            if i == 4:
                break
        return out

    want = batches(JaxDataset, JaxBatchLoader, jax_collate)
    got = batches(Dataset, BatchLoader, tse_collate_fn)
    lengths = set()
    for g, w in zip(got, want):
        assert g["key"] == w["key"] and g["spk"] == w["spk"]
        assert g["length_spk_embeds"] == w["length_spk_embeds"]
        lengths.update(g["length_spk_embeds"])
        for k in ("wav_mix", "wav_targets", "spk_embeds", "spk_label"):
            np.testing.assert_array_equal(g[k], w[k])
            assert g[k].dtype == w[k].dtype
        assert g["wav_mix"].shape == (4, 2000)
        assert g["spk_embeds"].shape == (4, ENROLL_LEN)
        assert g["spk_label"].tolist() == [dict_spk[s] for s in g["spk"]]
    assert lengths == {3000, 5000}  # both the wrap and the trim were used


def test_spk_to_id_and_unported_options(tmp_path):
    out = list(processor.spk_to_id(
        iter([{"spk": "b"}, {"spk": "zz"}]), {"a": 0, "b": 1}))
    assert [s["label"] for s in out] == [1, -1]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Dataset("shard", __file__, {"speaker_feat": True},
                joint_training=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ConvTasNet(**dict(MODEL_ARGS, spk_feat=True))
    with pytest.raises(NotImplementedError, match="queue A"):
        train({"model": {"tse_model": "BSRNN"}, "exp_dir": str(tmp_path),
               "model_args": {"tse_model": {"joint_training": True}}},
              device="cpu")


# --- the train and eval steps ---------------------------------------------


def _model_and_batch(seed=0):
    rng = np.random.default_rng(seed)
    batch = {
        "wav_mix": (rng.standard_normal((4, 2000)) * 0.1).astype(np.float32),
        "wav_targets": (rng.standard_normal((4, 2000)) * 0.1)
        .astype(np.float32),
        "spk_embeds": (rng.standard_normal((4, 1500)) * 0.1)
        .astype(np.float32),
        "spk_label": np.asarray([0, 2, 1, 2], np.int32),
    }
    model = jax_get_model("ConvTasNet")(**MODEL_ARGS)
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.asarray(batch["wav_mix"]),
                           jnp.asarray(batch["spk_embeds"]), train=True)
    return model, variables, batch


def _flat(tree):
    return {k: v.numpy()
            for k, v in convtasnet_state_dict_from_jax(tree).items()}


def test_two_multi_task_train_steps_match_jax(monkeypatch):
    """Two steps with the recipe's loss table ([SISDR, CE] at positions
    [[0, 1, 2], [3]]), f32, the JAX blocks through the Pallas kernel.

    Losses: rtol 1e-4. BatchNorm statistics: 1e-5 of the largest after the
    first step; after the second, whose batch statistics see the first
    update's parameters (below), 2e-3. Parameters after the second step: Adam's first steps move an
    element by about lr * sign(g), so elements whose gradient is above 1e-3
    of the tensor's largest must agree to 10 % of lr (the kernels in front of a BatchNorm have
    small gradients that are differences of large terms), all others to
    2 * lr.
    The decoders' biases are among the others: they shift the estimate by a
    constant, which the zero-mean SI-SDR does not see, so their gradient
    is rounding noise (1e-5 against a loss of order 10)."""
    monkeypatch.setenv("WESEP_TCN_PALLAS", "force")
    jmodel, variables, batch = _model_and_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    criterion = jax_parse_loss(LOSS["loss"])
    table = LOSS["loss_args"]
    tx = jax_trainer.make_optimizer(jax_exp(**SCHED), weight_decay=1e-4,
                                    clip_grad=5.0)
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]))
    step_fn = jax.jit(jax_trainer.make_train_step(
        jmodel, tx, criterion, table["loss_posi"], table["loss_weight"],
        multi_task=True))

    def jax_loss(p):
        out, _ = jmodel.apply(
            {"params": p, "batch_stats": variables["batch_stats"]},
            jbatch["wav_mix"], jbatch["spk_embeds"], train=True,
            mutable=["batch_stats"])
        return jax_trainer.weighted_loss(
            out, jbatch["wav_targets"], jbatch["spk_label"], criterion,
            table["loss_posi"], table["loss_weight"], True)

    want_grads = _flat(jax.jit(jax.grad(jax_loss))(variables["params"]))
    want_losses, want_stats = [], []
    for _ in range(2):
        state, metrics = step_fn(state, jbatch)
        want_losses.append(float(metrics["loss"]))
        want_stats.append(_flat(state.batch_stats))
    want_params = _flat(state.params)

    model = load_jax_params(ConvTasNet(**MODEL_ARGS), variables["params"],
                            variables["batch_stats"])
    opt = trainer.make_optimizer(model, exponential_decrease(**SCHED),
                                 weight_decay=1e-4, clip_grad=5.0)
    tstate = trainer.TrainState(model=model, optimizer=opt)
    tbatch = trainer.batch_to_device(batch, "cpu")
    train_step = trainer.make_train_step(
        parse_loss(LOSS["loss"]), table["loss_posi"], table["loss_weight"],
        multi_task=True)
    got_losses = []
    for want, limit in zip(want_stats, (1e-5, 2e-3)):
        tstate, metrics = train_step(tstate, tbatch)
        got_losses.append(float(metrics["loss"]))
        got = dict(model.named_buffers())
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                       atol=limit * np.abs(w).max(),
                                       err_msg=name)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    assert tstate.step == 2 and opt.count == 2 and model.training

    got = {k: v.detach().numpy() for k, v in model.named_parameters()}
    assert set(got) == set(want_params)
    lr = SCHED["initial_lr"]
    for name, want in want_params.items():
        diff = np.abs(got[name] - want)
        g = np.abs(want_grads[name])
        firm = g > 1e-3 * g.max()
        if re.fullmatch(r"dec_\d\.ConvTranspose_0\.bias", name):
            firm[:] = False
        assert diff[firm].max(initial=0.0) <= 0.1 * lr, name
        assert diff.max() <= 2 * lr, name


def test_eval_step_matches_jax_and_freezes_the_statistics(monkeypatch):
    monkeypatch.setenv("WESEP_TCN_PALLAS", "force")
    jmodel, variables, batch = _model_and_batch(seed=1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=())
    want = float(jax.jit(jax_trainer.make_eval_step(
        jmodel, jax_parse_loss(LOSS["loss"])))(state, jbatch)["loss"])
    model = load_jax_params(ConvTasNet(**MODEL_ARGS), variables["params"],
                            variables["batch_stats"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = trainer.make_eval_step(parse_loss(LOSS["loss"]))(
        trainer.TrainState(model=model, optimizer=None),
        trainer.batch_to_device(batch, "cpu"))["loss"]
    np.testing.assert_allclose(float(got), want, rtol=1e-4)
    assert not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_accum_steps_thread_the_batchnorm_statistics():
    """accum_steps=2: one update, and the running statistics move once per
    microbatch, in order, as the JAX step's scan threads them."""
    _, variables, batch = _model_and_batch(seed=2)
    tbatch = trainer.batch_to_device(batch, "cpu")

    def fresh():
        return load_jax_params(ConvTasNet(**MODEL_ARGS), variables["params"],
                               variables["batch_stats"])

    model = fresh()
    opt = trainer.make_optimizer(model, exponential_decrease(**SCHED))
    state = trainer.TrainState(model=model, optimizer=opt)
    step = trainer.make_train_step(
        parse_loss(LOSS["loss"]), LOSS["loss_args"]["loss_posi"],
        LOSS["loss_args"]["loss_weight"], multi_task=True, accum_steps=2)
    state, metrics = step(state, tbatch)
    assert state.step == 1 and opt.count == 1
    assert np.isfinite(float(metrics["loss"]))
    twice = fresh().train()
    with torch.no_grad():
        for half in (slice(0, 2), slice(2, 4)):
            twice(tbatch["wav_mix"][half], tbatch["spk_embeds"][half])
    for (name, got), (_, want) in zip(model.named_buffers(),
                                      twice.named_buffers()):
        torch.testing.assert_close(got, want, msg=name)


# --- the entry points -----------------------------------------------------


def _epoch_losses(exp_dir):
    text = open(os.path.join(exp_dir, "train.log")).read()
    return [(int(e), float(t), float(v)) for e, t, v in re.findall(
        r"Epoch (\d+) train_loss (-?[\d.]+) val_loss (-?[\d.]+)", text)]


def test_train_two_epochs_and_checkpoints(trained):
    root, config, state = trained
    exp = config["exp_dir"]
    losses = _epoch_losses(exp)
    assert [e for e, _, _ in losses] == [1, 2]
    assert all(np.isfinite([t, v]).all() for _, t, v in losses)
    assert losses[1][1] < losses[0][1]  # the train loss falls
    models = os.path.join(exp, "models")
    assert [e for e, _ in find_epoch_checkpoints(models)] == [1, 2]
    assert os.readlink(os.path.join(models, "final_checkpoint.ckpt")) \
        == "checkpoint_2.ckpt"
    assert state.step == 12 and state.optimizer.count == 12
    bundle = load_checkpoint(os.path.join(models, "checkpoint_1.ckpt"))
    assert bundle["step"] == 6
    # parameters and BatchNorm statistics apart, as the JAX bundle has them
    assert set(bundle["opt_states"][0]["mu"]) == set(bundle["models"][0])
    stats = bundle["batch_stats"][0]
    assert len(stats) == 12 and all(
        k.endswith((".mean", ".var")) for k in stats)
    assert any(v.abs().max() > 0 for k, v in stats.items()
               if k.endswith(".mean"))  # they moved from their initial 0
    assert set(model_state(bundle)) == set(state.model.state_dict())


def test_resume_restores_the_batchnorm_statistics(trained):
    root, config, _ = trained
    ckpt = os.path.join(config["exp_dir"], "models", "checkpoint_1.ckpt")
    resumed_cfg = dict(config, exp_dir=os.path.join(root, "exp_resume"),
                       num_epochs=1)
    # num_epochs 1 < start_epoch 2: the run restores and trains nothing
    resumed = train(resumed_cfg, checkpoint=ckpt)
    assert resumed.step == 6 and resumed.optimizer.count == 6
    want = model_state(load_checkpoint(ckpt))
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v.cpu(), want[k]), k
    log = open(os.path.join(resumed_cfg["exp_dir"], "train.log")).read()
    assert "start_epoch: 2" in log


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
    # the statistics are the newest checkpoint's, as in the JAX package
    for k, v in avg["batch_stats"][0].items():
        assert torch.equal(v, two["batch_stats"][0][k]), k
    exp = os.path.join(root, "exp_infer")
    sisnr, sisnri = infer(
        {"model": config["model"], "model_args": config["model_args"],
         "data_type": "shard",
         "dataset_args": {"resample_rate": 16000,
                          "enroll_sec": ENROLL_LEN / 16000}},
        checkpoint=dst, exp_dir=exp, device="cpu", length_bucket=1000,
        test_data=va["list"], test_spk2utt=va["enroll_wav.scp"],
        test_spk1_enroll=va["spk1_enroll"],
        test_spk2_enroll=va["spk2_enroll"])
    assert np.isfinite(sisnr) and np.isfinite(sisnri)
    wavs = [n for n in os.listdir(os.path.join(exp, "audio"))
            if n.endswith(".wav")]
    assert len(wavs) == 8  # 4 mixtures x 2 targets
