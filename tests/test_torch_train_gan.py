"""Port end to end: wesep_tpu_torch bin/train_gan on the CPU on a tiny shard.

Two epochs of MetricGAN training (a small BSRNN generator, the CMGAN
discriminator at hid_chans 4, the recipes' on-device PESQ metric) through
the port's own entry point: two-model checkpoint bundles with both
optimizer states and D's spectral-norm buffers, the latest/final links, a
resume from checkpoint_1 that restores both models and both optimizers, a
SIGTERM mid-epoch that writes preempt_epoch1.ckpt and a resume from it,
and bin/average_model -> bin/infer on the generator. As in the JAX package,
`compute_dtype` and `model_init` are not read: the config names a bf16
dtype and a model_init file that does not exist, and every generator
forward takes f32 input.
"""

import os
import signal

import numpy as np
import pytest
import torch

from test_torch_train import MODEL_ARGS, _config, _write_set
from wesep_tpu_torch.bin import average_model
from wesep_tpu_torch.bin.infer import infer
from wesep_tpu_torch.bin.train_gan import train_gan
from wesep_tpu_torch.models.bsrnn import BSRNN
from wesep_tpu_torch.train import trainer_gan
from wesep_tpu_torch.train.checkpoint import (
    find_epoch_checkpoints,
    load_checkpoint,
)

torch.set_num_threads(1)  # one intra-op thread per test worker

SCHED = {"final_lr": 1e-3, "initial_lr": 0.003, "warm_from_zero": False,
         "warm_up_epoch": 0}


def _gan_config(root, tr, va, **extra):
    config = _config(
        root, tr, va,
        dataset_args={"resample_rate": 16000, "sample_num_per_epoch": 4,
                      "shuffle": True, "shuffle_args": {"shuffle_size": 4},
                      "chunk_len": 4000},
        model={"tse_model": "BSRNN", "discriminator": "CMGAN_Discriminator"},
        model_args={"tse_model": dict(MODEL_ARGS),
                    "discriminator": {"hid_chans": 4}},
        optimizer={"tse_model": "Adam", "discriminator": "Adam"},
        optimizer_args={"tse_model": {"lr": 0.003, "weight_decay": 1e-4},
                        "discriminator": {"lr": 0.003,
                                          "weight_decay": 1e-4}},
        scheduler={"tse_model": "ExponentialDecrease",
                   "discriminator": "ExponentialDecrease"},
        scheduler_args={"tse_model": dict(SCHED),
                        "discriminator": dict(SCHED, initial_lr=0.002)},
        gan_loss_weight=0.05, gan_metric="pesq", clip_grad=3.0,
        compute_dtype="bfloat16",
        model_init={"tse_model": os.path.join(root, "missing.ckpt"),
                    "discriminator": None})
    config.update(extra)
    return config


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gan_data"))
    rng = np.random.default_rng(0)
    tr = _write_set(root, "train", n_mix=4, n_samples=6000, rng=rng)
    va = _write_set(root, "dev", n_mix=2, n_samples=5000, rng=rng)
    return root, tr, va


@pytest.fixture(scope="module")
def trained(sets, tmp_path_factory):
    """Two epochs of bin/train_gan, recording the generator's input
    dtypes."""
    _, tr, va = sets
    root = str(tmp_path_factory.mktemp("gan_run"))
    config = _gan_config(root, tr, va)
    dtypes = []
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda m, args: dtypes.append(args[0].dtype)
        if isinstance(m, BSRNN) else None)
    try:
        states = train_gan(config)
    finally:
        hook.remove()
    return root, config, states, dtypes


def _log(exp_dir):
    return open(os.path.join(exp_dir, "train.log")).read()


def test_two_epochs_write_two_model_bundles(trained):
    root, config, (g_state, d_state), dtypes = trained
    exp = config["exp_dir"]
    log = _log(exp)
    assert log.count("g_loss") == 2 and "epoch iteration number: 2" in log
    assert g_state.step == d_state.step == 4
    assert g_state.optimizer.count == d_state.optimizer.count == 4
    models = os.path.join(exp, "models")
    assert [e for e, _ in find_epoch_checkpoints(models)] == [1, 2]
    for link in ("latest_checkpoint.ckpt", "final_checkpoint.ckpt"):
        assert os.readlink(os.path.join(models, link)) == "checkpoint_2.ckpt"
    bundle = load_checkpoint(os.path.join(models, "checkpoint_1.ckpt"))
    assert bundle["step"] == 2 and len(bundle["models"]) == 2
    assert [o["count"] for o in bundle["opt_states"]] == [2, 2]
    assert set(bundle["opt_states"][1]["mu"]) == set(bundle["models"][1])
    assert {n for n in bundle["batch_stats"][1] if n.endswith(".u")} == {
        f"conv_{i}.u" for i in range(4)} | {"fc_0.u", "fc_final.u"}
    # compute_dtype and model_init are not read: every generator forward
    # (GAN steps, validation) took f32, and the missing file was not opened
    assert dtypes and set(dtypes) == {torch.float32}
    assert not os.path.exists(config["model_init"]["tse_model"])
    assert "Load initial model" not in log


def test_resume_restores_both_models_and_optimizers(trained, sets):
    root, config, _, _ = trained
    ckpt = os.path.join(config["exp_dir"], "models", "checkpoint_1.ckpt")
    exp = os.path.join(root, "exp_resume")
    # one step of epoch 2, then compare with what was restored
    seen = {}
    real = trainer_gan.make_gan_train_step

    def spy(*args, **kw):
        step = real(*args, **kw)

        def first(states, batch):
            if not seen:
                seen.update(
                    {f"{tag}_{n}": p.detach().clone() for tag, st in
                     zip("gd", states)
                     for n, p in st.model.state_dict().items()},
                    g_count=states[0].optimizer.count,
                    d_count=states[1].optimizer.count,
                    d_mu={n: t.clone() for n, t in
                          states[1].optimizer.mu.items()})
            return step(states, batch)

        return first

    trainer_gan.make_gan_train_step = spy
    try:
        g_state, d_state = train_gan(dict(config, exp_dir=exp),
                                     checkpoint=ckpt)
    finally:
        trainer_gan.make_gan_train_step = real
    assert "start_epoch: 2" in _log(exp)
    assert g_state.step == d_state.step == 4
    bundle = load_checkpoint(ckpt)
    assert seen["g_count"] == seen["d_count"] == 2
    for i, tag in enumerate("gd"):
        for name, v in bundle["models"][i].items():
            assert torch.equal(seen[f"{tag}_{name}"], v), (tag, name)
        for name, v in bundle["batch_stats"][i].items():
            assert torch.equal(seen[f"{tag}_{name}"], v), (tag, name)
    for name, v in bundle["opt_states"][1]["mu"].items():
        assert torch.equal(seen["d_mu"][name], v), name


def test_sigterm_writes_a_resumable_preempt_bundle(sets, tmp_path):
    """SIGTERM's handler (called as the signal would call it) after the
    first GAN step: the epoch ends, preempt_epoch1.ckpt holds both models
    after one step, and a resume redoes epoch 1 from it."""
    _, tr, va = sets
    config = _gan_config(str(tmp_path), tr, va, num_epochs=1)
    real = trainer_gan.make_gan_train_step

    def preempting(*args, **kw):
        step = real(*args, **kw)

        def once(states, batch):
            out = step(states, batch)
            handler = signal.getsignal(signal.SIGTERM)
            assert callable(handler)
            handler(signal.SIGTERM, None)
            return out

        return once

    before = signal.getsignal(signal.SIGTERM)
    trainer_gan.make_gan_train_step = preempting
    try:
        g_state, _ = train_gan(config)
    finally:
        trainer_gan.make_gan_train_step = real
    assert signal.getsignal(signal.SIGTERM) is before  # handler restored
    models = os.path.join(config["exp_dir"], "models")
    preempt = os.path.join(models, "preempt_epoch1.ckpt")
    bundle = load_checkpoint(preempt)
    assert g_state.step == bundle["step"] == 1
    assert [o["count"] for o in bundle["opt_states"]] == [1, 1]
    assert not find_epoch_checkpoints(models)
    assert "preempted during epoch 1" in _log(config["exp_dir"])
    g_state, d_state = train_gan(
        dict(config, exp_dir=str(tmp_path / "exp_resumed")),
        checkpoint=preempt)
    assert g_state.step == d_state.step == 3  # epoch 1 again: 1 + 2


def test_average_model_then_infer_decodes_the_generator(trained, sets):
    root, config, _, _ = trained
    _, _, va = sets
    models = os.path.join(config["exp_dir"], "models")
    dst = os.path.join(root, "avg_model.ckpt")
    average_model.main(["--dst_model", dst, "--src_path", models,
                        "--num", "2"])
    avg = load_checkpoint(dst)
    one = load_checkpoint(os.path.join(models, "checkpoint_1.ckpt"))
    two = load_checkpoint(os.path.join(models, "checkpoint_2.ckpt"))
    assert set(avg["models"][0]) == set(one["models"][0])
    for k, v in avg["models"][0].items():
        torch.testing.assert_close(
            v, (one["models"][0][k] + two["models"][0][k]) / 2)
    sisnr, sisnri = infer(
        {"model": {"tse_model": "BSRNN"},
         "model_args": {"tse_model": dict(MODEL_ARGS)},
         "data_type": "shard", "dataset_args": {"resample_rate": 16000}},
        checkpoint=dst, exp_dir=os.path.join(root, "exp_infer"),
        device="cpu", save_wav=False, length_bucket=2000,
        test_data=va["data"], test_spk_embeds=va["spk_embeds"],
        test_spk1_enroll=va["spk1_enroll"],
        test_spk2_enroll=va["spk2_enroll"])
    assert np.isfinite(sisnr) and np.isfinite(sisnri)


def test_several_devices_raise(sets, monkeypatch):
    _, tr, va = sets
    with pytest.raises(NotImplementedError, match="data parallelism"):
        train_gan(_gan_config("/nonexistent", tr, va, model_axis=2))
    monkeypatch.setenv("WESEP_DIST", "1")
    with pytest.raises(NotImplementedError, match="data parallelism"):
        train_gan(_gan_config("/nonexistent", tr, va))


@pytest.mark.parametrize("name, epoch", [
    ("exp/models/checkpoint_3.ckpt", 4),
    ("exp/models/preempt_epoch2.ckpt", 2),
    ("exp/models/avg_model.ckpt", 1),
])
def test_resume_epoch_from_the_bundle_name(name, epoch):
    """bin/train and bin/train_gan resume after checkpoint_<N> at N + 1
    and redo the interrupted epoch N of preempt_epoch<N>."""
    from wesep_tpu_torch.bin.train import resume_epoch

    assert resume_epoch(name) == epoch
