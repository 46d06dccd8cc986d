"""Port parity: training TF-GridNet (v1, pre-extracted embeddings).

Two whole train steps and an eval step against the JAX package's
`make_train_step` / `make_eval_step` from the same numpy-seeded parameters
and batch, on both routes of WESEP_LSTM_UNFOLD; a bf16 step; and the port's
bin/train (two short epochs on the unfold-fused route), bin/average_model
and bin/infer on a tiny shard on the CPU, where every kernel runs its plain
version.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_train import _config, _epoch_losses, _write_set
from wesep_tpu.models.tfgridnet import TFGridNet as JaxTFGridNet
from wesep_tpu.train import trainer as jax_trainer
from wesep_tpu.train.losses import parse_loss as jax_parse_loss
from wesep_tpu.train.schedulers import exponential_decrease as jax_exp
from wesep_tpu_torch.bin import average_model
from wesep_tpu_torch.bin.infer import infer
from wesep_tpu_torch.bin.train import train
from wesep_tpu_torch.models.tfgridnet import TFGridNet
from wesep_tpu_torch.train import trainer
from wesep_tpu_torch.train.checkpoint import find_epoch_checkpoints
from wesep_tpu_torch.train.losses import parse_loss
from wesep_tpu_torch.train.schedulers import exponential_decrease
from wesep_tpu_torch.utils.jax_params import load_jax_params

torch.set_num_threads(1)  # one intra-op thread per test worker

SCHED = dict(num_epochs=3, epoch_iter=4, initial_lr=1e-3, final_lr=2.5e-5,
             warm_up_epoch=0)
# parameters whose true gradient is zero, so that both packages return
# rounding noise: the keys' norm bias adds one logit to every key of a
# query, which the softmax cancels; the real part of the deconv bias is a
# constant spectrum, an impulse at the first sample of each frame, where
# the periodic Hann window is 0
NOISE_ONLY = ("attn_norm_K_bias", "deconv.bias")
# test_torch_train's shards carry 16-d embeddings
MODEL_ARGS = dict(n_fft=32, stride=16, n_layers=2, lstm_hidden_units=16,
                  attn_n_head=2, attn_approx_qk_dim=32, emb_dim=8, emb_ks=4,
                  emb_hs=1, spk_emb_dim=16, spk_fuse_type="multiply",
                  joint_training=False)


def _model_and_batch():
    rng = np.random.default_rng(11)
    batch = {
        "wav_mix": rng.standard_normal((2, 1200)).astype(np.float32) * 0.1,
        "wav_targets": rng.standard_normal((2, 1200)).astype(np.float32) * 0.1,
        "spk_embeds": rng.standard_normal((2, 16)).astype(np.float32),
    }
    jmodel = JaxTFGridNet(**MODEL_ARGS)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batch["wav_mix"]),
                         jnp.asarray(batch["spk_embeds"]),
                         train=False)["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.standard_normal(p.shape).astype(
            np.float32) * 0.05, params)
    return jmodel, params, batch


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_run():
    """Gradients of the first step, two steps' losses and the parameters
    after them, from the JAX package."""
    jmodel, params, batch = _model_and_batch()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    criterion = jax_parse_loss("SISDR")
    tx = jax_trainer.make_optimizer(jax_exp(**SCHED), weight_decay=1e-4,
                                    clip_grad=5.0)
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams, batch_stats={},
        opt_state=tx.init(jparams))

    def jax_loss(p):
        out = jmodel.apply({"params": p}, jbatch["wav_mix"],
                           jbatch["spk_embeds"], train=True)
        return jax_trainer.weighted_loss(out, jbatch["wav_targets"], None,
                                         criterion, [[0]], [[1.0]])

    grads = _flat(jax.jit(jax.grad(jax_loss))(jparams))
    step_fn = jax.jit(jax_trainer.make_train_step(jmodel, tx, criterion))
    losses = []
    for _ in range(2):
        state, metrics = step_fn(state, jbatch)
        losses.append(float(metrics["loss"]))
    eval_loss = float(jax.jit(jax_trainer.make_eval_step(jmodel, criterion))(
        state, jbatch)["loss"])
    return params, batch, grads, losses, _flat(state.params), eval_loss


@pytest.mark.parametrize("route", ["1", "0"])
def test_two_train_steps_match_jax(monkeypatch, jax_run, route):
    """f32, both routes of WESEP_LSTM_UNFOLD. Gradients of the first step:
    max abs error within 1e-3 of each parameter's largest gradient (the
    BiLSTM recurrences, norms and attention sums run in another order;
    the NOISE_ONLY gradients within 1e-3 of the model's largest).
    Losses of two steps and the eval loss after them: rtol 1e-4.
    Parameters after the second step as in test_torch_trainer: elements
    with |g| above 1e-3 of the tensor's largest agree to 5% of lr, all
    others to 2 * lr (Adam's first steps are about lr * sign(g)); a
    NOISE_ONLY leaf, which each package moves by at most lr per step in a
    direction set by rounding, to 4 * lr."""
    monkeypatch.setenv("WESEP_LSTM_UNFOLD", route)
    params, batch, want_grads, want_losses, want_params, want_eval = jax_run
    model = load_jax_params(TFGridNet(**MODEL_ARGS), params)
    tbatch = trainer.batch_to_device(batch, "cpu")

    model.train()
    loss = trainer.weighted_loss(
        model(tbatch["wav_mix"], tbatch["spk_embeds"]),
        tbatch["wav_targets"], None, parse_loss("SISDR"), [[0]], [[1.0]])
    names = [n for n, _ in model.named_parameters()]
    got_grads = dict(zip(names, torch.autograd.grad(
        loss, list(model.parameters()))))
    assert set(got_grads) == set(want_grads)
    largest = max(np.abs(g).max() for g in want_grads.values())
    for name, want in want_grads.items():
        err = np.abs(got_grads[name].numpy() - want).max()
        scale = largest if name.endswith(NOISE_ONLY) else np.abs(want).max()
        assert err <= 1e-3 * scale, (name, err)

    opt = trainer.make_optimizer(model, exponential_decrease(**SCHED),
                                 weight_decay=1e-4, clip_grad=5.0)
    tstate = trainer.TrainState(model=model, optimizer=opt)
    train_step = trainer.make_train_step(parse_loss("SISDR"))
    got_losses = [float(train_step(tstate, tbatch)[1]["loss"])
                  for _ in range(2)]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    lr = SCHED["initial_lr"]
    for name, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - want_params[name])
        if name.endswith(NOISE_ONLY):
            assert diff.max() <= 4 * lr, name
            continue
        g = np.abs(want_grads[name])
        firm = g > 1e-3 * g.max()
        assert diff[firm].max(initial=0.0) <= 0.05 * lr, name
        assert diff.max() <= 2 * lr, name
    got_eval = trainer.make_eval_step(parse_loss("SISDR"))(tstate, tbatch)
    np.testing.assert_allclose(float(got_eval["loss"]), want_eval, rtol=1e-4)


def test_bf16_step_keeps_f32_parameters(jax_run):
    """A bf16 compute step (the recipe's) gives f32 gradients and
    parameters and a finite loss near the f32 one."""
    params, batch, _, want_losses, _, _ = jax_run
    model = load_jax_params(TFGridNet(**MODEL_ARGS), params)
    opt = trainer.make_optimizer(model, exponential_decrease(**SCHED))
    state = trainer.TrainState(model=model, optimizer=opt)
    step = trainer.make_train_step(parse_loss("SISDR"),
                                   compute_dtype=torch.bfloat16)
    _, metrics = step(state, trainer.batch_to_device(batch, "cpu"))
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and abs(loss - want_losses[0]) < 0.5
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two short epochs of bin/train on the unfold-fused route."""
    root = str(tmp_path_factory.mktemp("tfgridnet_train"))
    rng = np.random.default_rng(0)
    tr = _write_set(root, "train", n_mix=4, n_samples=3200, rng=rng)
    va = _write_set(root, "dev", n_mix=2, n_samples=3200, rng=rng)
    config = _config(
        root, tr, va, model={"tse_model": "TFGridNet"},
        model_args={"tse_model": dict(MODEL_ARGS)},
        dataset_args={"resample_rate": 16000, "sample_num_per_epoch": 4,
                      "shuffle": True, "shuffle_args": {"shuffle_size": 4},
                      "chunk_len": 1600})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WESEP_LSTM_UNFOLD", "1")
        state = train(config)
    return root, config, va, state


def test_train_average_and_infer(trained):
    root, config, va, state = trained
    exp = config["exp_dir"]
    losses = _epoch_losses(exp)
    assert [e for e, _, _ in losses] == [1, 2]
    assert all(np.isfinite([t, v]).all() for _, t, v in losses)
    assert state.step == 4 and state.optimizer.count == 4
    models = os.path.join(exp, "models")
    assert [e for e, _ in find_epoch_checkpoints(models)] == [1, 2]
    dst = os.path.join(root, "avg_model.ckpt")
    average_model.main(["--dst_model", dst, "--src_path", models,
                        "--num", "2"])
    sisnr, sisnri = infer(
        {"model": config["model"], "model_args": config["model_args"],
         "data_type": "shard", "dataset_args": {"resample_rate": 16000}},
        checkpoint=dst, exp_dir=os.path.join(root, "exp_infer"),
        device="cpu", save_wav=False, length_bucket=2000,
        test_data=va["data"], test_spk_embeds=va["spk_embeds"],
        test_spk1_enroll=va["spk1_enroll"],
        test_spk2_enroll=va["spk2_enroll"])
    assert np.isfinite(sisnr) and np.isfinite(sisnri)


def test_joint_training_raises_with_its_roadmap_item(tmp_path):
    rng = np.random.default_rng(1)
    tr = _write_set(str(tmp_path), "train", n_mix=2, n_samples=1600, rng=rng)
    config = _config(str(tmp_path), tr, tr, model={"tse_model": "TFGridNet"},
                     model_args={"tse_model": dict(
                         MODEL_ARGS, joint_training=True,
                         spk_model="ResNet34")})
    with pytest.raises(NotImplementedError, match="queue A item 4"):
        train(config)
