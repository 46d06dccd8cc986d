"""Port parity: the optimizer chain and the train step against the JAX
package, from the same numpy-seeded parameters, gradients and batch."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from flax import serialization

from wesep_tpu.models.bsrnn import BSRNN as JaxBSRNN
from wesep_tpu.train import trainer as jax_trainer
from wesep_tpu.train.losses import parse_loss as jax_parse_loss
from wesep_tpu.train.schedulers import exponential_decrease as jax_exp
from wesep_tpu_torch.models.bsrnn import BSRNN
from wesep_tpu_torch.train import trainer
from wesep_tpu_torch.train.losses import parse_loss
from wesep_tpu_torch.train.schedulers import exponential_decrease
from wesep_tpu_torch.utils.jax_params import (
    load_jax_params,
    optimizer_state_from_jax,
)

torch.set_num_threads(1)  # one intra-op thread per test worker

SCHED = dict(num_epochs=3, epoch_iter=4, initial_lr=1e-3, final_lr=2.5e-5,
             warm_up_epoch=0)
MODEL_ARGS = dict(sr=16000, win=512, stride=128, feature_dim=16,
                  num_repeat=2, spk_fuse_type="multiply",
                  use_spk_transform=False, multi_fuse=False,
                  joint_training=False, spk_emb_dim=16)


def _chain_inputs():
    """Two named parameters and three gradients each; the second gradient
    of `a.w` has norm far above the clip of 5."""
    rng = np.random.default_rng(0)
    params = {"a": {"w": rng.standard_normal((6, 5)).astype(np.float32)},
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = []
    for scale in (0.3, 40.0, 1.0):
        grads.append({
            "a": {"w": rng.standard_normal((6, 5)).astype(np.float32) * scale},
            "b": rng.standard_normal(7).astype(np.float32) * 0.1})
    return params, grads


def _jax_chain(params, grads, **kw):
    """Run the JAX chain; return the params and the optimizer state after
    every step."""
    tx = jax_trainer.make_optimizer(jax_exp(**SCHED), weight_decay=1e-4,
                                    clip_grad=5.0, **kw)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(p)
    trail = []
    for g in grads:
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, g), opt_state, p)
        p = optax.apply_updates(p, updates)
        trail.append((jax.tree_util.tree_map(np.asarray, p), opt_state))
    return trail


def _port_tensors(params):
    return {"a.w": torch.from_numpy(params["a"]["w"].copy()),
            "b": torch.from_numpy(params["b"].copy())}


def _port_grads(g):
    return {"a.w": torch.from_numpy(g["a"]["w"]), "b": torch.from_numpy(g["b"])}


def test_optimizer_chain_matches_optax():
    """clip per parameter -> + wd * p -> Adam -> * schedule(step), three
    steps: parameters equal to 1e-6 (f32 arithmetic in another order)."""
    params, grads = _chain_inputs()
    trail = _jax_chain(params, grads)
    tensors = _port_tensors(params)
    opt = trainer.make_optimizer(tensors, exponential_decrease(**SCHED),
                                 weight_decay=1e-4, clip_grad=5.0)
    for g, (want, _) in zip(grads, trail):
        opt.update(_port_grads(g))
        np.testing.assert_allclose(tensors["a.w"].numpy(), want["a"]["w"],
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(tensors["b"].numpy(), want["b"],
                                   atol=1e-6, rtol=0)
    assert opt.count == 3


def test_clip_is_per_parameter_not_global():
    g = torch.full((4,), 10.0)  # norm 20 -> scaled to norm 5
    clipped = trainer.per_param_clip(g, 5.0)
    assert abs(clipped.norm().item() - 5.0) < 1e-4
    small = torch.full((4,), 0.1)
    assert torch.equal(trainer.per_param_clip(small, 5.0), small)


def test_optimizer_state_bridge_continues_a_jax_run():
    """The port's third step from the JAX state after two steps lands on
    the JAX package's third step."""
    params, grads = _chain_inputs()
    trail = _jax_chain(params, grads)
    after2, opt_state2 = trail[1]
    tensors = _port_tensors(after2)
    opt = trainer.make_optimizer(tensors, exponential_decrease(**SCHED),
                                 weight_decay=1e-4, clip_grad=5.0)
    bridged = optimizer_state_from_jax(serialization.to_state_dict(opt_state2))
    assert bridged["count"] == 2 and set(bridged["mu"]) == {"a.w", "b"}
    opt.load_state_dict(bridged)
    opt.update(_port_grads(grads[2]))
    want = trail[2][0]
    np.testing.assert_allclose(tensors["a.w"].numpy(), want["a"]["w"],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tensors["b"].numpy(), want["b"],
                               atol=1e-6, rtol=0)
    # and the state round-trips through state_dict
    again = trainer.make_optimizer(_port_tensors(params),
                                   exponential_decrease(**SCHED))
    again.load_state_dict(opt.state_dict())
    assert again.count == 3
    assert torch.equal(again.mu["b"], opt.mu["b"])
    with pytest.raises(ValueError):
        again.load_state_dict({"count": 0, "mu": {}, "nu": {}})


def test_frozen_prefixes_get_no_update_and_no_state():
    params, grads = _chain_inputs()
    trail = _jax_chain(params, grads[:1], freeze_prefixes=("a",))
    tensors = _port_tensors(params)
    opt = trainer.make_optimizer(tensors, exponential_decrease(**SCHED),
                                 weight_decay=1e-4, clip_grad=5.0,
                                 freeze_prefixes=("a",))
    opt.update(_port_grads(grads[0]))
    want, opt_state = trail[0]
    assert set(opt.mu) == {"b"}
    np.testing.assert_array_equal(tensors["a.w"].numpy(), params["a"]["w"])
    np.testing.assert_array_equal(want["a"]["w"], params["a"]["w"])
    np.testing.assert_allclose(tensors["b"].numpy(), want["b"], atol=1e-6)
    bridged = optimizer_state_from_jax(serialization.to_state_dict(opt_state))
    assert set(bridged["mu"]) == {"b"} and bridged["count"] == 1


def test_weighted_loss_table():
    est = [torch.ones(2, 8), torch.zeros(2, 8)]
    ref = torch.full((2, 8), 0.5)
    crit = parse_loss(["L1", "L2"])
    got = trainer.weighted_loss((est, None), ref, None, crit,
                                [[0, 1], [1]], [[1.0, 2.0], [4.0]])
    # L1: 0.5 and 0.5; L2 of output 1: 0.25
    assert abs(float(got) - (0.5 + 2 * 0.5 + 4 * 0.25)) < 1e-6


def _model_and_batch():
    rng = np.random.default_rng(7)
    batch = {
        "wav_mix": rng.standard_normal((2, 2400)).astype(np.float32) * 0.1,
        "wav_targets": rng.standard_normal((2, 2400)).astype(np.float32) * 0.1,
        "spk_embeds": rng.standard_normal((2, 16)).astype(np.float32),
    }
    jmodel = JaxBSRNN(**MODEL_ARGS)
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


def test_two_train_steps_match_jax():
    """The slice as a whole, f32: the same params and the same batch through
    two train steps of both packages.

    Losses: rtol 1e-4. Gradients of the first step: max abs error within
    2e-3 of each parameter's largest gradient (the BiLSTM recurrences and
    the GroupNorm sums run in another order). Parameters after the second
    step: Adam's first steps move every element by about lr * sign(g), so
    an element whose gradient is tiny against its tensor's largest can land
    up to lr away from rounding alone; elements with |g| above 1e-3 of the
    tensor's largest must agree to 5% of lr, all others to 2 * lr."""
    jmodel, params, batch = _model_and_batch()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    criterion = jax_parse_loss("SISDR")
    tx = jax_trainer.make_optimizer(jax_exp(**SCHED), weight_decay=1e-4,
                                    clip_grad=5.0)
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams, batch_stats={},
        opt_state=tx.init(jparams))
    step_fn = jax.jit(jax_trainer.make_train_step(jmodel, tx, criterion))

    def jax_loss(p):
        out = jmodel.apply({"params": p}, jbatch["wav_mix"],
                           jbatch["spk_embeds"], train=True)
        return jax_trainer.weighted_loss(out, jbatch["wav_targets"], None,
                                         criterion, [[0]], [[1.0]])

    want_grads = _flat(jax.jit(jax.grad(jax_loss))(jparams))
    want_losses = []
    for _ in range(2):
        state, metrics = step_fn(state, jbatch)
        want_losses.append(float(metrics["loss"]))
    want_params = _flat(state.params)

    model = load_jax_params(BSRNN(**MODEL_ARGS), params)
    opt = trainer.make_optimizer(model, exponential_decrease(**SCHED),
                                 weight_decay=1e-4, clip_grad=5.0)
    tstate = trainer.TrainState(model=model, optimizer=opt)
    tbatch = trainer.batch_to_device(batch, "cpu")
    train_step = trainer.make_train_step(parse_loss("SISDR"))

    model.train()
    loss = trainer.weighted_loss(
        model(tbatch["wav_mix"], tbatch["spk_embeds"]),
        tbatch["wav_targets"], None, parse_loss("SISDR"), [[0]], [[1.0]])
    names = [n for n, _ in model.named_parameters()]
    got_grads = dict(zip(names, torch.autograd.grad(
        loss, list(model.parameters()))))
    assert set(got_grads) == set(want_grads)
    for name, want in want_grads.items():
        err = np.abs(got_grads[name].numpy() - want).max()
        assert err <= 2e-3 * max(np.abs(want).max(), 1e-8), (name, err)

    got_losses = []
    for _ in range(2):
        tstate, metrics = train_step(tstate, tbatch)
        got_losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    assert tstate.step == 2 and opt.count == 2

    lr = SCHED["initial_lr"]
    for name, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - want_params[name])
        g = np.abs(want_grads[name])
        firm = g > 1e-3 * g.max()
        assert diff[firm].max(initial=0.0) <= 0.05 * lr, name
        assert diff.max() <= 2 * lr, name
    # and the steps did move the parameters
    moved = sum(float(np.abs(p.detach().numpy() - _flat(params)[n]).max())
                for n, p in model.named_parameters())
    assert moved > 0


def test_accum_steps_and_bf16_compute_dtype():
    """accum_steps=2 reproduces the full-batch update for a per-example
    mean loss (atol 1e-6 on parameters after one step), and a bf16 step
    keeps f32 parameters and gives a finite loss near the f32 one."""
    _, params, batch = _model_and_batch()
    tbatch = trainer.batch_to_device(batch, "cpu")

    def run(**kw):
        model = load_jax_params(BSRNN(**MODEL_ARGS), params)
        opt = trainer.make_optimizer(model, exponential_decrease(**SCHED))
        state = trainer.TrainState(model=model, optimizer=opt)
        step = trainer.make_train_step(parse_loss("SISDR"), **kw)
        _, metrics = step(state, tbatch)
        return model, float(metrics["loss"])

    full, loss_full = run()
    accum, loss_accum = run(accum_steps=2)
    assert abs(loss_full - loss_accum) < 1e-4
    for (n, a), (_, b) in zip(full.named_parameters(),
                              accum.named_parameters()):
        firm = (a - b).abs() <= 1e-6
        # elements with near-zero gradients may flip sign of the first
        # Adam step; they are few
        assert firm.float().mean().item() > 0.98, n
    half, loss_bf16 = run(compute_dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in half.parameters())
    assert np.isfinite(loss_bf16) and abs(loss_bf16 - loss_full) < 0.5
    with pytest.raises(ValueError):
        run(accum_steps=3)


def test_unported_options_raise_with_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trainer.make_train_step(parse_loss("SISDR"), ssa_enroll_prob=0.5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trainer.make_train_step(parse_loss("SISDR"), device_augment={})


def test_eval_step_matches_jax():
    jmodel, params, batch = _model_and_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree_util.tree_map(jnp.asarray, params), batch_stats={},
        opt_state=())
    want = float(jax.jit(jax_trainer.make_eval_step(
        jmodel, jax_parse_loss("SISDR")))(state, jbatch)["loss"])
    model = load_jax_params(BSRNN(**MODEL_ARGS), params)
    tstate = trainer.TrainState(model=model, optimizer=None)
    got = trainer.make_eval_step(parse_loss("SISDR"))(
        tstate, trainer.batch_to_device(batch, "cpu"))["loss"]
    assert not model.training
    np.testing.assert_allclose(float(got), want, rtol=1e-4)
