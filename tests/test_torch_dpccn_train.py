"""Port parity: training DPCCN (v1, pre-extracted embeddings).

Two whole train steps and an eval step against the JAX package's
`make_train_step` / `make_eval_step` from the same numpy-seeded parameters
and batch, at the recipe's widths with a shallow TCN, with the port on both
routes of `conv_impl`: "pallas" (the plain versions of K5/K5b in 7 blocks)
and "xla". The reference is the JAX model's "xla" route: its Pallas route
runs the kernel in interpret mode, which made this fixture take 171 s
instead of 42 s, and the two JAX routes agree to 2e-4 of the output
(tests/test_pallas_conv2d.py), while tests/test_torch_conv2d.py holds the
fused block and its gradients to the Pallas kernel itself. Then a bf16
step, and the port's bin/train (two short epochs on the fused-block route),
bin/average_model and bin/infer on a tiny shard on the CPU.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_train import _config, _epoch_losses, _write_set
from wesep_tpu.models.dpccn import DPCCN as JaxDPCCN
from wesep_tpu.train import trainer as jax_trainer
from wesep_tpu.train.losses import parse_loss as jax_parse_loss
from wesep_tpu.train.schedulers import exponential_decrease as jax_exp
from wesep_tpu_torch.bin import average_model
from wesep_tpu_torch.bin.infer import infer
from wesep_tpu_torch.bin.train import train
from wesep_tpu_torch.models.dpccn import DPCCN
from wesep_tpu_torch.train import trainer
from wesep_tpu_torch.train.checkpoint import find_epoch_checkpoints
from wesep_tpu_torch.train.losses import parse_loss
from wesep_tpu_torch.train.schedulers import exponential_decrease
from wesep_tpu_torch.utils.jax_params import load_jax_params

torch.set_num_threads(1)  # one intra-op thread per test worker

SCHED = dict(num_epochs=3, epoch_iter=4, initial_lr=1e-3, final_lr=2.5e-5,
             warm_up_epoch=0)
CLIP = 3.0  # the recipe's clip_grad
# parameters whose true gradient is zero, so that both packages return
# rounding noise: a TCN block's depthwise bias feeds an instance norm
# directly, which removes any per-channel constant; the real part of the
# output deconv's bias is a constant spectrum, an impulse at the first
# sample of each frame, where the periodic Hann window is 0
NOISE_ONLY = ("dconv1.bias", "deconv2d.bias")
# near-cancelling: every conv block's bias feeds ELU -> instance norm, so
# its gradient is the sum of de * (ELU' - 1), alive only on the ELU's
# negative branch; compared against the model's largest gradient
NEAR_CANCELLING = ("conv.bias",)
# the recipe's widths, a shallow TCN; test_torch_train's shards carry 16-d
# embeddings
MODEL_ARGS = dict(win=512, stride=128, spk_emb_dim=16,
                  spk_fuse_type="multiply", tcn_dims=384, tcn_blocks=2,
                  tcn_layers=1, use_spk_transform=False, joint_training=False,
                  conv_impl="pallas")
SAMPLES = 4096  # 33 frames: the widest pool (32) needs 32


def _model_and_batch():
    rng = np.random.default_rng(11)
    batch = {
        "wav_mix": rng.standard_normal((2, SAMPLES)).astype(np.float32) * 0.1,
        "wav_targets": rng.standard_normal((2, SAMPLES)).astype(np.float32)
        * 0.1,
        "spk_embeds": rng.standard_normal((2, 16)).astype(np.float32),
    }
    jmodel = JaxDPCCN(**dict(MODEL_ARGS, conv_impl="xla"))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batch["wav_mix"]),
                         jnp.asarray(batch["spk_embeds"]),
                         train=False)["params"]
    return jmodel, jax.tree_util.tree_map(np.asarray, params), batch


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
    after them, from the JAX package on its "xla" route."""
    jmodel, params, batch = _model_and_batch()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    criterion = jax_parse_loss("SISDR")
    tx = jax_trainer.make_optimizer(jax_exp(**SCHED), weight_decay=1e-4,
                                    clip_grad=CLIP)
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
    eval_loss = float(jax.jit(jax_trainer.make_eval_step(
        jmodel, criterion))(state, jbatch)["loss"])
    return params, batch, grads, losses, _flat(state.params), eval_loss


@pytest.mark.parametrize("route", ["pallas", "xla"])
def test_two_train_steps_match_jax(jax_run, route):
    """f32. Gradients of the first step: max abs error within 1e-3 of each
    parameter's largest gradient (the convolutions and ~60 instance norms
    sum in another order; measured <= 3.1e-5); the NOISE_ONLY and
    NEAR_CANCELLING gradients within 1e-3 of the model's largest. Losses of
    two steps and the eval loss after them: rtol 1e-4. Parameters after the
    second step: elements with |g| above 1e-2 of the tensor's largest agree
    to 5% of lr (below that the 3e-5 gradient error is a few percent of the
    element's gradient, which Adam's second step turns into up to 7% of lr),
    all others to 2 * lr (Adam's first steps are about lr * sign(g)); a
    NOISE_ONLY leaf, which each package moves by at most lr per step in a
    direction set by rounding, to 4 * lr."""
    params, batch, want_grads, want_losses, want_params, want_eval = jax_run
    model = load_jax_params(DPCCN(**dict(MODEL_ARGS, conv_impl=route)),
                            params)
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
        scale = largest if name.endswith(NOISE_ONLY + NEAR_CANCELLING) \
            else np.abs(want).max()
        assert err <= 1e-3 * scale, (name, err)

    opt = trainer.make_optimizer(model, exponential_decrease(**SCHED),
                                 weight_decay=1e-4, clip_grad=CLIP)
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
        firm = g > 1e-2 * g.max()
        assert diff[firm].max(initial=0.0) <= 0.05 * lr, name
        assert diff.max() <= 2 * lr, name
    got_eval = trainer.make_eval_step(parse_loss("SISDR"))(tstate, tbatch)
    np.testing.assert_allclose(float(got_eval["loss"]), want_eval, rtol=1e-4)


def test_bf16_step_keeps_f32_parameters(jax_run):
    """A bf16 compute step (the recipe's) gives f32 gradients and
    parameters and a finite loss near the f32 one."""
    params, batch, _, want_losses, _, _ = jax_run
    model = load_jax_params(DPCCN(**MODEL_ARGS), params)
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
    """Two short epochs of bin/train on the fused-block route."""
    root = str(tmp_path_factory.mktemp("dpccn_train"))
    rng = np.random.default_rng(0)
    tr = _write_set(root, "train", n_mix=4, n_samples=4800, rng=rng)
    va = _write_set(root, "dev", n_mix=2, n_samples=4800, rng=rng)
    config = _config(
        root, tr, va, model={"tse_model": "DPCCN"},
        model_args={"tse_model": dict(MODEL_ARGS)},
        dataset_args={"resample_rate": 16000, "sample_num_per_epoch": 4,
                      "shuffle": True, "shuffle_args": {"shuffle_size": 4},
                      "chunk_len": SAMPLES},
        clip_grad=CLIP)
    return root, config, va, train(config)


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
        device="cpu", save_wav=False, length_bucket=8000,
        test_data=va["data"], test_spk_embeds=va["spk_embeds"],
        test_spk1_enroll=va["spk1_enroll"],
        test_spk2_enroll=va["spk2_enroll"])
    assert np.isfinite(sisnr) and np.isfinite(sisnri)


def test_joint_training_raises_with_its_roadmap_item(tmp_path):
    rng = np.random.default_rng(1)
    tr = _write_set(str(tmp_path), "train", n_mix=2, n_samples=1600, rng=rng)
    # joint training reads enrollment maps: empty ones, as no step runs
    (tmp_path / "spk2enroll.json").write_text("{}")
    (tmp_path / "enroll_wav.scp").write_text("")
    config = _config(str(tmp_path), tr, tr,
                     train_spk2utt=str(tmp_path / "spk2enroll.json"),
                     val_spk2utt=str(tmp_path / "enroll_wav.scp"),
                     model={"tse_model": "DPCCN"},
                     model_args={"tse_model": dict(
                         MODEL_ARGS, joint_training=True,
                         spk_model="XVector_TDNN")})
    # every encoder of the registry is ported; an unknown name raises
    with pytest.raises(NotImplementedError, match="unknown speaker model"):
        train(config)
