"""Port parity: BSRNN_Multi (wesep_tpu_torch/models/bsrnn_multi_optim.py),
the BSRNN with self-estimated speech augmentation in the model.

A small joint model (ResNet18 at m_channels 4 on the consistent frontend
of an enrollment waveform, as v2 bsrnn_multi_optim.yaml's ResNet34 takes
it) against the JAX package's, from the same parameters and BatchNorm
statistics (the port's seeded init with noise on the statistics, crossed
into flax trees):
  * train mode: the two passes' estimates within 5e-4 of the largest
    output, and the encoder's statistics after the forward, which moved
    twice (the enrollment's batch, then the detached estimate's);
  * eval mode: (s, logits), one pass, statistics unmoved;
  * two train steps with the conf's loss table [[0, 1]] / [[0.4, 0.6]]
    against `make_train_step`, each from the same state (losses rtol
    1e-4), and the eval step, which scores flat[0];
  * the mode follows `self.training`, not the grad mode;
  * bin/train -> bin/average_model -> bin/infer from the v2 conf (bf16).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_joint_train import _overrides, sets  # noqa: F401
from wesep_tpu.models.bsrnn_multi_optim import BSRNN_Multi as JaxMulti
from wesep_tpu.train import trainer as jax_trainer
from wesep_tpu.train.losses import parse_loss as jax_parse_loss
from wesep_tpu.train.schedulers import exponential_decrease as jax_exp
from wesep_tpu_torch.bin import average_model
from wesep_tpu_torch.bin.infer import infer
from wesep_tpu_torch.bin.train import train
from wesep_tpu_torch.models import get_model
from wesep_tpu_torch.models.bsrnn_multi_optim import BSRNN_Multi
from wesep_tpu_torch.train import trainer
from wesep_tpu_torch.train.checkpoint import find_epoch_checkpoints
from wesep_tpu_torch.train.losses import parse_loss
from wesep_tpu_torch.train.schedulers import exponential_decrease
from wesep_tpu_torch.utils.jax_params import load_jax_params

torch.set_num_threads(1)  # one intra-op thread per test worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "examples/librimix/tse/v2/confs/"
                    "bsrnn_multi_optim.yaml")
ARGS = dict(sr=16000, win=512, stride=128, feature_dim=16, num_repeat=1,
            use_spk_transform=False, spk_fuse_type="multiply",
            multi_fuse=False, joint_training=True, spk_feat=False,
            feat_type="consistent", remat=False, spk_model="ResNet18",
            spk_emb_dim=16,
            spk_args=dict(feat_dim=80, m_channels=4, embed_dim=16,
                          pooling_func="TSTP", two_emb_layer=False))
TABLE = dict(loss_posi=[[0, 1]], loss_weight=[[0.4, 0.6]])
SCHED = dict(num_epochs=2, epoch_iter=4, initial_lr=1e-3, final_lr=2.5e-5,
             warm_up_epoch=0)
LR = SCHED["initial_lr"]


def _batch(seed=0, rows=4, samples=4000, enroll=4800):
    """Each mixture of two sources twice, each source as the target; the
    cue is an enrollment waveform."""
    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((rows // 2, 2, samples)) * 0.1).astype(
        np.float32)
    return {"wav_mix": np.repeat(src.sum(axis=1), 2, axis=0),
            "wav_targets": src.reshape(rows, samples),
            "spk_embeds": (rng.standard_normal((rows, enroll)) * 0.1)
            .astype(np.float32)}


def _nested(named):
    tree = {}
    for name, value in named.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.asarray(value)
    return tree


@functools.lru_cache(maxsize=None)
def _variables():
    """(params, batch_stats) as flax trees: the port's seeded init, the
    BatchNorm statistics moved off (0, 1) so that eval mode normalises."""
    torch.manual_seed(0)
    model = BSRNN_Multi(**ARGS)
    rng = np.random.default_rng(7)
    params = {n: p.detach().numpy() for n, p in model.named_parameters()}
    stats = {n: b.numpy() + 0.1 * np.abs(rng.standard_normal(b.shape))
             .astype(np.float32) for n, b in model.named_buffers()
             if n.endswith((".mean", ".var"))}
    return _nested(params), _nested(stats)


def _port(params, stats):
    return load_jax_params(BSRNN_Multi(**ARGS), params, stats)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _port_stats(model):
    return {n: b.numpy().copy() for n, b in model.named_buffers()
            if n.endswith((".mean", ".var"))}


def _close(got, want, limit):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=limit * np.abs(want).max())


def test_registry():
    assert get_model("BSRNN_Multi") is BSRNN_Multi


def test_forward_train_and_eval_match_jax():
    params, stats = _variables()
    batch = _batch(1)
    jmodel = JaxMulti(**ARGS)
    variables = {"params": params, "batch_stats": stats}
    (j_out, _), j_new = jax.jit(functools.partial(
        jmodel.apply, train=True, mutable=["batch_stats"]))(
            variables, batch["wav_mix"], batch["spk_embeds"])
    j_eval = jax.jit(functools.partial(jmodel.apply, train=False))(
        variables, batch["wav_mix"], batch["spk_embeds"])

    model = _port(params, stats).train()
    with torch.no_grad():  # the grad mode does not choose the passes
        out, logits = model(torch.from_numpy(batch["wav_mix"]),
                            torch.from_numpy(batch["spk_embeds"]))
    assert logits is None and len(out) == 4 and out[2] is None \
        and out[3] is None
    for got, want in zip(out[:2], j_out[:2]):
        assert got.shape == (4, 4000)
        _close(got.numpy(), np.asarray(want), 5e-4)
    # the statistics moved twice: by the enrollment's batch, then by the
    # detached estimate's
    want_stats = _flat(j_new["batch_stats"])
    got_stats = _port_stats(model)
    start = _flat(stats)
    assert set(got_stats) == set(want_stats)
    for k, w in want_stats.items():
        _close(got_stats[k], w, 1e-4)
    assert any(not np.allclose(w, start[k]) for k, w in want_stats.items())

    model = _port(params, stats).eval()
    with torch.no_grad():
        s, logits = model(torch.from_numpy(batch["wav_mix"]),
                          torch.from_numpy(batch["spk_embeds"]))
    assert logits is None and s.shape == (4, 4000)
    _close(s.numpy(), np.asarray(j_eval[0]), 5e-4)
    for k, v in _port_stats(model).items():
        np.testing.assert_array_equal(v, start[k])


def test_two_train_steps_match_jax():
    """f32 steps with the conf's loss table, each from the same state: the
    first from the shared init, the second from the JAX state after the
    first (parameters, statistics and Adam's moments crossed into the
    port). Chaining the port's own first step would compare the second
    step's loss at about 1e-3: the second pass embeds the fbank of the
    first pass's estimate, and its encoder gradient moves 1.9e-4 (rel. L2)
    for a 1e-6 relative change of the input in the JAX package alone, so
    the estimate's rounding changes some gradients' signs, which Adam's
    first step turns into differences of lr, at an SI-SDR near -40 dB.
    Held each step: the loss rtol 1e-4; the encoder's statistics, which
    move twice a step, within 1e-4 of the largest; parameters within 2 lr
    (Adam's first steps move an element by about lr * sign(g)), their mean
    difference below 0.1 lr, and the firm elements (|g| above 1e-2 of the
    leaf's largest, where rounding cannot turn the sign) within 0.05 lr;
    then the eval step scores flat[0] with criterion[0]."""
    from flax import serialization

    from wesep_tpu_torch.utils.jax_params import optimizer_state_from_jax

    params, stats = _variables()
    batch = _batch(2)
    jmodel = JaxMulti(**ARGS)
    tx = jax_trainer.make_optimizer(jax_exp(**SCHED), weight_decay=1e-4,
                                    clip_grad=5.0)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        opt_state=tx.init(jparams))
    step_fn = jax.jit(jax_trainer.make_train_step(
        jmodel, tx, jax_parse_loss("SISDR"), **TABLE))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    states = [state]
    for _ in range(2):
        state, metrics = step_fn(state, jbatch)
        states.append(jax.tree_util.tree_map(np.asarray, state))
        states[-1] = (states[-1], float(metrics["loss"]))

    step = trainer.make_train_step(parse_loss("SISDR"), **TABLE)
    tbatch = trainer.batch_to_device(batch, "cpu")
    for i in range(2):
        start = states[0] if i == 0 else states[1][0]
        model = _port(start.params, start.batch_stats)
        opt = trainer.make_optimizer(model, exponential_decrease(**SCHED),
                                     weight_decay=1e-4, clip_grad=5.0)
        if i:
            opt.load_state_dict(optimizer_state_from_jax(
                serialization.to_state_dict(start.opt_state)))
        grads = {}
        real = opt.update

        def update(g, real=real):
            grads.update({k: v.abs().numpy() for k, v in g.items()})
            return real(g)

        opt.update = update
        tstate = trainer.TrainState(model=model, optimizer=opt, step=i)
        _, metrics = step(tstate, tbatch)
        want_state, want_loss = states[i + 1]
        np.testing.assert_allclose(float(metrics["loss"]), want_loss,
                                   rtol=1e-4)
        got_stats = _port_stats(model)
        for k, w in _flat(want_state.batch_stats).items():
            _close(got_stats[k], w, 1e-4)
        want_params = _flat(want_state.params)
        for name, p in model.named_parameters():
            diff = np.abs(p.detach().numpy() - want_params[name])
            assert diff.max() <= 2 * LR and diff.mean() <= 0.1 * LR, name
            firm = grads[name] > 1e-2 * grads[name].max()
            assert diff[firm].max(initial=0.0) <= 0.05 * LR, (i, name)
    # the eval step scores flat[0] of the eval-mode output, one pass (the
    # eval forward itself is held to JAX's in the test above)
    got_eval = trainer.make_eval_step(parse_loss("SISDR"))(tstate, tbatch)
    with torch.no_grad():
        s, _ = model.eval()(tbatch["wav_mix"], tbatch["spk_embeds"])
    want_eval = parse_loss("SISDR")[0](s, tbatch["wav_targets"]).mean()
    assert float(got_eval["loss"]) == float(want_eval)


def test_conf_train_average_infer(sets, tmp_path):  # noqa: F811
    """v2 bsrnn_multi_optim.yaml (ResNet34 at m_channels 4 on the
    consistent frontend, bf16, the [[0, 1]] / [[0.4, 0.6]] table) through
    bin/train for two epochs of two steps, bin/average_model and
    bin/infer: finite losses and scores, one wav per target."""
    _, tr, va = sets
    root = str(tmp_path)
    state = train(CONF, overrides=_overrides(root, tr, va))
    assert state.step == 4 and isinstance(state.model, BSRNN_Multi)
    exp = os.path.join(root, "exp")
    log = open(os.path.join(exp, "train.log")).read()
    losses = [float(v) for v in __import__("re").findall(
        r"Epoch \d+ train_loss (\S+) val_loss (\S+)", log)[-1]]
    assert np.isfinite(losses).all()
    models = os.path.join(exp, "models")
    assert [e for e, _ in find_epoch_checkpoints(models)] == [1, 2]
    dst = os.path.join(root, "avg_model.ckpt")
    average_model.main(["--dst_model", dst, "--src_path", models,
                        "--num", "2"])
    import yaml

    with open(CONF) as f:
        conf = yaml.safe_load(f)
    model_args = dict(conf["model_args"]["tse_model"], feature_dim=16,
                      num_repeat=1, spk_emb_dim=16,
                      spk_args=dict(conf["model_args"]["tse_model"]
                                    ["spk_args"], embed_dim=16,
                                    m_channels=4))
    out = os.path.join(root, "exp_infer")
    sisnr, sisnri = infer(
        {"model": conf["model"], "model_args": {"tse_model": model_args},
         "data_type": "shard",
         "dataset_args": dict(conf["dataset_args"], enroll_sec=0.3)},
        checkpoint=dst, exp_dir=out, device="cpu", length_bucket=1000,
        test_data=va["list"], test_spk2utt=va["enroll_wav.scp"],
        test_spk1_enroll=va["spk1_enroll"],
        test_spk2_enroll=va["spk2_enroll"])
    assert np.isfinite(sisnr) and np.isfinite(sisnri)
    wavs = [n for n in os.listdir(os.path.join(out, "audio"))
            if n.endswith(".wav")]
    assert len(wavs) == 8  # 4 mixtures x 2 targets
