"""Port parity: the MetricGAN step (wesep_tpu_torch/train/trainer_gan.py)
against the JAX package's `make_gan_train_step`.

Two whole GAN steps from the same numpy-seeded batch and the same
parameters (the generator's and the discriminator's through the weight
bridges, D's spectral-norm state included): a small BSRNN generator, as
tests/test_gan.py builds it, and a small DPCCN (the recipe's widths up to
the TCN, one shallow TCN, two pools), the BSRNN with `metric_sisdr_norm`
and the DPCCN with `metric_pesq`, the GAN recipes' generator and metric.
Both start from the port's seeded parameters, crossed into flax trees.
Dropout is off on both sides (flax.linen.Dropout replaced by the identity
through monkeypatch, no JAX file changes; the port's draw replaced by
ones), since JAX's mask comes from a key the port cannot reproduce. Held: g_loss,
se_loss and d_loss of both steps (rtol 1e-4); G's and D's parameters
after each step: every element within 2 lr a step (Adam's first steps are
about lr * sign(g), and a gradient at rounding level may take either
sign); after the first step, elements whose gradient is above 1e-2 of the
tensor's largest within 5 % of lr; after the second, each tensor's update
within 2e-2 of the JAX update's L2 norm (its Adam step divides by the root
of two steps' squared gradients, so where the second gradient nearly
cancels the first, an element's update is a difference of near-equal
terms: measured <= 7.3e-3), DPCCN's two noise-only biases on the first
bound alone; D's u after both steps within 1e-5. A separate test holds the port to one dropout
mask for every D call of a step and a new draw for the next step.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wesep_tpu.models.bsrnn import BSRNN as JaxBSRNN
from wesep_tpu.models.discriminator import CMGANDiscriminator as JaxD
from wesep_tpu.models.dpccn import DPCCN as JaxDPCCN
from wesep_tpu.train import trainer as jax_trainer
from wesep_tpu.train import trainer_gan as jax_gan
from wesep_tpu.train.losses import si_sdr_loss as jax_si_sdr_loss
from wesep_tpu.train.schedulers import exponential_decrease as jax_exp
from wesep_tpu_torch.models.bsrnn import BSRNN
from wesep_tpu_torch.models.discriminator import CMGANDiscriminator
from wesep_tpu_torch.models.dpccn import DPCCN
from wesep_tpu_torch.train import trainer
from wesep_tpu_torch.train import trainer_gan
from wesep_tpu_torch.train.losses import si_sdr_loss
from wesep_tpu_torch.train.schedulers import exponential_decrease
from wesep_tpu_torch.utils.jax_params import (
    discriminator_state_dict_from_jax,
    load_jax_params,
)

torch.set_num_threads(1)  # one intra-op thread per test worker

SCHED = dict(num_epochs=1, epoch_iter=10, initial_lr=1e-3, final_lr=1e-4,
             warm_up_epoch=0)
LR = SCHED["initial_lr"]
WD, CLIP, GAN_W = 1e-4, 3.0, 0.05
HID = 4
EMB = 16
# DPCCN leaves whose true gradient is zero, so that both packages return
# rounding noise (a TCN block's depthwise bias feeds an instance norm; the
# real part of the output deconv's bias is invisible to the iSTFT): held
# to the bound on every element only
NOISE_ONLY = ("dconv1.bias", "deconv2d.bias")
GENERATORS = {
    "bsrnn": (JaxBSRNN, BSRNN, dict(
        spk_emb_dim=EMB, feature_dim=8, num_repeat=1, joint_training=False,
        use_spk_transform=False, spk_fuse_type="multiply", multi_fuse=False,
        remat=False), 4000),
    # 13 frames (the widest of the two pools needs 8); D's 16 frames go
    # through four stride-2 convolutions
    "dpccn": (JaxDPCCN, DPCCN, dict(
        win=512, stride=128, spk_emb_dim=EMB, spk_fuse_type="multiply",
        tcn_dims=384, tcn_blocks=1, tcn_layers=1, pool_size=(4, 8),
        use_spk_transform=False, joint_training=False), 1536),
}


class _Identity(fnn.Module):
    rate: float
    deterministic: bool = False

    def __call__(self, x):
        return x


def _batch(samples, seed=3):
    """Noise mixtures and targets, as tests/test_gan.py draws them."""
    rng = np.random.default_rng(seed)
    return {
        "wav_mix": rng.standard_normal((2, samples)).astype(np.float32) * 0.1,
        "wav_targets": rng.standard_normal((2, samples)).astype(np.float32)
        * 0.1,
        "spk_embeds": rng.standard_normal((2, EMB)).astype(np.float32)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _nested(state):
    """A port generator's state_dict as the JAX param tree (the port names
    its parameters by the tree's paths)."""
    tree = {}
    for name, value in state.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(value.numpy())
    return tree


def _jax_disc_vars(model):
    """A port discriminator's state as flax variables (the inverse of
    utils.jax_params.discriminator_state_dict_from_jax), so that no flax
    init needs compiling."""
    params, stats = {}, {}
    for name, v in model.state_dict().items():
        layer, _, leaf = name.rpartition(".")
        v = v.numpy()
        if not layer:  # in_scale_{i}, in_bias_{i}
            params[name] = jnp.asarray(v)
        elif leaf == "weight":
            v = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T
            params.setdefault(layer, {})["kernel"] = jnp.asarray(v)
        elif leaf in ("u", "sigma"):
            stats.setdefault(layer, {})[f"{layer}/kernel/{leaf}"] = \
                jnp.asarray(v)
        else:
            params.setdefault(layer, {})[leaf] = jnp.asarray(v)
    order = [f"conv_{i}" for i in range(4)] + ["fc_0", "fc_final"]
    return {"params": params,
            "batch_stats": {f"SpectralNorm_{j}": stats[layer]
                            for j, layer in enumerate(order)}}


@functools.lru_cache(maxsize=None)
def _jax_run(kind, metric):
    """Initial variables (both models' from the port's seeded init), and
    two JAX GAN steps' metrics and the states after each."""
    jax_cls, port_cls, args, samples = GENERATORS[kind]
    fnn_dropout = fnn.Dropout
    fnn.Dropout = _Identity
    try:
        batch = {k: jnp.asarray(v) for k, v in _batch(samples).items()}
        gen, disc = jax_cls(**args), JaxD(hid_chans=HID)
        g_opt = jax_trainer.make_optimizer(jax_exp(**SCHED), weight_decay=WD,
                                           clip_grad=CLIP)
        d_opt = jax_trainer.make_optimizer(jax_exp(**SCHED), weight_decay=WD,
                                           clip_grad=CLIP)
        torch.manual_seed(0)
        g_params = _nested(port_cls(**args).state_dict())
        g_state = jax_trainer.TrainState(
            step=jnp.zeros((), jnp.int32), params=g_params, batch_stats={},
            opt_state=g_opt.init(g_params))
        d_vars = _jax_disc_vars(CMGANDiscriminator(hid_chans=HID))
        d_state = jax_trainer.TrainState(
            step=jnp.zeros((), jnp.int32), params=d_vars["params"],
            batch_stats=d_vars["batch_stats"],
            opt_state=d_opt.init(d_vars["params"]))
        metric_fn = {"sisdr": jax_gan.metric_sisdr_norm,
                     "pesq": jax_gan.metric_pesq}[metric]
        step = jax.jit(jax_gan.make_gan_train_step(
            gen, disc, g_opt, d_opt, [jax_si_sdr_loss],
            gan_loss_weight=GAN_W, metric_fn=metric_fn))
        init = jax.tree_util.tree_map(
            np.asarray, (g_state.params, d_vars["params"],
                         d_vars["batch_stats"]))
        states, metrics, after = (g_state, d_state), [], []
        for _ in range(2):
            states, m = step(states, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            after.append(jax.tree_util.tree_map(
                np.asarray, (states[0].params, states[1].params,
                             states[1].batch_stats)))
    finally:
        fnn.Dropout = fnn_dropout
    return init, metrics, after


def _port_states(kind, init):
    _, port_cls, args, _ = GENERATORS[kind]
    g_params, d_params, d_stats = init
    gen = load_jax_params(port_cls(**args), g_params)
    disc = CMGANDiscriminator(hid_chans=HID)
    disc.load_state_dict(discriminator_state_dict_from_jax(d_params, d_stats))

    def state(model):
        opt = trainer.make_optimizer(model, exponential_decrease(**SCHED),
                                     weight_decay=WD, clip_grad=CLIP)
        return trainer.TrainState(model=model, optimizer=opt)

    return state(gen), state(disc)


def _ones_mask(self, batch, generator=None, device=None):
    return [torch.ones(batch, f) for f in self.dropout_features]


def _by_name(after):
    """{"g": G's params, "d": D's state} by the port's names."""
    g, d, stats = after
    return {"g": _flat(g), "d": {
        k: v.numpy() for k, v in discriminator_state_dict_from_jax(
            d, stats).items()}}


@pytest.mark.parametrize("kind,metric", [("bsrnn", "sisdr"),
                                         ("dpccn", "pesq")])
def test_two_gan_steps_match_jax(kind, metric, monkeypatch):
    init, want_metrics, want_after = _jax_run(kind, metric)
    monkeypatch.setattr(CMGANDiscriminator, "dropout_mask", _ones_mask)
    g_state, d_state = _port_states(kind, init)
    models = {"g": g_state.model, "d": d_state.model}
    start = _by_name(init)
    first_grads = {}
    for tag, st in (("g", g_state), ("d", d_state)):
        real = st.optimizer.update

        def update(grads, real=real, tag=tag):
            first_grads.setdefault(tag, {k: v.clone()
                                         for k, v in grads.items()})
            return real(grads)

        st.optimizer.update = update
    metric_fn = {"sisdr": trainer_gan.metric_sisdr_norm,
                 "pesq": trainer_gan.metric_pesq}[metric]
    step = trainer_gan.make_gan_train_step(
        [si_sdr_loss], gan_loss_weight=GAN_W, metric_fn=metric_fn)
    batch = trainer.batch_to_device(_batch(GENERATORS[kind][3]), "cpu")
    states = (g_state, d_state)
    for i in range(2):
        states, got = step(states, batch)
        for key in ("loss", "se_loss", "d_loss"):
            np.testing.assert_allclose(float(got[key]),
                                       want_metrics[i][key], rtol=1e-4,
                                       err_msg=key)
        want = _by_name(want_after[i])
        for tag, model in models.items():
            for name, p in model.named_parameters():
                got_p = p.detach().numpy()
                diff = np.abs(got_p - want[tag][name])
                assert diff.max() <= 2 * (i + 1) * LR, (i, tag, name)
                if name.endswith(NOISE_ONLY):
                    continue
                if i == 0:
                    g = first_grads[tag][name].abs().numpy()
                    firm = g > 1e-2 * g.max()
                    assert diff[firm].max(initial=0.0) <= 0.05 * LR, \
                        (tag, name)
                else:
                    upd = want[tag][name] - start[tag][name]
                    err = np.linalg.norm(got_p - want[tag][name])
                    assert err <= 2e-2 * np.linalg.norm(upd), (tag, name)
    assert g_state.step == d_state.step == 2
    for name, b in d_state.model.named_buffers():
        if name.endswith(".u"):
            np.testing.assert_allclose(b.numpy(), want["d"][name], rtol=0,
                                       atol=1e-5, err_msg=name)


def test_one_dropout_mask_per_step():
    """Every D call of a step (clean, mixture, estimate) applies the same
    mask; the next step draws another, from (seed, D's step)."""
    _, port_cls, args, samples = GENERATORS["bsrnn"]
    torch.manual_seed(0)
    g_state, d_state = (
        trainer.TrainState(m, trainer.make_optimizer(
            m, exponential_decrease(**SCHED)))
        for m in (port_cls(**args), CMGANDiscriminator(hid_chans=HID)))
    seen = []
    real = CMGANDiscriminator.forward

    def forward(self, ref, est, dropout_mask=None):
        if self.training:
            seen.append(dropout_mask[0].clone())
        return real(self, ref, est, dropout_mask)

    d_state.model.forward = functools.partial(forward, d_state.model)
    step = trainer_gan.make_gan_train_step([si_sdr_loss], seed=42)
    batch = trainer.batch_to_device(_batch(samples), "cpu")
    states = (g_state, d_state)
    for _ in range(2):
        states, _ = step(states, batch)
    assert len(seen) == 6  # (clean, mixture, estimate) x 2 steps
    first, second = seen[:3], seen[3:]
    assert all(torch.equal(m, first[0]) for m in first)
    assert all(torch.equal(m, second[0]) for m in second)
    assert not torch.equal(first[0], second[0])
    want = d_state.model.dropout_mask(2, trainer_gan.dropout_key(42, 0))[0]
    assert torch.equal(first[0], want)


def test_host_pesq_metric_matches_the_device_metric():
    """`pesq_host` (per row through utils/score.cal_PESQ_norm, the in-repo
    model after a crude alignment, shift 0 here) gives the device metric's
    values, and a silent row is masked out."""
    rng = np.random.default_rng(8)
    t = np.arange(16000) / 16000.0
    ref = np.stack([np.sin(2 * np.pi * f * t) * (1 + 0.5 * np.sin(
        2 * np.pi * 3 * t)) for f in (150.0, 230.0, 310.0)]).astype(
        np.float32) * 0.3
    est = (ref + 0.05 * rng.standard_normal(ref.shape)).astype(np.float32)
    est[2] = 0.0
    est_t, ref_t = torch.from_numpy(est), torch.from_numpy(ref)
    want, want_ok = trainer_gan.metric_pesq(est_t, ref_t)
    got, ok = trainer_gan.metric_pesq_callback(est_t, ref_t)
    assert ok.tolist() == want_ok.tolist() == [True, True, False]
    torch.testing.assert_close(got[:2], want[:2], rtol=0, atol=2e-5)
