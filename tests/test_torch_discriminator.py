"""Port parity: the CMGAN metric discriminator
(wesep_tpu_torch/models/discriminator.py) against the JAX package's, through
the weight bridge, at hid_chans 4 with numpy-seeded inputs.

In the forward and gradient tests flax.linen.Dropout is replaced
(monkeypatch; no JAX file changes) by one that applies a fixed mask, and
the port is given the same mask; the port's own draw is held against
flax's in test_dropout_mask_is_flax_dropouts_draw, and its initial D
against flax's init in test_init_like_jax_is_flax_init. The forward
agrees within 1e-5 of the largest value, the spectral-norm state (u,
sigma) after 1 and after 3 chained train-mode calls within 1e-6, and the
gradients of every parameter and of the estimate within 1e-4 relative L2.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wesep_tpu.models.discriminator import CMGANDiscriminator as JaxD
from wesep_tpu_torch.models import get_model
from wesep_tpu_torch.models.discriminator import CMGANDiscriminator
from wesep_tpu_torch.utils import jax_init
from wesep_tpu_torch.utils.jax_params import discriminator_state_dict_from_jax

torch.set_num_threads(1)  # one intra-op thread per test worker

HID = 4
ROWS, SAMPLES = 2, 4000
_MASK = {}


class FixedDropout(fnn.Module):
    """flax.linen.Dropout's interface, applying _MASK["mask"] (1 / keep
    on kept elements, as dropout scales them) in train mode."""

    rate: float
    deterministic: bool = False

    @fnn.compact
    def __call__(self, x):
        if self.deterministic:
            return x
        return x * jnp.asarray(_MASK["mask"])


@pytest.fixture
def fixed_dropout(monkeypatch):
    monkeypatch.setattr(fnn, "Dropout", FixedDropout)
    rng = np.random.default_rng(9)
    _MASK["mask"] = ((rng.uniform(size=(ROWS, 4 * HID)) < 0.7)
                     / 0.7).astype(np.float32)
    return [torch.from_numpy(_MASK["mask"])]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ref = (rng.standard_normal((ROWS, SAMPLES)) * 0.1).astype(np.float32)
    est = (ref + rng.standard_normal((ROWS, SAMPLES)) * 0.05).astype(
        np.float32)
    return ref, est


@functools.lru_cache(maxsize=None)
def _jax_vars():
    ref, est = _inputs()
    d = JaxD(hid_chans=HID)
    variables = jax.jit(functools.partial(d.init, train=False))(
        {"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
        ref, est)
    return d, jax.tree_util.tree_map(np.asarray, variables)


def _port(variables):
    model = CMGANDiscriminator(hid_chans=HID)
    model.load_state_dict(discriminator_state_dict_from_jax(
        variables["params"], variables["batch_stats"]), strict=True)
    return model


def _stats(model):
    return {n: b.numpy().copy() for n, b in model.named_buffers()
            if n.endswith((".u", ".sigma"))}


def _jax_stats(batch_stats):
    out = {}
    for stats in batch_stats.values():
        for key, v in stats.items():
            layer, _, leaf = key.split("/")
            out[f"{layer}.{leaf}"] = np.asarray(v)
    return out


def test_bridge_and_registry():
    _, variables = _jax_vars()
    model = _port(variables)  # strict: every name and shape
    assert get_model("CMGAN_Discriminator") is CMGANDiscriminator
    names = set(dict(model.named_buffers()))
    assert {f"conv_{i}.u" for i in range(4)} <= names
    assert model.conv_0.u.shape == (1, HID) and model.fc_final.u.shape \
        == (1, 1)
    assert model.conv_1.weight.shape == (2 * HID, HID, 4, 4)  # OIHW
    assert model.fc_0.weight.shape == (4 * HID, 8 * HID)  # [out, in]


@pytest.mark.parametrize("train", [False, True])
def test_forward_and_spectral_state_match_jax(fixed_dropout, train):
    d, variables = _jax_vars()
    model = _port(variables).train(train)
    ref, est = _inputs(1)
    stats = variables["batch_stats"]
    apply = jax.jit(functools.partial(
        d.apply, train=train, mutable=["batch_stats"] if train else False))
    want = []
    for call in range(3):
        out = apply({"params": variables["params"], "batch_stats": stats},
                    ref, est)
        if train:
            out, new = out
            stats = new["batch_stats"]
        want.append((np.asarray(out), _jax_stats(stats)))
    with torch.no_grad():
        for call in range(3):
            got = model(torch.from_numpy(ref), torch.from_numpy(est),
                        fixed_dropout).numpy()
            want_out, want_stats = want[call]
            assert got.shape == (ROWS, 1)
            np.testing.assert_allclose(
                got, want_out, rtol=0, atol=1e-5 * np.abs(want_out).max())
            if call in (0, 2):  # u and sigma after 1 and after 3 calls
                got_stats = _stats(model)
                for name, v in want_stats.items():
                    np.testing.assert_allclose(got_stats[name], v, rtol=0,
                                               atol=1e-6, err_msg=name)
    if not train:  # eval mode stores nothing
        for name, v in _stats(model).items():
            np.testing.assert_array_equal(
                v, _jax_stats(variables["batch_stats"])[name])


def test_gradients_match_jax(fixed_dropout):
    """Train mode, gradients of a weighted sum of the scores w.r.t. every
    parameter and the estimate (the G step's path)."""
    d, variables = _jax_vars()
    ref, est = _inputs(2)
    w = np.array([0.7, -1.3], np.float32)

    def loss(params, est_):
        out, _ = d.apply({"params": params,
                          "batch_stats": variables["batch_stats"]}, ref,
                         est_, train=True, mutable=["batch_stats"])
        return jnp.sum(out[:, 0] * w)

    g_params, g_est = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        variables["params"], est)
    want = discriminator_state_dict_from_jax(g_params, {})
    model = _port(variables).train()
    est_t = torch.from_numpy(est).requires_grad_()
    out = model(torch.from_numpy(ref), est_t, fixed_dropout)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad((out[:, 0] * torch.from_numpy(w)).sum(),
                                list(model.parameters()) + [est_t])
    assert set(names) == set(want)
    for name, g in zip(names + ["est"], grads):
        ref_g = torch.from_numpy(np.array(g_est)) if name == "est" \
            else want[name]
        if ref_g.norm() == 0:
            # the last block's PReLU slopes: the pooled maxima are all
            # positive, so no gradient reaches them on either side
            assert g.norm() == 0, name
            continue
        rel = ((g - ref_g).norm() / ref_g.norm()).item()
        assert rel <= 1e-4, (name, rel)


def test_dropout_mask_draw():
    model = CMGANDiscriminator(hid_chans=HID)
    a = model.dropout_mask(3, jax_init.seed_key(4))
    b = model.dropout_mask(3, jax_init.seed_key(4))
    assert len(a) == 1 and a[0].shape == (3, 4 * HID)
    assert torch.equal(a[0], b[0])
    kept = torch.tensor(1.0 / 0.7, dtype=torch.float32).item()
    assert set(a[0].unique().tolist()) <= {0.0, kept}


def _ulps(got, want):
    return np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("hid", [HID, 16])
def test_init_like_jax_is_flax_init(hid):
    """CMGANDiscriminator.init_like_jax(1) against wesep_tpu/bin/train_gan's
    `discriminator.init({"params": PRNGKey(1), "dropout": PRNGKey(2)}, ...,
    train=True)`, at hid_chans 4 and the recipes' 16: the kernels (flax's
    lecun_normal in the HWIO / [in, out] layout, divided by sigma as flax's
    init stores them), u and sigma after the init's power step within 1e-6
    of their largest (the draws within tests/test_torch_jax_init.DRAW_ULPS,
    the power step in torch matmuls), every other parameter bit for bit."""
    ref, est = _inputs()
    variables = jax.jit(functools.partial(JaxD(hid_chans=hid).init,
                                          train=True))(
        {"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
        ref, est)
    want = discriminator_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    model = CMGANDiscriminator(hid_chans=hid).init_like_jax(1)
    got = model.state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        have, expect = value.numpy(), want[name].numpy()
        if name.endswith((".weight", ".u", ".sigma")):
            np.testing.assert_allclose(have, expect, rtol=0, atol=1e-6
                                       * np.abs(expect).max(), err_msg=name)
        else:
            np.testing.assert_array_equal(have, expect, err_msg=name)


_FlaxDropout = fnn.Dropout


class Dropout(_FlaxDropout):
    """flax's Dropout (the same name, so the same scope and key), keeping
    which elements it kept ("intermediates", "keep")."""

    def __call__(self, inputs, deterministic=None, rng=None):
        out = _FlaxDropout.__call__(self, inputs, deterministic, rng)
        self.sow("intermediates", "keep", out != 0)
        return out


def test_dropout_mask_is_flax_dropouts_draw(monkeypatch):
    """D's dropout mask at steps 0, 1 and 2 of a GAN step seeded 42
    (trainer_gan.dropout_key) against the elements flax's Dropout keeps in
    the JAX discriminator applied with the JAX step's key,
    fold_in(PRNGKey(42), step): the same elements, the kept ones scaled by
    1 / 0.7."""
    from wesep_tpu_torch.train.trainer_gan import dropout_key

    monkeypatch.setattr(fnn, "Dropout", Dropout)
    d, variables = _jax_vars()
    ref, est = _inputs()
    model = CMGANDiscriminator(hid_chans=HID)
    kept = torch.tensor(1.0 / 0.7, dtype=torch.float32).item()
    for step in range(3):
        _, state = d.apply(
            variables, ref, est, train=True,
            rngs={"dropout": jax.random.fold_in(jax.random.PRNGKey(42),
                                                step)},
            mutable=["batch_stats", "intermediates"])
        want = np.asarray(state["intermediates"]["Dropout_0"]["keep"][0])
        (mask,) = model.dropout_mask(ROWS, dropout_key(42, step))
        np.testing.assert_array_equal(mask.numpy() != 0, want)
        assert set(mask.unique().tolist()) <= {0.0, kept}


def test_train_mode_needs_the_step_mask():
    """In train mode dropout takes the step's mask and draws none itself,
    so no call of a step can use a mask of its own; eval mode needs none."""
    model = CMGANDiscriminator(hid_chans=HID)
    wav = torch.zeros(2, 1600)
    with pytest.raises(ValueError, match="dropout_mask"):
        model.train()(wav, wav)
    assert model.eval()(wav, wav).shape == (2, 1)
