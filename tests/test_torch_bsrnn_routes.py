"""Port parity: the pBSRNN on its two other LSTM routes, and the shape gates
of the DPCCN and ConvTasNet kernel routes.

- WESEP_LSTM_LAYER=0 sends every BiLSTM of the BSRNN to the two-kernel
  layer `cuda_lstm_fused.bilstm_fused` (K2/K2b on the card), as it sends
  the JAX package's to `pallas_lstm.bilstm_fused`.
- `use_bidirectional: false` gives each ResRNN a unidirectional LSTM,
  `rnn.lstm` -> `cuda_lstm_fused.lstm_fused` (K1/K1b on the card).

Both run the kernels' plain versions on the CPU and are held against the
JAX BSRNN (which runs its lax.scan LSTM on the CPU) from the same
numpy-seeded parameters through the weight bridge, f32: the forward within
5e-4 (as tests/test_torch_bsrnn.py), two train steps against
`make_train_step` with losses within rtol 1e-4 (as
tests/test_torch_trainer.py).

The gates: a Conv2dBlock whose channels the fused kernel does not take
runs DPCCN's "xla" route, and a gLN TCN block whose channels or taps the
fused kernel does not take runs the plain modules, decided from the shapes
before any launch.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wesep_tpu.models.bsrnn import BSRNN as JaxBSRNN
from wesep_tpu.train import trainer as jax_trainer
from wesep_tpu.train.losses import parse_loss as jax_parse_loss
from wesep_tpu.train.schedulers import exponential_decrease as jax_exp
from wesep_tpu_torch.models import convtasnet, dpccn
from wesep_tpu_torch.models.bsrnn import BSRNN
from wesep_tpu_torch.ops import rnn
from wesep_tpu_torch.train import trainer
from wesep_tpu_torch.train.losses import parse_loss
from wesep_tpu_torch.train.schedulers import exponential_decrease
from wesep_tpu_torch.utils.jax_params import (
    bsrnn_state_dict_from_jax,
    load_jax_params,
)

torch.set_num_threads(1)  # one intra-op thread per test worker

MODEL_ARGS = dict(sr=16000, win=512, stride=128, feature_dim=16,
                  num_repeat=2, spk_fuse_type="multiply",
                  use_spk_transform=False, multi_fuse=False,
                  joint_training=False, spk_emb_dim=16)
SCHED = dict(num_epochs=3, epoch_iter=4, initial_lr=1e-3, final_lr=2.5e-5,
             warm_up_epoch=0)
# route -> (environment, model arguments, the ops/rnn layer every ResRNN
# takes)
ROUTES = {
    "two_kernel": ({"WESEP_LSTM_LAYER": "0"}, {}, "bilstm_fused"),
    "unidirectional": ({}, {"use_bidirectional": False}, "lstm_fused"),
}


def _setup(route, monkeypatch, **override):
    """(JAX model, port-side kwargs, a list that counts the route's layer
    calls) with the route's environment set."""
    env, extra, layer = ROUTES[route]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    calls = []
    real = getattr(rnn, layer)

    def counted(*args, **kwargs):
        calls.append(layer)
        return real(*args, **kwargs)

    monkeypatch.setattr(rnn, layer, counted)
    kwargs = dict(MODEL_ARGS, **extra, **override)
    return JaxBSRNN(**kwargs), kwargs, calls


def _params(jmodel, kwargs, mix, emb, seed):
    """numpy-seeded parameters as a JAX tree: the port's init, every leaf
    perturbed, nested by name. Their names and shapes must be those of the
    JAX init, which is traced here but not compiled (XLA's compile of the
    BSRNN init alone takes ~14 s on the CPU)."""
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    tree = {}
    for name, value in BSRNN(**kwargs).state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value.numpy() + rng.standard_normal(
            value.shape).astype(np.float32) * 0.05
    want = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(mix), jnp.asarray(emb),
        train=False))["params"]
    assert _flat_shapes(tree) == _flat_shapes(want)
    return tree


def _flat_shapes(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out.update(_flat_shapes(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = tuple(value.shape)
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_bsrnn_route_forward_matches_jax(route, monkeypatch):
    """The whole model, f32, within the BSRNN tests' 5e-4; every one of the
    2 x num_repeat ResRNNs goes through the route's layer. The
    unidirectional model's tree holds one direction's weights only."""
    jmodel, kwargs, calls = _setup(route, monkeypatch)
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((2, 4000)).astype(np.float32) * 0.1
    emb = rng.standard_normal((2, 16)).astype(np.float32)
    params = _params(jmodel, kwargs, mix, emb, seed=1)
    want, _ = jax.jit(lambda p, m, e: jmodel.apply(
        {"params": p}, m, e, train=False))(params, jnp.asarray(mix),
                                           jnp.asarray(emb))
    sd = bsrnn_state_dict_from_jax(params)
    has_backward = any(k.endswith("rnn.wx_b") for k in sd)
    assert has_backward == (route == "two_kernel")
    model = load_jax_params(BSRNN(**kwargs), params).eval()
    with torch.no_grad():
        got, _ = model(torch.from_numpy(mix), torch.from_numpy(emb))
    assert len(calls) == 2 * MODEL_ARGS["num_repeat"]
    assert got.shape == (2, 4000)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_bsrnn_route_two_train_steps_match_jax(route, monkeypatch):
    """Two train steps of both packages from the same parameters and batch,
    f32: losses within rtol 1e-4, and the steps move the parameters (one
    BSNet, to keep XLA's compile of the JAX step short)."""
    jmodel, kwargs, calls = _setup(route, monkeypatch, num_repeat=1)
    rng = np.random.default_rng(7)
    batch = {
        "wav_mix": rng.standard_normal((2, 2400)).astype(np.float32) * 0.1,
        "wav_targets": rng.standard_normal((2, 2400)).astype(np.float32)
        * 0.1,
        "spk_embeds": rng.standard_normal((2, 16)).astype(np.float32),
    }
    params = _params(jmodel, kwargs, batch["wav_mix"], batch["spk_embeds"],
                     seed=3)
    tx = jax_trainer.make_optimizer(jax_exp(**SCHED), weight_decay=1e-4,
                                    clip_grad=5.0)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams, batch_stats={},
        opt_state=tx.init(jparams))
    step_fn = jax.jit(jax_trainer.make_train_step(
        jmodel, tx, jax_parse_loss("SISDR")))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = []
    for _ in range(2):
        state, metrics = step_fn(state, jbatch)
        want.append(float(metrics["loss"]))

    model = load_jax_params(BSRNN(**kwargs), params)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = trainer.make_optimizer(model, exponential_decrease(**SCHED),
                                 weight_decay=1e-4, clip_grad=5.0)
    tstate = trainer.TrainState(model=model, optimizer=opt)
    tbatch = trainer.batch_to_device(batch, "cpu")
    train_step = trainer.make_train_step(parse_loss("SISDR"))
    got = []
    for _ in range(2):
        tstate, metrics = train_step(tstate, tbatch)
        got.append(float(metrics["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert len(calls) == 2 * 2  # two steps of one BSNet's two ResRNNs
    assert all(not torch.equal(p.detach(), before[n])
               for n, p in model.named_parameters() if n.endswith("rnn.wh_f"))


def _spy_raises(monkeypatch, module, name):
    def refuse(*args, **kwargs):
        raise AssertionError(f"{name} must not be reached")

    monkeypatch.setattr(module, name, refuse)


def test_dpccn_gate_sends_other_channels_to_the_xla_route(monkeypatch):
    """conv_impl "pallas": a Conv2dBlock whose Ci and Co the fused kernel
    takes (multiples of 8, at most 256) goes to it; Co = 12 and Ci = 36
    (within the CI gate of 40 set here) go to the "xla" route, decided
    before the kernel's wrapper is called, with the "xla" route's
    result."""
    monkeypatch.setenv("WESEP_CONV2D_CI_GATE", "40")
    rng = np.random.default_rng(1)
    assert dpccn._fused_route("pallas", True, 16, 16)
    for ci, co in ((16, 12), (36, 16)):
        assert not dpccn._fused_route("pallas", True, ci, co)
        torch.manual_seed(0)
        block = dpccn.Conv2dBlock(ci, co, conv_impl="pallas")
        xla = dpccn.Conv2dBlock(ci, co, conv_impl="xla")
        xla.load_state_dict(block.state_dict())
        x = torch.from_numpy(
            rng.standard_normal((2, 5, 9, ci)).astype(np.float32))
        with monkeypatch.context() as m:
            _spy_raises(m, dpccn, "conv2d_block_in")
            y = block(x)
        assert y.shape == (2, 5, 9, co)
        torch.testing.assert_close(y, xla(x), atol=0, rtol=0)


def test_convtasnet_gate_sends_other_shapes_to_the_plain_blocks(
        monkeypatch):
    """A gLN TCN block without a skip connection takes the fused kernel
    where it takes C % 8 == 0, H % 8 == 0 and k <= 8; C = 12, H = 20 or
    k = 9 run the plain modules, decided before the kernel's wrapper is
    called."""
    assert convtasnet.TCNBlock(16, 24, kernel_size=3).fused
    rng = np.random.default_rng(2)
    for c, h, k in ((12, 24, 3), (16, 20, 3), (16, 24, 9)):
        torch.manual_seed(0)
        block = convtasnet.TCNBlock(c, h, kernel_size=k, dilation=2)
        assert not block.fused
        x = torch.from_numpy(
            rng.standard_normal((2, 30, c)).astype(np.float32))
        with monkeypatch.context() as m:
            _spy_raises(m, convtasnet, "tcn_block_gln")
            y = block(x)
        torch.testing.assert_close(y, block._plain_block(x, x), atol=0,
                                   rtol=0)
    fuse = convtasnet.FuseTCNBlock(12, 8, conv_channels=24, norm="gLN")
    assert not fuse.fused
