"""The JAX package's initial weights and batch order in the port:
utils/jax_init draws threefry-2x32 as jax.random does, and fills each
model as flax initialises the JAX model from the same seed, bit for bit
(its normal draws within DRAW_ULPS); bin/train builds its model so and
reads the batches the JAX bin/train reads at the same seed."""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wesep_tpu.models import get_model as jax_model
from wesep_tpu.tools import validate_synthetic as jax_vs
from wesep_tpu_torch.bin.train import build_model
from wesep_tpu_torch.models import get_model
from wesep_tpu_torch.tools import validate_synthetic as port_vs
from wesep_tpu_torch.utils import jax_init
from wesep_tpu_torch.utils.jax_params import port_state_from_jax

torch.set_num_threads(1)  # one intra-op thread per test worker

SEED = 17
# units in the last place between utils/jax_init's normal draws and jax's
# (XLA's erfinv in torch ops): measured over 2.1e6 draws of each, normal 2
# (on 76 draws), lecun_normal 3 (on 53); every other draw bit for bit
DRAW_ULPS = {"normal": 2, "lecun_normal": 3}
ONLINE_ARGS = {
    "sr": 16000, "win": 512, "stride": 128, "feature_dim": 16,
    "num_repeat": 1, "spk_fuse_type": "multiply", "use_spk_transform": False,
    "multi_fuse": False, "joint_training": True, "spk_model": "ResNet18",
    "spk_args": {"feat_dim": 80, "embed_dim": 32, "m_channels": 8,
                 "pooling_func": "TSTP", "two_emb_layer": False},
    "spk_emb_dim": 32, "spk_feat": False, "feat_type": "consistent",
    "spksInTrain": 4}


def _synthetic_args(name):
    return port_vs.model_args_for(argparse.Namespace(
        model=name, feature_dim=16, num_repeat=1))


def _ulps(got, want):
    return np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))


def _assert_draws(port_model, want):
    """Every parameter of port_model equals `want`'s (flat, by name) bit
    for bit, a lecun_normal draw within its DRAW_ULPS units in the last
    place (utils/jax_init: XLA's erfinv in torch ops)."""
    got = dict(port_model.named_parameters())
    assert set(got) == set(want)
    for name, param in got.items():
        have, expect = param.detach().numpy(), np.asarray(want[name])
        assert have.shape == expect.shape, name
        if getattr(param, "jax_init", ("",))[0] == "lecun_normal":
            assert _ulps(have, expect).max(initial=0) <= DRAW_ULPS[
                "lecun_normal"], name
        else:
            np.testing.assert_array_equal(have, expect, err_msg=name)


def _assert_like(port_model, params, batch_stats=None):
    """port_model's parameters against the JAX tree's (_assert_draws)."""
    want, _ = port_state_from_jax(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, batch_stats or {}))
    _assert_draws(port_model, {k: v.numpy() for k, v in want.items()})


def test_threefry_draws_match_jax_random():
    key = jax.random.PRNGKey(SEED)
    assert jax_init.seed_key(SEED) == tuple(int(k) for k in np.asarray(key))
    folded = jax.random.fold_in(key, 0xDEADBEEF)
    mine = jax_init.fold_in(jax_init.seed_key(SEED), 0xDEADBEEF)
    assert tuple(int(k) for k in np.asarray(folded)) == mine
    for shape, bound in (((5, 7), 0.3), ((4099,), 0.0144),
                         ((3, 3, 2, 16), 0.2357)):
        np.testing.assert_array_equal(
            jax_init.uniform(mine, shape, -bound, bound).numpy(),
            np.asarray(jax.random.uniform(folded, shape, jnp.float32,
                                          -bound, bound)))


@pytest.mark.parametrize("shape", [(3, 3, 16, 32), (256, 128), (1, 64),
                                   (200003,)])
def test_normal_draws_match_jax_random(shape):
    """jax.random.normal and flax's lecun_normal (a truncated normal) from
    the same key, within DRAW_ULPS; all but a few in 10^3 bit for bit."""
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), shape[-1])
    mine = jax_init.fold_in(jax_init.seed_key(SEED), shape[-1])
    draws = [("normal", jax_init.normal(mine, shape),
              jax.random.normal(key, shape, jnp.float32))]
    if len(shape) > 1:
        draws.append(("lecun_normal", jax_init.lecun_normal(mine, shape),
                      jax.nn.initializers.lecun_normal()(key, shape,
                                                         jnp.float32)))
    for kind, got, want in draws:
        ulps = _ulps(got.numpy(), np.asarray(want))
        assert ulps.max() <= DRAW_ULPS[kind], kind
        assert (ulps > 0).mean() < 1e-3, kind


@pytest.mark.parametrize("name", ["BSRNN", "DPCCN", "TFGridNet",
                                  "ConvTasNet", "online"])
def test_battery_models_start_from_the_jax_weights(name):
    """The battery's models (tools/validate_synthetic at feature_dim 16,
    one repeat; the online row's joint BSRNN with a narrow ResNet18, whose
    flax-default layers draw lecun_normal kernels and zero biases)."""
    if name == "online":
        family, args, cue = "BSRNN", ONLINE_ARGS, jnp.zeros((2, 16000))
    else:
        family, args, cue = name, _synthetic_args(name), jnp.zeros((2, 32))
    variables = jax.jit(jax_model(family)(**args).init,
                        static_argnames="train")(
        jax.random.PRNGKey(SEED), jnp.zeros((2, 8000)), cue, train=True)
    port = jax_init.init_like_jax(get_model(family)(**args), SEED)
    _assert_like(port, variables["params"], variables.get("batch_stats"))


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = np.asarray(value)
    return out


@pytest.mark.parametrize("name,args", [
    ("ResNet34", dict(m_channels=8, embed_dim=16, pooling_func="TSTP",
                      two_emb_layer=False)),
    ("ResNet18", dict(m_channels=8, embed_dim=16, pooling_func="ASTP",
                      two_emb_layer=True)),
    ("ECAPA_TDNN_c32", dict(embed_dim=16, layout="tpu")),
    ("ECAPA_TDNN_GLOB_c32", dict(embed_dim=16, layout="wespeaker",
                                 emb_bn=True)),
    ("CAMPPlus", dict(embed_dim=32))])
def test_speaker_encoders_start_from_the_jax_weights(name, args):
    """Each speaker encoder family at small widths against flax's
    `model.init` at SEED: the layers that keep flax's default (ResNet's and
    CAM++'s convolutions, every encoder's dense layers, ASTP's) draw
    lecun_normal kernels and zero biases, the rest torch's uniform."""
    from wesep_tpu.models.speaker import get_speaker_model as jax_speaker
    from wesep_tpu_torch.models.speaker import get_speaker_model

    feats = jnp.zeros((2, 40, 24))
    params = jax.jit(jax_speaker(name)(**args).init,
                     static_argnames="train")(
        jax.random.PRNGKey(SEED), feats, train=False)["params"]
    port = jax_init.init_like_jax(
        get_speaker_model(name)(feat_dim=24, **args), SEED)
    _assert_draws(port, _flat(params))


def _names(tree):
    for key, value in tree.items():
        yield key
        if hasattr(value, "items"):
            yield from _names(value)


def test_remat_names_the_tcn_blocks_as_flax_does():
    args = dict(_synthetic_args("ConvTasNet"), remat=True)
    params = jax.jit(jax_model("ConvTasNet")(**args).init,
                     static_argnames="train")(
        jax.random.PRNGKey(SEED), jnp.zeros((2, 8000)), jnp.zeros((2, 32)),
        train=True)["params"]
    assert any(k.startswith("CheckpointTCNBlock_") for k in _names(params))
    port = get_model("ConvTasNet")(**args)
    jax_init.init_like_jax(port, SEED, jax_init.jax_scope_names(port))
    _assert_like(port, params)


def test_build_model_draws_at_the_config_seed():
    config = {"model": {"tse_model": "TFGridNet"}, "seed": SEED,
              "model_args": {"tse_model": _synthetic_args("TFGridNet")}}
    model, _ = build_model(config)
    again, _ = build_model(dict(config))
    other, _ = build_model(dict(config, seed=SEED + 1))
    for (n, p), q, r in zip(model.named_parameters(), again.parameters(),
                            other.parameters()):
        assert torch.equal(p, q), n
    assert not all(torch.equal(p, r) for p, r in zip(model.parameters(),
                                                      other.parameters()))


class _Stop(Exception):
    pass


def _first_batches(monkeypatch, executor_module, run, root, n=3, **kw):
    """The first n batches bin/train hands its epoch loop (read before any
    step is taken), by key."""
    seen = []

    def train(self, dataloader, *a, **k):
        for batch in dataloader:
            seen.append(list(batch["key"]))
            if len(seen) == n:
                raise _Stop
        raise AssertionError("too few batches")

    monkeypatch.setattr(executor_module.Executor, "train", train)
    with pytest.raises(_Stop):
        run(str(root), model="BSRNN", num_epochs=1, num_spk=4,
            utts_per_spk=4, chunk_len=8000, batch_size=2, **kw)
    return seen


def test_bin_train_reads_the_jax_batches(tmp_path, monkeypatch):
    """The JAX bin/train draws one batch for its init shapes before it
    trains; the port draws it too, so both train on the same batches."""
    from wesep_tpu.train import executor as jax_executor
    from wesep_tpu_torch.train import executor as port_executor

    want = _first_batches(monkeypatch, jax_executor, jax_vs.run,
                          tmp_path / "jax")
    got = _first_batches(monkeypatch, port_executor, port_vs.run,
                         tmp_path / "port", device="cpu")
    assert got == want
