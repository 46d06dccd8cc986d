"""Port parity: the speaker encoders (ResNet18/34/50 and their pooling)
against wesep_tpu.models.speaker on the CPU.

The JAX encoder is initialised, every parameter and BatchNorm statistic is
perturbed with numpy noise, and both packages run the same fbank: in eval
mode (the statistics), and in train mode (the batch's statistics), where
the port's updated buffers are held against the `batch_stats` flax
returns. A bf16 fbank gives an f32 embedding in both packages: flax
promotes it against the f32 parameters, and so does the port.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wesep_tpu.models.speaker import get_speaker_model as jax_speaker_model
from wesep_tpu.models.speaker import pooling as jax_pooling
from wesep_tpu_torch.models.speaker import get_speaker_model, pooling
from wesep_tpu_torch.utils.jax_params import (
    convtasnet_state_dict_from_jax,
    load_jax_params,
)

torch.set_num_threads(1)  # one intra-op thread per test worker

FEAT = 24
# (model, pooling, two_emb_layer): each ResNet, each pooling, both heads
CASES = [("ResNet18", "TSTP", True), ("ResNet18", "ASTP", False),
         ("ResNet34", "TSTP", False), ("ResNet34", "MQMHASTP", True),
         ("ResNet50", "ASTP", True), ("ResNet50", "TSTP", False)]


def _args(pool, two):
    return dict(m_channels=8, embed_dim=16, pooling_func=pool,
                two_emb_layer=two)


def _jax_model(name, pool, two, feats, seed=0):
    """JAX encoder with perturbed parameters and (positive) statistics."""
    jm = jax_speaker_model(name)(**_args(pool, two))
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(feats), train=False)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape)
        .astype(np.float32), v["params"])
    stats = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * np.abs(rng.standard_normal(p.shape))
        .astype(np.float32), v["batch_stats"])
    return jm, params, stats


def _feats(seed, rows=3, frames=50):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((rows, frames, FEAT)).astype(np.float32)


def _port(name, pool, two, params, stats):
    model = get_speaker_model(name)(feat_dim=FEAT, **_args(pool, two))
    return load_jax_params(model, params, stats)


def _last(out):
    return out[-1] if isinstance(out, (tuple, list)) else out


@pytest.mark.parametrize("name,pool,two", CASES)
def test_encoder_eval_matches_jax(name, pool, two):
    """Eval mode, f32: both embeddings (two_emb_layer) within 1e-5 of the
    largest (measured 1.4e-6)."""
    feats = _feats(1)
    jm, params, stats = _jax_model(name, pool, two, feats)
    want = jm.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(feats), train=False)
    model = _port(name, pool, two, params, stats).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(feats))
    assert isinstance(got, tuple) == two
    for g, w in zip(got if two else [got], want if two else [want]):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape == (3, 16)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("name,pool,two", CASES)
def test_encoder_train_matches_jax_and_its_statistics(name, pool, two):
    """Train mode: the embedding within 2e-3 of the largest (batch
    statistics over 3 rows amplify rounding; measured 1.1e-3), and every
    updated BatchNorm statistic against flax's `batch_stats` within 1e-5
    of its largest (measured 6e-7) and 5e-5 absolute."""
    feats = _feats(2)
    jm, params, stats = _jax_model(name, pool, two, feats, seed=3)
    want, new = jm.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(feats), train=True,
                         mutable=["batch_stats"])
    model = _port(name, pool, two, params, stats).train()
    with torch.no_grad():
        got = _last(model(torch.from_numpy(feats)))
    want = np.asarray(_last(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-3 * np.abs(want).max())
    buffers = dict(model.named_buffers())
    new_stats = convtasnet_state_dict_from_jax({}, new["batch_stats"])
    assert set(buffers) == set(new_stats)
    for k, w in new_stats.items():
        torch.testing.assert_close(buffers[k], w, rtol=0,
                                   atol=max(1e-5 * float(w.abs().max()),
                                            5e-5), msg=k)


@pytest.mark.parametrize("two", [False, True])
def test_bf16_fbank_gives_an_f32_embedding(two):
    """flax promotes a bf16 input against f32 parameters, so the encoder
    runs in f32; the port casts the input up front. Both embeddings agree
    within 1e-5 of the largest (the input's rounding is the same)."""
    feats = _feats(3)
    jm, params, stats = _jax_model("ResNet18", "TSTP", two, feats)
    half = jnp.asarray(feats, jnp.bfloat16)
    want = _last(jm.apply({"params": params, "batch_stats": stats}, half,
                          train=False))
    assert want.dtype == jnp.float32
    model = _port("ResNet18", "TSTP", two, params, stats).eval()
    with torch.no_grad():
        got = _last(model(torch.from_numpy(feats).bfloat16()))
    assert got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_bridge_loads_the_statistics_strictly():
    """Every parameter and statistic has its name and shape in the flax
    trees (seg_bn_1 holds statistics only); a missing statistic fails."""
    feats = _feats(4)
    _, params, stats = _jax_model("ResNet18", "TSTP", True, feats)
    model = get_speaker_model("ResNet18")(feat_dim=FEAT,
                                          **_args("TSTP", True))
    sd = convtasnet_state_dict_from_jax(params, stats)
    assert set(sd) == set(model.state_dict())
    assert "seg_bn_1.mean" in sd and "seg_bn_1.scale" not in sd
    assert sd["conv1.kernel"].shape == (3, 3, 1, 8)
    assert "conv1.bias" not in sd
    del stats["layer1_0"]["bn1"]["var"]
    with pytest.raises(RuntimeError, match="layer1_0.bn1.var"):
        load_jax_params(model, params, stats)


def test_registry():
    for name in ("ResNet18", "ResNet34", "ResNet50", "ResNet101",
                 "ResNet152"):
        model = get_speaker_model(name)(feat_dim=FEAT, m_channels=4,
                                        embed_dim=8)
        assert model.embed_dim == 8
    with pytest.raises(ValueError, match="requires spk_model"):
        get_speaker_model(None)
    for name in ("ECAPA_TDNN_GLOB_c512", "ECAPA_TDNN_c1024", "CAMPPlus"):
        model = get_speaker_model(name)(feat_dim=FEAT, embed_dim=8)
        assert model.embed_dim == 8
    for name in ("XVector_TDNN", "ResNet7"):
        with pytest.raises(NotImplementedError,
                           match="unknown speaker model"):
            get_speaker_model(name)


@pytest.mark.parametrize("pool", ["TSTP", "ASTP", "MQMHASTP"])
def test_pooling_matches_jax(pool):
    """Pooling alone on [B, T, D] within 1e-5 of the largest output;
    the input's dtype comes back."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 30, 16)) * 2 + 1).astype(np.float32)
    jp = jax_pooling.get_pooling(pool)()
    v = jp.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape)
        .astype(np.float32), v.get("params", {}))
    want = np.asarray(jp.apply({"params": params}, jnp.asarray(x)))
    port = pooling.get_pooling(pool)(16)
    load_jax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == want.shape == (2, port.out_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert port(torch.from_numpy(x).double()).dtype == torch.float64
    with pytest.raises(ValueError, match="unknown pooling"):
        pooling.get_pooling("XSTP")
