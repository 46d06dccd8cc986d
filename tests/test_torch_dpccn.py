"""Port parity: the whole DPCCN against the JAX model.

The same numpy-seeded mixture and embeddings go through
wesep_tpu.models.dpccn.DPCCN and, through the weight bridge
`dpccn_state_dict_from_jax`, through the port's DPCCN at the recipe's full
widths with a shallow TCN (one layer of two blocks) on 0.5 s of audio. Both
routes of `conv_impl`: "xla" (conv -> ELU -> instance_norm) and "pallas",
where the JAX model runs the Pallas kernel in interpret mode under
WESEP_CONV2D_PALLAS=force and the port the plain versions of its CUDA
kernels. Limits, relative to the output's largest magnitude: f32 atol
5e-4 / rtol 1e-3 (the BSRNN rule: the same arithmetic in another order
through ~60 instance norms); bf16 see test_forward_matches_jax.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wesep_tpu.models.dpccn import DPCCN as JaxDPCCN
from wesep_tpu_torch.models import dpccn as port_dpccn
from wesep_tpu_torch.models import get_model
from wesep_tpu_torch.models.dpccn import DPCCN
from wesep_tpu_torch.utils.jax_params import (
    dpccn_state_dict_from_jax,
    load_jax_params,
)

torch.set_num_threads(1)  # one intra-op thread per test worker

SMALL = dict(spk_emb_dim=16, win=512, stride=128, joint_training=False,
             tcn_layers=1, tcn_blocks=2)
SAMPLES = 8000
FUSED_PER_FORWARD = 7  # enc0.conv1/2, enc{1..4}_dense.conv1, dec7.conv1


def _inputs(seed, rows=2):
    rng = np.random.default_rng(seed)
    mix = (rng.standard_normal((rows, SAMPLES)) * 0.1).astype(np.float32)
    emb = rng.standard_normal((rows, 16)).astype(np.float32)
    return mix, emb


@pytest.fixture(scope="module")
def params():
    mix, emb = _inputs(0)
    tree = JaxDPCCN(**SMALL).init(jax.random.PRNGKey(0), jnp.asarray(mix),
                                  jnp.asarray(emb), train=False)["params"]
    return jax.tree_util.tree_map(np.asarray, tree)


def test_state_dict_names_match_the_jax_tree_on_every_conv_impl(
        monkeypatch, params):
    """The JAX tree is the same on "xla", "patch" and "pallas", and every
    leaf lands on a port parameter of its shape; loading is strict."""
    monkeypatch.setenv("WESEP_CONV2D_PALLAS", "force")
    mix, emb = _inputs(0)

    def shapes(conv_impl):
        tree = jax.eval_shape(
            lambda m, e: JaxDPCCN(**SMALL, conv_impl=conv_impl).init(
                jax.random.PRNGKey(0), m, e, train=False)["params"],
            jnp.asarray(mix), jnp.asarray(emb))
        return {k: tuple(v.shape) for k, v in dpccn_state_dict_from_jax(
            jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   tree)).items()}

    want = {k: tuple(v.shape)
            for k, v in dpccn_state_dict_from_jax(params).items()}
    assert shapes("patch") == shapes("pallas") == want
    for conv_impl in ("xla", "patch", "pallas"):
        port = DPCCN(**SMALL, conv_impl=conv_impl)
        assert {k: tuple(v.shape) for k, v in port.state_dict().items()} \
            == want
    assert get_model("DPCCN") is DPCCN
    sd = dpccn_state_dict_from_jax(params)
    with pytest.raises(RuntimeError, match="Missing key"):
        DPCCN(**SMALL).load_state_dict(
            {k: v for k, v in sd.items() if not k.startswith("dec7.")})


@pytest.mark.parametrize("route,dtype", [
    ("xla", "float32"), ("pallas", "float32"), ("xla", "bfloat16"),
    ("pallas", "bfloat16")])
def test_forward_matches_jax(monkeypatch, params, route, dtype):
    """Each route against the JAX model on the same route. In bf16 the two
    packages round at the same points of the fused block and of
    instance_norm, but XLA on the CPU may keep an f32 intermediate where
    torch rounds (the conv's bias, the depthwise taps, the pooling and the
    resize), and a U-Net of ~60 normalisations carries such a unit to the
    output: held to 5e-2 of the output's largest magnitude, the rule of the
    whole bf16 TF-GridNet."""
    monkeypatch.setenv("WESEP_CONV2D_PALLAS", "force")
    mix, emb = _inputs(1)
    jdt = jnp.dtype(dtype)
    want, logits = jax.jit(JaxDPCCN(**SMALL, conv_impl=route).apply,
                           static_argnames="train")(
        {"params": params}, jnp.asarray(mix).astype(jdt),
        jnp.asarray(emb).astype(jdt), train=False)
    assert logits is None
    want = np.asarray(want.astype(jnp.float32))
    port = load_jax_params(DPCCN(**SMALL, conv_impl=route), params).eval()
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        est, none = port(torch.from_numpy(mix).to(tdt),
                         torch.from_numpy(emb).to(tdt))
    assert none is None and est.dtype == tdt
    assert tuple(est.shape) == want.shape == (2, SAMPLES)
    got = est.float().numpy()
    scale = np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=5e-4 * scale, rtol=1e-3)
    else:
        assert np.abs(got - want).max() <= 5e-2 * scale


def _count_fused(monkeypatch):
    calls = []
    real = port_dpccn.conv2d_block_in

    def counting(x, *args, **kwargs):
        calls.append(x.shape[-1])
        return real(x, *args, **kwargs)

    monkeypatch.setattr(port_dpccn, "conv2d_block_in", counting)
    return calls


def test_pallas_route_takes_the_fused_block_seven_times(monkeypatch):
    """At the recipe's widths 7 Conv2dBlocks per forward pass the gates
    (a plain 3x3 conv with at most WESEP_CONV2D_CI_GATE = 32 input
    channels); WESEP_CONV2D_PALLAS=0 and the "xla" route take none, a gate
    of 16 only enc0.conv1."""
    calls = _count_fused(monkeypatch)
    mix, emb = _inputs(2, rows=1)
    torch.manual_seed(0)
    model = DPCCN(**SMALL, conv_impl="pallas").eval()
    xla = DPCCN(**SMALL).eval()
    xla.load_state_dict(model.state_dict())
    args = (torch.from_numpy(mix), torch.from_numpy(emb))
    with torch.no_grad():
        fused = model(*args)[0]
        assert calls == [16, 32, 32, 32, 32, 32, 32]
        assert len(calls) == FUSED_PER_FORWARD
        calls.clear()
        plain = xla(*args)[0]
        assert calls == []
        monkeypatch.setenv("WESEP_CONV2D_PALLAS", "0")
        off = model(*args)[0]
        assert calls == []
        monkeypatch.setenv("WESEP_CONV2D_PALLAS", "1")
        monkeypatch.setenv("WESEP_CONV2D_CI_GATE", "16")
        model(*args)
        assert calls == [16]
    assert torch.equal(off, plain)
    torch.testing.assert_close(fused, plain, atol=1e-4 * plain.abs().max(),
                               rtol=0)


def test_padded_rows_do_not_reach_the_kept_rows():
    """bin/infer pads a length bucket with all-zero rows; every statistic
    is per row, so the kept row's output is the one it has alone, and an
    all-zero row gives finite values (var 0 -> the block outputs 0)."""
    mix, emb = _inputs(3, rows=1)
    torch.manual_seed(0)
    port = DPCCN(**SMALL, conv_impl="pallas").eval()
    padded_mix = np.concatenate([mix, np.zeros_like(mix)])
    padded_emb = np.concatenate([emb, emb])
    with torch.no_grad():
        alone = port(torch.from_numpy(mix), torch.from_numpy(emb))[0]
        both = port(torch.from_numpy(padded_mix),
                    torch.from_numpy(padded_emb))[0]
    assert torch.isfinite(both).all()
    torch.testing.assert_close(both[:1], alone, atol=1e-6, rtol=1e-5)


def test_unported_options_raise():
    # every encoder of the registry is ported; an unknown name and the
    # missing-name error remain
    with pytest.raises(NotImplementedError, match="unknown speaker model"):
        DPCCN(**dict(SMALL, joint_training=True, spk_model="XVector_TDNN"))
    with pytest.raises(ValueError, match="requires spk_model"):
        DPCCN(**dict(SMALL, joint_training=True))
    # the JAX class's speaker-branch options are accepted
    DPCCN(**SMALL, multi_task=True, spksInTrain=10, spk_args={},
          spk_feat=False, feat_type="consistent", multi_fuse=True)
