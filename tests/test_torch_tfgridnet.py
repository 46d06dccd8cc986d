"""Port parity: the whole TF-GridNet against the JAX model.

The same numpy-seeded mixture and embeddings go through
wesep_tpu.models.tfgridnet.TFGridNet and, through the weight bridge
`tfgridnet_state_dict_from_jax`, through the port's TFGridNet at a small
size (two blocks, H 16, emb_dim 8). The JAX model runs its plain lax.scan
LSTM on the CPU; the port runs the plain versions of its CUDA kernels, on
either route of WESEP_LSTM_UNFOLD (the unfold-fused layer, or the unfold in
torch ops and the plain layer), which compute the same arithmetic and must
give identical outputs. Limits are relative to the output's largest
magnitude: 1e-5 in f32 (the same arithmetic in another order through two
blocks of four BiLSTMs, an attention and the (i)STFT); in bf16 5e-2, since
the JAX scan rounds x @ Wx to bf16 before the recurrence, where the port
keeps it in f32 as its kernels do, and that rounding travels through every
later layer.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wesep_tpu.models.tfgridnet import TFGridNet as JaxTFGridNet
from wesep_tpu_torch.models import get_model
from wesep_tpu_torch.models.tfgridnet import TFGridNet
from wesep_tpu_torch.utils.jax_params import (
    load_jax_params,
    tfgridnet_state_dict_from_jax,
)

torch.set_num_threads(1)  # one intra-op thread per test worker

SMALL = dict(n_fft=32, stride=16, n_layers=2, lstm_hidden_units=16,
             attn_n_head=2, attn_approx_qk_dim=32, emb_dim=8, emb_ks=4,
             emb_hs=1, spk_emb_dim=12, spk_fuse_type="multiply",
             joint_training=False)
SAMPLES = 800
# the configurations the parity test covers: the v1 layout, the scan tree
# with the speaker transform and a Hamming window, the reshape branch
# (emb_ks == emb_hs) and a hop above one
VARIANTS = {
    "unrolled": {},
    "scan": dict(scan_layers=True, use_spk_transform=True, window="hamming",
                 spk_fuse_type="FiLM"),
    "ks_eq_hs": dict(emb_ks=2, emb_hs=2, spk_fuse_type="additive"),
    "hs2": dict(emb_ks=4, emb_hs=2, spk_fuse_type="concat"),
}


def _inputs(seed, rows=2):
    rng = np.random.default_rng(seed)
    mix = (rng.standard_normal((rows, SAMPLES)) * 0.1).astype(np.float32)
    emb = rng.standard_normal((rows, 12)).astype(np.float32)
    return mix, emb


def _jax_params(args, mix, emb, seed=0):
    """JAX init with every leaf perturbed by numpy noise, so norms, PReLU
    slopes and biases are exercised away from their identity init."""
    params = JaxTFGridNet(**args).init(
        jax.random.PRNGKey(seed), jnp.asarray(mix), jnp.asarray(emb),
        train=False)["params"]
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.standard_normal(p.shape).astype(
            np.float32) * 0.05, params)


def _close(got, want, limit):
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= limit * np.abs(want).max(), err


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_state_dict_names_match_the_jax_tree(variant):
    """Every leaf of the JAX tree (unrolled or the scan tree's stacked
    `blocks.block`) lands on a port parameter of its shape; loading is
    strict."""
    args = dict(SMALL, **VARIANTS[variant])
    mix, emb = _inputs(0)
    params = _jax_params(args, mix, emb)
    assert ("blocks" in params) == bool(args.get("scan_layers"))
    sd = tfgridnet_state_dict_from_jax(params)
    port = TFGridNet(**args)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert get_model("TFGridNet") is TFGridNet
    with pytest.raises(RuntimeError, match="Missing key"):
        port.load_state_dict({k: v for k, v in sd.items()
                              if not k.startswith("block_1.")})


@pytest.mark.parametrize("variant,dtype", [
    ("unrolled", "float32"), ("scan", "float32"), ("ks_eq_hs", "float32"),
    ("hs2", "float32"), ("unrolled", "bfloat16"),
])
def test_forward_matches_jax_on_both_routes(monkeypatch, variant, dtype):
    args = dict(SMALL, **VARIANTS[variant])
    mix, emb = _inputs(1)
    params = _jax_params(args, mix, emb, seed=2)
    jdt = jnp.dtype(dtype)
    want, logits = jax.jit(JaxTFGridNet(**args).apply, static_argnames="train")(
        {"params": params}, jnp.asarray(mix).astype(jdt),
        jnp.asarray(emb).astype(jdt), train=False)
    assert logits is None
    port = load_jax_params(TFGridNet(**args), params).eval()
    tdt = getattr(torch, dtype)
    outs = []
    for route in ("1", "0"):
        monkeypatch.setenv("WESEP_LSTM_UNFOLD", route)
        with torch.no_grad():
            est, none = port(torch.from_numpy(mix).to(tdt),
                             torch.from_numpy(emb).to(tdt))
        assert none is None and est.dtype == tdt
        assert tuple(est.shape) == want.shape == (2, SAMPLES)
        outs.append(est)
    assert torch.equal(outs[0], outs[1])
    _close(outs[0], want, 1e-5 if dtype == "float32" else 5e-2)


def test_padded_rows_do_not_reach_the_kept_rows():
    """bin/infer pads a length bucket with all-zero rows; their mix_std is
    0, so their outputs are not finite and are dropped. No layer mixes
    rows: the kept row's output is the one it has alone."""
    mix, emb = _inputs(3, rows=1)
    torch.manual_seed(0)
    port = TFGridNet(**SMALL).eval()
    padded_mix = np.concatenate([mix, np.zeros_like(mix)])
    padded_emb = np.concatenate([emb, emb])
    with torch.no_grad():
        alone = port(torch.from_numpy(mix), torch.from_numpy(emb))[0]
        both = port(torch.from_numpy(padded_mix),
                    torch.from_numpy(padded_emb))[0]
    assert torch.isfinite(alone).all()
    torch.testing.assert_close(both[:1], alone, atol=1e-6, rtol=1e-5)


def test_unported_options_raise():
    # every encoder of the registry is ported; an unknown name and the
    # missing-name error remain
    with pytest.raises(NotImplementedError, match="unknown speaker model"):
        TFGridNet(**dict(SMALL, joint_training=True,
                         spk_model="XVector_TDNN"))
    with pytest.raises(ValueError, match="requires spk_model"):
        TFGridNet(**dict(SMALL, joint_training=True))
    with pytest.raises(NotImplementedError, match="concat"):
        TFGridNet(**dict(SMALL, scan_layers=True, spk_fuse_type="concat"))
    with pytest.raises(TypeError, match="unknown"):
        TFGridNet(**dict(SMALL, no_such_option=1))
    # JAX-only compilation and sharding options are accepted and ignored
    TFGridNet(**dict(SMALL, remat=False, shard_model_axis=True))
