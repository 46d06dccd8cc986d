"""Port parity: wesep_tpu_torch BSRNN against wesep_tpu BSRNN on the CPU.

The same numpy-seeded params go through the JAX model and, via the weight
bridge (utils/jax_params.py), through the port; the same mixture and
embeddings go into both. The JAX model runs its plain lax.scan LSTM on the
CPU and the port runs the kernel's plain version.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wesep_tpu.models.bsrnn import BSRNN as JaxBSRNN
from wesep_tpu_torch.models import get_model
from wesep_tpu_torch.models.bsrnn import BSRNN
from wesep_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from wesep_tpu_torch.utils.jax_params import (
    bsrnn_state_dict_from_jax,
    load_jax_params,
)

torch.set_num_threads(1)  # one intra-op thread per test worker


def _jax_params(kwargs, mix, emb, seed):
    """JAX init, every leaf perturbed with numpy noise so norms, FiLM and
    biases are all exercised away from their identity init."""
    params = JaxBSRNN(**kwargs).init(
        jax.random.PRNGKey(seed), jnp.asarray(mix), jnp.asarray(emb),
        train=False,
    )["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.standard_normal(p.shape).astype(
            np.float32) * 0.05,
        params,
    )


@pytest.mark.parametrize(
    "fuse_type,multi_fuse,spk_transform",
    [("multiply", False, False), ("concat", True, True)],
)
def test_bsrnn_forward_matches_jax(fuse_type, multi_fuse, spk_transform):
    kwargs = dict(
        spk_emb_dim=32, sr=16000, win=512, stride=128, feature_dim=16,
        num_repeat=2, use_spk_transform=spk_transform,
        spk_fuse_type=fuse_type, multi_fuse=multi_fuse,
        joint_training=False,
    )
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((2, 8000)).astype(np.float32) * 0.1
    emb = rng.standard_normal((2, 32)).astype(np.float32)
    params = _jax_params(kwargs, mix, emb, seed=1)

    want, _ = JaxBSRNN(**kwargs).apply(
        {"params": params}, jnp.asarray(mix), jnp.asarray(emb), train=False
    )
    model = load_jax_params(BSRNN(**kwargs), params).eval()
    with torch.no_grad():
        got, logits = model(torch.from_numpy(mix), torch.from_numpy(emb))
    assert logits is None
    assert got.shape == (2, 8000) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=5e-4, rtol=1e-3)


def test_bsrnn_state_dict_names_match_jax_tree():
    """Every port parameter has a JAX counterpart of the same shape."""
    kwargs = dict(spk_emb_dim=16, feature_dim=8, num_repeat=1,
                  spk_fuse_type="FiLM", use_spk_transform=True,
                  multi_fuse=False, joint_training=False)
    mix = np.zeros((1, 2000), np.float32)
    emb = np.zeros((1, 16), np.float32)
    params = JaxBSRNN(**kwargs).init(
        jax.random.PRNGKey(0), jnp.asarray(mix), jnp.asarray(emb),
        train=False,
    )["params"]
    sd = bsrnn_state_dict_from_jax(params)
    port = BSRNN(**kwargs).state_dict()
    assert sorted(sd) == sorted(port)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(port[k].shape), k


def test_get_model_and_unported_options_raise():
    assert get_model("BSRNN") is BSRNN
    with pytest.raises(NotImplementedError):
        get_model("SepFormer")
    # every encoder of the registry is ported; an unknown name and the
    # missing-name error remain
    with pytest.raises(NotImplementedError, match="unknown speaker model"):
        BSRNN(joint_training=True, spk_model="XVector_TDNN")
    with pytest.raises(ValueError, match="requires spk_model"):
        BSRNN(joint_training=True)
    with pytest.raises(TypeError):
        BSRNN(joint_training=False, feature_dimm=16)


def test_checkpoint_round_trip(tmp_path):
    torch.manual_seed(0)
    model = BSRNN(spk_emb_dim=16, feature_dim=8, num_repeat=1,
                  spk_fuse_type="multiply", use_spk_transform=False,
                  multi_fuse=False, joint_training=False)
    path = str(tmp_path / "model.pt")
    save_checkpoint(path, [model.state_dict()], step=7)
    bundle = load_checkpoint(path)
    assert bundle["step"] == 7
    loaded = bundle["models"][0]
    assert sorted(loaded) == sorted(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(loaded[k], v), k
