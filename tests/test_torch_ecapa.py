"""Port parity: ECAPA-TDNN in its two layouts (the tpu layout of
wesep_tpu/models/speaker/ecapa.py and wespeaker's of ecapa_ws.py) against
the JAX package on the CPU.

Each encoder is built at 32 channels from the port's seeded
initialisation, every parameter and BatchNorm statistic is perturbed with
numpy noise and carried into the JAX tree, and both packages run
the same fbank: in eval mode (the statistics) and in train mode (the
batch's statistics), for the embedding and for the frame-level features
(`return_frame_feats`), and the port's updated buffers are held against
the `batch_stats` flax returns. Tolerance: 1e-5 of the largest output.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wesep_tpu.models.speaker import get_speaker_model as jax_speaker_model
from wesep_tpu_torch.models.speaker import get_speaker_model
from wesep_tpu_torch.utils.jax_params import (
    convtasnet_state_dict_from_jax,
    load_jax_params,
)

torch.set_num_threads(1)  # one intra-op thread per test worker

FEAT = 24
# (name, layout, emb_bn)
CASES = [("ECAPA_TDNN_c32", "tpu", False),
         ("ECAPA_TDNN_GLOB_c32", "tpu", False),
         ("ECAPA_TDNN_c32", "wespeaker", False),
         ("ECAPA_TDNN_c32", "wespeaker", True),
         ("ECAPA_TDNN_GLOB_c32", "wespeaker", False),
         ("ECAPA_TDNN_GLOB_c32", "wespeaker", True)]


def _feats(seed, rows=3, frames=40):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((rows, frames, FEAT)).astype(np.float32)


def _args(layout, emb_bn):
    return dict(embed_dim=16, layout=layout, emb_bn=emb_bn)


def port_variables(jax_init, port_model, seed, noise=0.05):
    """The JAX variables (params, batch_stats) of `port_model`'s weights,
    each parameter perturbed by `noise` * N(0, 1) and each statistic by
    0.1 * |N(0, 1)| (numpy, from `seed`): the tree's names and shapes
    come from `jax.eval_shape(jax_init)`, so no JAX initialisation is
    compiled (its compile took 2-20 s a model)."""
    shapes = jax.eval_shape(jax_init)
    weights = port_model.state_dict()
    rng = np.random.default_rng(seed)

    def tree(node, prefix, perturb):
        out = {}
        for k, v in node.items():
            if hasattr(v, "items"):
                out[k] = tree(v, f"{prefix}{k}.", perturb)
            else:
                w = weights[prefix + k].numpy()
                assert w.shape == v.shape, prefix + k
                out[k] = w + perturb(rng.standard_normal(w.shape)).astype(
                    np.float32)
        return out

    return (tree(shapes["params"], "", lambda z: noise * z),
            tree(shapes.get("batch_stats", {}), "",
                 lambda z: 0.1 * np.abs(z)))


@functools.lru_cache(maxsize=None)
def _jax_model(name, layout, emb_bn, seed=0):
    jm = jax_speaker_model(name)(**_args(layout, emb_bn))
    torch.manual_seed(seed)
    params, stats = port_variables(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(_feats(seed)),
                        train=False),
        get_speaker_model(name)(feat_dim=FEAT, **_args(layout, emb_bn)),
        seed + 7)
    return jm, params, stats


def _port(name, layout, emb_bn, params, stats):
    model = get_speaker_model(name)(feat_dim=FEAT, **_args(layout, emb_bn))
    return load_jax_params(model, params, stats)


def _close(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("frames", [False, True])
@pytest.mark.parametrize("name,layout,emb_bn", CASES)
def test_ecapa_eval_matches_jax(name, layout, emb_bn, frames):
    """Eval mode, f32: the embedding [B, 16] or the frame features (the
    last block's output [B, T, 32] in the tpu layout, the post-conv
    [B, T, 96] in wespeaker's)."""
    feats = _feats(1)
    jm, params, stats = _jax_model(name, layout, emb_bn)
    want = jm.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(feats), train=False,
                    return_frame_feats=frames)
    model = _port(name, layout, emb_bn, params, stats).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(feats), return_frame_feats=frames)
    assert got.shape[-1] == (model.frame_dim if frames else 16)
    _close(got, want)


@pytest.mark.parametrize("frames", [False, True])
@pytest.mark.parametrize("name,layout,emb_bn", CASES)
def test_ecapa_train_matches_jax_and_its_statistics(name, layout, emb_bn,
                                                    frames):
    """Train mode: the output from the batch's statistics, and every
    BatchNorm statistic after the call against flax's `batch_stats`
    (those the frame-feature call does not reach stay as they were on
    both sides). 8 rows: the BatchNorms after the pooling normalise
    utterance-level vectors over the batch's rows, and over few rows
    their single-pass variance (both packages') cancels and amplifies
    rounding: the embedding measured 2.3e-5 .. 2.5e-4 of its largest at 3
    rows, 2.4e-6 .. 8.3e-6 at 8 (these weights; 5.4e-5 .. 8.3e-5 and
    3.8e-6 .. 6.1e-6 from the JAX package's initialisation); the frame
    features 6e-7 .. 9e-7 at either."""
    feats = _feats(2, rows=8)
    jm, params, stats = _jax_model(name, layout, emb_bn, seed=3)
    want, new = jm.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(feats), train=True,
                         return_frame_feats=frames, mutable=["batch_stats"])
    model = _port(name, layout, emb_bn, params, stats).train()
    with torch.no_grad():
        got = model(torch.from_numpy(feats), return_frame_feats=frames)
    _close(got, want)
    buffers = dict(model.named_buffers())
    new_stats = convtasnet_state_dict_from_jax({}, new["batch_stats"])
    assert set(buffers) == set(new_stats)
    for k, w in new_stats.items():
        torch.testing.assert_close(buffers[k], w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()), msg=k)


@pytest.mark.parametrize("layout", ["tpu", "wespeaker"])
def test_bf16_fbank_gives_f32_outputs(layout):
    """A bf16 fbank: the first convs compute in bf16 (the tpu layout casts
    each BN back to its input's dtype up to the first SE block's f32
    dense layers; wespeaker's BNs return f32), and the frame features
    come out f32 in both packages, within 1e-5 of the largest."""
    feats = _feats(4)
    jm, params, stats = _jax_model("ECAPA_TDNN_GLOB_c32", layout, False)
    half = jnp.asarray(feats, jnp.bfloat16)
    want = jm.apply({"params": params, "batch_stats": stats}, half,
                    train=False, return_frame_feats=True)
    assert want.dtype == jnp.float32
    model = _port("ECAPA_TDNN_GLOB_c32", layout, False, params, stats).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(feats).bfloat16(),
                    return_frame_feats=True)
    assert got.dtype == torch.float32
    _close(got, want)


def test_headless_encoder_gives_frame_features_only():
    """`head=False` (a model that only takes frame features) holds no
    pooling, BN or linear, and refuses to embed."""
    for layout, gone in (("tpu", "conv_agg"), ("wespeaker", "pool")):
        model = get_speaker_model("ECAPA_TDNN_c32")(
            feat_dim=FEAT, embed_dim=16, layout=layout, head=False)
        names = {k.split(".")[0] for k in model.state_dict()}
        assert gone not in names and "linear" not in names
        x = torch.from_numpy(_feats(5))
        assert model(x, return_frame_feats=True).shape[:2] == (3, 40)
        with pytest.raises(ValueError, match="frame features only"):
            model(x)


@pytest.mark.parametrize("name,channels", [("ECAPA_TDNN_c512", 512),
                                           ("ECAPA_TDNN_GLOB_c512", 512),
                                           ("ECAPA_TDNN_GLOB_c1024", 1024)])
def test_registry_names_build_the_jax_tree(name, channels):
    """The recipes' names parse as the JAX registry parses them: the
    channels from `c<N>`, the global context from `_GLOB`; the port's
    state_dict has the JAX tree's names and shapes (tpu layout)."""
    jm = jax_speaker_model(name)(embed_dim=192)
    shapes = jax.eval_shape(
        lambda x: jm.init(jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((2, 20, 80), jnp.float32))
    want = {k: tuple(v.shape) for k, v in convtasnet_state_dict_from_jax(
        *(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                 shapes[c])
          for c in ("params", "batch_stats"))).items()}
    model = get_speaker_model(name)(feat_dim=80, embed_dim=192)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert model.frame_dim == channels
    assert model.pool.global_context == ("_GLOB" in name)
