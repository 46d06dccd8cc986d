"""Port parity: CAM++ (wesep_tpu/models/speaker/campplus.py) against the
JAX package on the CPU.

At feat 80 and T = 130 the FCM front end keeps 130 frames and the TDNN's
stride 2 leaves 65, so the ceil-mode segment means (seg_len 100) end on a
partial segment. Eval mode: the embedding within 1e-5 of its largest
value. Train mode (8 rows): every BatchNorm statistic within 1e-5 of its
largest, and the embedding within 2e-4. In train mode each of the ~60
BatchNorms normalises by its batch's single-pass variance (E[x^2] -
E[x]^2 in f32, in both packages), which turns the packages' different
summation orders into differences that grow layer by layer: the pooled
statistics measured 1.4e-5 of their largest, and `dense_bn`, which
normalises the embeddings over the batch's rows, takes that to 7.2e-5
with these weights (8.3e-5 from the JAX package's initialisation; at 2
rows it gives +-1 from a cancelling variance, and 3e-3).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_ecapa import port_variables
from wesep_tpu.models.speaker import get_speaker_model as jax_speaker_model
from wesep_tpu.models.speaker.campplus import _seg_mean as jax_seg_mean
from wesep_tpu_torch.models.speaker import get_speaker_model
from wesep_tpu_torch.models.speaker.campplus import _seg_mean
from wesep_tpu_torch.utils.jax_params import (
    convtasnet_state_dict_from_jax,
    load_jax_params,
)

torch.set_num_threads(1)  # one intra-op thread per test worker

FEAT, FRAMES = 80, 130


def _feats(seed, rows=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((rows, FRAMES, FEAT)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_campplus():
    jm = jax_speaker_model("CAMPPlus")(embed_dim=32)
    torch.manual_seed(0)
    params, stats = port_variables(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(_feats(0)),
                        train=False),
        get_speaker_model("CAMPPlus")(feat_dim=FEAT, embed_dim=32), 11,
        noise=0.02)
    return jm, params, stats


def _port(params, stats):
    model = get_speaker_model("CAMPPlus")(feat_dim=FEAT, embed_dim=32)
    return load_jax_params(model, params, stats)


@pytest.mark.parametrize("train", [False, True])
def test_campplus_matches_jax(jax_campplus, train):
    """The embedding in eval and train mode; after the train call every
    updated statistic against flax's `batch_stats`."""
    jm, params, stats = jax_campplus
    feats = _feats(1 + train, rows=8 if train else 2)
    apply = jax.jit(jm.apply, static_argnames=("train", "mutable"))
    if train:
        want, new = apply({"params": params, "batch_stats": stats},
                          jnp.asarray(feats), train=True,
                          mutable=("batch_stats",))
    else:
        want = apply({"params": params, "batch_stats": stats},
                     jnp.asarray(feats), train=False)
    model = _port(params, stats).train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(feats))
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape == (feats.shape[0], 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=(2e-4 if train else 1e-5)
                               * np.abs(want).max())
    if train:
        buffers = dict(model.named_buffers())
        new_stats = convtasnet_state_dict_from_jax({}, new["batch_stats"])
        assert set(buffers) == set(new_stats)
        for k, w in new_stats.items():
            torch.testing.assert_close(buffers[k], w, rtol=0,
                                       atol=1e-5 * float(w.abs().max()),
                                       msg=k)


@pytest.mark.parametrize("frames", [65, 100, 201])
def test_segment_means_match_jax(frames):
    """Ceil-mode segment means: a partial last segment (65, 201 frames)
    averages only its own frames; 100 frames are one whole segment."""
    x = np.random.default_rng(frames).standard_normal(
        (2, frames, 6)).astype(np.float32)
    want = np.asarray(jax_seg_mean(jnp.asarray(x), 100))
    got = _seg_mean(torch.from_numpy(x), 100).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, -1], x[:, (frames - 1) // 100 * 100:]
                               .mean(axis=1), rtol=0, atol=1e-6)


def test_fcm_flattens_channel_major(jax_campplus):
    """The FCM output [B, T, C * F'] is C-major (torch's (B, C, F', T)
    reshape): channel c's frequencies are columns c * F' .. c * F' + F'-1."""
    _, params, stats = jax_campplus
    model = _port(params, stats).eval()
    x = torch.from_numpy(_feats(3))
    with torch.no_grad():
        out = model.head(x)
        b = model.head
        y = torch.relu(b.bn1(b.conv1(x.transpose(1, 2)[..., None])))
        for name in ("layer1_0", "layer1_1", "layer2_0", "layer2_1"):
            y = getattr(b, name)(y)
        y = torch.relu(b.bn2(b.conv2(y)))  # [B, F', T, C]
    assert out.shape == (2, FRAMES, 32 * 10) == (2, FRAMES, b.out_dim)
    torch.testing.assert_close(out[:, :, 10:20], y[..., 1].transpose(1, 2))
