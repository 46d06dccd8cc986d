"""Port parity: the joint (v2) BSRNN, TF-GridNet and DPCCN against the JAX
package's on the CPU.

Each model carries a speaker encoder (ResNet18 at m_channels 8 here; the
recipes' ResNet34 differs only in depth) with BatchNorm statistics, all
perturbed with numpy noise and crossed through the weight bridges. The
cue is fbank (`spk_feat: true`, the recipes' setting) or an enrollment
waveform through the "consistent" frontend (`spk_feat: false`), with the
`multi_task` speaker logits. In bf16 the JAX package promotes the stream
after the speaker fuse to f32 (the encoder's embedding is f32), and the
port does the same: each stage's dtype is held against flax's captured
intermediates.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wesep_tpu.models import get_model as jax_get_model
from wesep_tpu_torch.models import get_model
from wesep_tpu_torch.utils.jax_params import (
    convtasnet_state_dict_from_jax,
    load_jax_params,
)

torch.set_num_threads(1)  # one intra-op thread per test worker

FEAT = 24
SPK = dict(spk_model="ResNet18", spk_emb_dim=16, multi_task=True,
           spksInTrain=5,
           spk_args=dict(feat_dim=FEAT, m_channels=8, embed_dim=16,
                         pooling_func="TSTP", two_emb_layer=False))
MODELS = {
    "BSRNN": dict(sr=16000, win=512, stride=128, feature_dim=16,
                  num_repeat=2, use_spk_transform=False,
                  spk_fuse_type="multiply", multi_fuse=False,
                  joint_training=True, remat=False, **SPK),
    "TFGridNet": dict(n_srcs=1, sr=16000, n_fft=64, stride=32, n_layers=2,
                      lstm_hidden_units=16, attn_n_head=2,
                      attn_approx_qk_dim=32, emb_dim=8, emb_ks=2, emb_hs=1,
                      joint_training=True, remat=False, **SPK),
    "DPCCN": dict(win=512, stride=128, tcn_blocks=1, tcn_layers=1,
                  joint_training=True, **SPK),
}
SAMPLES = 8000
# stages whose dtype is compared: before the fuse (bf16 in a bf16 step),
# the encoder, and after the fuse (f32)
STAGES = {
    "BSRNN": {"bn_proj_0": "bfloat16", "spk_model_net": "float32",
              "fuse_0": "float32", "bsnet_0": "float32",
              "mask_out_0": "float32"},
    "TFGridNet": {"conv": "bfloat16", "spk_model": "float32",
                  "spk_fuse": "float32", "block_0": "float32",
                  "deconv": "float32"},
    "DPCCN": {"enc0": "bfloat16", "spk_model": "float32",
              "spk_fuse": "float32", "enc1_conv": "float32",
              "dec7": "float32"},
}


def _inputs(seed, spk_feat, rows=2):
    rng = np.random.default_rng(seed)
    mix = (rng.standard_normal((rows, SAMPLES)) * 0.1).astype(np.float32)
    if spk_feat:
        cue = rng.standard_normal((rows, 60, FEAT)).astype(np.float32)
    else:
        cue = (rng.standard_normal((rows, 6000)) * 0.1).astype(np.float32)
    return mix, cue


def _args(name, spk_feat, **extra):
    return dict(MODELS[name], spk_feat=spk_feat, **extra)


def _jax_variables(name, spk_feat, seed=0, **extra):
    mix, cue = _inputs(seed, spk_feat)
    v = jax_get_model(name)(**_args(name, spk_feat, **extra)).init(
        jax.random.PRNGKey(seed), jnp.asarray(mix), jnp.asarray(cue),
        train=False)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape)
        .astype(np.float32), v["params"])
    stats = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * np.abs(rng.standard_normal(p.shape))
        .astype(np.float32), v["batch_stats"])
    return params, stats


CASES = [(name, spk_feat, "xla") for name in MODELS
         for spk_feat in (True, False)] + [("DPCCN", True, "pallas")]


@pytest.mark.parametrize("name,spk_feat,route", CASES)
def test_joint_forward_matches_jax(monkeypatch, name, spk_feat, route):
    """f32, eval mode: the estimate within 5e-4 of its largest magnitude
    (rtol 1e-3), as the v1 models are held; the speaker logits within
    1e-5 of their largest. DPCCN also on conv_impl "pallas" (the fused
    block's plain versions, the JAX package under WESEP_CONV2D_PALLAS=
    force)."""
    monkeypatch.setenv("WESEP_CONV2D_PALLAS", "force")
    extra = dict(conv_impl=route) if name == "DPCCN" else {}
    params, stats = _jax_variables(name, spk_feat, **extra)
    mix, cue = _inputs(1, spk_feat)
    want, want_logits = jax.jit(
        jax_get_model(name)(**_args(name, spk_feat, **extra)).apply,
        static_argnames="train")(
        {"params": params, "batch_stats": stats}, jnp.asarray(mix),
        jnp.asarray(cue), train=False)
    model = load_jax_params(get_model(name)(**_args(name, spk_feat, **extra)),
                            params, stats).eval()
    with torch.no_grad():
        est, logits = model(torch.from_numpy(mix), torch.from_numpy(cue))
    want, want_logits = np.asarray(want), np.asarray(want_logits)
    assert est.shape == (2, SAMPLES) and logits.shape == (2, 5)
    scale = np.abs(want).max()
    np.testing.assert_allclose(est.numpy(), want, atol=5e-4 * scale,
                               rtol=1e-3)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0,
                               atol=1e-5 * np.abs(want_logits).max())


def _jax_stage_dtypes(name, params, stats, mix, cue):
    """Each stage's output dtype and the estimate's, by abstract
    evaluation."""
    def run(mix, cue):
        return jax_get_model(name)(**_args(name, True)).apply(
            {"params": params, "batch_stats": stats}, mix, cue, train=False,
            capture_intermediates=True, mutable=["intermediates"])

    (est, _), inter = jax.eval_shape(run, mix, cue)
    dtypes = {stage: str(inter["intermediates"][stage]["__call__"][0].dtype)
              for stage in STAGES[name]}
    return dtypes, str(est.dtype)


@pytest.mark.parametrize("name", list(MODELS))
def test_bf16_promotes_after_the_speaker_fuse_as_jax(name):
    """A bf16 mixture and fbank: the stages before the fuse run in bf16,
    the encoder, the fuse and everything after it in f32, in both
    packages, and the estimate comes out f32. Values: the front end before
    the fuse rounds at other points on the two sides (XLA on the CPU may
    keep an f32 intermediate where torch rounds), so the estimate is held
    to 5e-2 of its largest magnitude, the rule of the bf16 v1 models,
    against the JAX model in bf16; for BSRNN, whose bf16 x bf16 -> f32
    band products XLA's CPU backend cannot run, against the JAX model in
    f32 on the same bf16-rounded inputs."""
    params, stats = _jax_variables(name, True)
    mix, cue = _inputs(2, True)
    jmix = jnp.asarray(mix, jnp.bfloat16)
    jcue = jnp.asarray(cue, jnp.bfloat16)
    want_dtypes, want_dtype = _jax_stage_dtypes(name, params, stats, jmix,
                                                jcue)
    assert want_dtypes == STAGES[name] and want_dtype == "float32"
    if name == "BSRNN":
        jmix, jcue = jmix.astype(jnp.float32), jcue.astype(jnp.float32)
    want, _ = jax.jit(jax_get_model(name)(**_args(name, True)).apply,
                      static_argnames="train")(
        {"params": params, "batch_stats": stats}, jmix, jcue, train=False)

    model = load_jax_params(get_model(name)(**_args(name, True)),
                            params, stats).eval()
    seen = {}

    def record(stage):
        def hook(module, args, out):
            out = out[0] if isinstance(out, tuple) else out
            seen[stage] = str(out.dtype).split(".")[-1]
        return hook

    for stage in STAGES[name]:
        getattr(model, stage).register_forward_hook(record(stage))
    with torch.no_grad():
        est, _ = model(torch.from_numpy(mix).bfloat16(),
                       torch.from_numpy(cue).bfloat16())
    assert seen == want_dtypes
    assert est.dtype == torch.float32
    want = np.asarray(want)
    err = np.abs(est.numpy() - want).max() / np.abs(want).max()
    assert err <= 5e-2, err


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("transform", [False, True])
def test_joint_widths_follow_the_encoder(name, transform):
    """An encoder whose embedding (12) is narrower than spk_emb_dim (16):
    flax sizes the speaker transform's input and, without the transform,
    the fuse's input from the embedding; the port's state_dict has the
    JAX tree's names and shapes (by abstract evaluation of its init)."""
    spk_args = dict(SPK["spk_args"], embed_dim=12)
    extra = dict(spk_args=spk_args, use_spk_transform=transform)
    if name == "BSRNN":
        extra["multi_fuse"] = True
    mix, cue = _inputs(0, True)
    tree = jax.eval_shape(
        lambda m, c: jax_get_model(name)(**_args(name, True, **extra)).init(
            jax.random.PRNGKey(0), m, c, train=False),
        jnp.asarray(mix), jnp.asarray(cue))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)
    want = {k: tuple(v.shape) for k, v in convtasnet_state_dict_from_jax(
        zeros["params"], zeros["batch_stats"]).items()}
    port = get_model(name)(**_args(name, True, **extra))
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    assert got["pred_linear.kernel"] == (12, 5)
