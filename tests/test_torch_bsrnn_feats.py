"""Port parity: BSRNN_Feats (wesep_tpu/models/bsrnn_feats.py) against the
JAX package on the CPU.

The TF maps (`tfmap_spec`: scored by the magnitudes; `tfmap_emb`: by the
ECAPA-TDNN's frame-level features of the two waveforms' fbank), the
cross-attention fusion (`cross_<t>`, with and without `multi_fuse`) over
the joint encoder's frame features or over a frame-level cue, and an
embedding fuse beside a TF map. The weights are the port's seeded
initialisation, every parameter and BatchNorm statistic perturbed with
numpy noise, in the JAX tree (`port_variables`; the port loads them back
through the weight bridge). f32 forwards are held within 5e-4 of the
estimate's largest magnitude (rtol 1e-3), as the other BSRNNs; two
train steps of the recipe's shape (tfmap_emb + cross_multiply,
`spk_model_freeze`) against the JAX package's `make_train_step` at
losses rtol 1e-4, with the encoder frozen bit for bit and its statistics
moved twice a step; in bf16 each stage's dtype against flax's captured
intermediates.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_ecapa import port_variables
from test_torch_joint_train import SCHED, _assert_stats, _flat, _overrides
from test_torch_spex_train import _write_set
from wesep_tpu.models import get_model as jax_get_model
from wesep_tpu.models.bsrnn_feats import _tfmap as jax_tfmap
from wesep_tpu.train import trainer as jax_trainer
from wesep_tpu.train.losses import parse_loss as jax_parse_loss
from wesep_tpu.train.schedulers import exponential_decrease as jax_exp
from wesep_tpu_torch.bin import average_model
from wesep_tpu_torch.bin.infer import infer
from wesep_tpu_torch.bin.train import train
from wesep_tpu_torch.models import get_model
from wesep_tpu_torch.models.bsrnn_feats import tfmap
from wesep_tpu_torch.ops.fbank import apply_cmvn, kaldi_fbank
from wesep_tpu_torch.train import trainer
from wesep_tpu_torch.train.checkpoint import load_checkpoint
from wesep_tpu_torch.train.losses import parse_loss
from wesep_tpu_torch.train.schedulers import exponential_decrease
from wesep_tpu_torch.utils.jax_params import load_jax_params

torch.set_num_threads(1)  # one intra-op thread per test worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "examples/librimix/tse/v2/confs/bsrnn_feats.yaml")

FEAT, FRAME_DIM, SAMPLES, ENROLL = 24, 20, 6000, 4800
ECAPA = dict(spk_model="ECAPA_TDNN_GLOB_c32", spk_emb_dim=16,
             spk_args=dict(feat_dim=FEAT, embed_dim=16, pooling_func="ASTP"))
BASE = dict(sr=16000, win=512, stride=128, feature_dim=16, num_repeat=2,
            use_spk_transform=False, spk_feat=False, feat_type="consistent",
            multi_task=False, remat=False)
# name -> (model arguments, cue kind); the recipe's case is "emb_cross"
CASES = {
    "spec_embed": dict(spectral_feat="tfmap_spec", spk_fuse_type="multiply",
                       multi_fuse=False, joint_training=True, **ECAPA),
    "frame_cue_cross": dict(spectral_feat=None,
                            spk_fuse_type="cross_multiply", multi_fuse=True,
                            joint_training=False, spk_emb_dim=16,
                            spk_emb_frame_dim=FRAME_DIM),
    "emb_cross": dict(spectral_feat="tfmap_emb",
                      spk_fuse_type="cross_multiply", multi_fuse=False,
                      joint_training=True, spk_model_freeze=True, **ECAPA),
    "emb_cross_multi": dict(spectral_feat="tfmap_emb",
                            spk_fuse_type="cross_multiply", multi_fuse=True,
                            joint_training=True, **ECAPA),
    "spec_cross_concat_ws": dict(
        spectral_feat="tfmap_spec", spk_fuse_type="cross_concat",
        multi_fuse=True, joint_training=True,
        **dict(ECAPA, spk_args=dict(ECAPA["spk_args"], layout="wespeaker"))),
}


def _args(case):
    return dict(BASE, **CASES[case])


def _inputs(case, seed, rows=2):
    rng = np.random.default_rng(seed)
    mix = (rng.standard_normal((rows, SAMPLES)) * 0.1).astype(np.float32)
    if CASES[case]["joint_training"]:
        cue = (rng.standard_normal((rows, ENROLL)) * 0.1).astype(np.float32)
    else:
        cue = rng.standard_normal((rows, 30, FRAME_DIM)).astype(np.float32)
    return mix, cue


def _jax_variables(case, seed=0):
    mix, cue = _inputs(case, seed)
    torch.manual_seed(seed)
    return port_variables(
        lambda: jax_get_model("BSRNN_Feats")(**_args(case)).init(
            jax.random.PRNGKey(seed), jnp.asarray(mix), jnp.asarray(cue),
            train=False),
        get_model("BSRNN_Feats")(**_args(case)), seed + 100)


def _port(case, params, stats):
    return load_jax_params(get_model("BSRNN_Feats")(**_args(case)), params,
                           stats)


@pytest.mark.parametrize("case", list(CASES))
def test_bsrnn_feats_forward_matches_jax(case):
    """f32, eval mode: the estimate within 5e-4 of its largest magnitude
    (rtol 1e-3); the strict bridge loads every name (a cross model has no
    embedding fuse, speaker transform or encoder head on either side)."""
    params, stats = _jax_variables(case)
    mix, cue = _inputs(case, 1)
    want, want_logits = jax.jit(
        jax_get_model("BSRNN_Feats")(**_args(case)).apply,
        static_argnames="train")(
        {"params": params, "batch_stats": stats}, jnp.asarray(mix),
        jnp.asarray(cue), train=False)
    model = _port(case, params, stats).eval()
    with torch.no_grad():
        est, logits = model(torch.from_numpy(mix), torch.from_numpy(cue))
    assert logits is None and want_logits is None
    want = np.asarray(want)
    assert est.shape == want.shape == (2, SAMPLES)
    np.testing.assert_allclose(est.numpy(), want, rtol=1e-3,
                               atol=5e-4 * np.abs(want).max())


@pytest.mark.parametrize("scored", [False, True])
def test_tfmap_matches_jax(scored):
    """The TF map alone, scored by the magnitudes or by frame features,
    with a silent enrollment frame (eps of the unit norm): within 1e-5 of
    its largest value."""
    rng = np.random.default_rng(3)
    mix = np.abs(rng.standard_normal((2, 40, 33))).astype(np.float32)
    enr = np.abs(rng.standard_normal((2, 30, 33))).astype(np.float32)
    enr[:, 4] = 0.0
    q = rng.standard_normal((2, 40, 12)).astype(np.float32) if scored \
        else None
    k = rng.standard_normal((2, 30, 12)).astype(np.float32) if scored \
        else None
    jq, jk = (None, None) if not scored else (jnp.asarray(q), jnp.asarray(k))
    want = np.asarray(jax_tfmap(jnp.asarray(mix), jnp.asarray(enr), jq, jk))
    tq, tk = (None, None) if not scored else (torch.from_numpy(q),
                                              torch.from_numpy(k))
    got = tfmap(torch.from_numpy(mix), torch.from_numpy(enr), tq, tk).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


STAGES = {"bn_proj_0": "bfloat16", "spk_model_net": "float32",
          "cross_proj": "float32", "cross_att": "float32",
          "cross_fuse_0": "float32", "bsnet_0": "float32",
          "mask_out_0": "float32"}


def test_bf16_promotes_after_the_cross_fuse_as_jax():
    """A bf16 mixture and enrollment (the recipe's tfmap_emb +
    cross_multiply): the band features stay bf16, the encoder (its fbank is
    f32), the projection, the attention, the fuse and every stage after it
    run in f32 in both packages, so the separator's BiLSTMs take f32.
    Values against the JAX model in f32 on the same bf16-rounded inputs
    (XLA's CPU backend cannot run BSRNN's bf16 x bf16 -> f32 band
    products), within 5e-2 of the largest magnitude, the rule of the bf16
    joint models."""
    case = "emb_cross"
    params, stats = _jax_variables(case)
    mix, cue = _inputs(case, 2)
    jmix = jnp.asarray(mix, jnp.bfloat16)
    jcue = jnp.asarray(cue, jnp.bfloat16)
    jmodel = jax_get_model("BSRNN_Feats")(**_args(case))

    def run(m, c):
        return jmodel.apply({"params": params, "batch_stats": stats}, m, c,
                            train=False, capture_intermediates=True,
                            mutable=["intermediates"])

    (jest, _), inter = jax.eval_shape(run, jmix, jcue)
    want_dtypes = {s: str(inter["intermediates"][s]["__call__"][0].dtype)
                   for s in STAGES}
    assert want_dtypes == STAGES and str(jest.dtype) == "float32"
    want, _ = jax.jit(jmodel.apply, static_argnames="train")(
        {"params": params, "batch_stats": stats},
        jmix.astype(jnp.float32), jcue.astype(jnp.float32), train=False)

    model = _port(case, params, stats).eval()
    seen = {}

    def record(stage):
        def hook(module, args, out):
            out = out[0] if isinstance(out, tuple) else out
            seen[stage] = str(out.dtype).split(".")[-1]
        return hook

    for stage in STAGES:
        getattr(model, stage).register_forward_hook(record(stage))
    with torch.no_grad():
        est, _ = model(torch.from_numpy(mix).bfloat16(),
                       torch.from_numpy(cue).bfloat16())
    assert seen == want_dtypes
    assert est.dtype == torch.float32
    want = np.asarray(want)
    err = np.abs(est.numpy() - want).max() / np.abs(want).max()
    assert err <= 5e-2, err


def _batch(seed, rows=4):
    """Rows as the collator makes them: each mixture of two sources twice,
    with each source as the target, and a raw enrollment waveform."""
    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((rows // 2, 2, SAMPLES)) * 0.1).astype(
        np.float32)
    return {"wav_mix": np.repeat(src.sum(axis=1), 2, axis=0),
            "wav_targets": src.reshape(rows, SAMPLES),
            "spk_embeds": (rng.standard_normal((rows, ENROLL)) * 0.1)
            .astype(np.float32)}


def test_two_recipe_shaped_train_steps_match_jax():
    """Two f32 train steps of tfmap_emb + cross_multiply with
    `spk_model_freeze` from the same parameters, statistics and batch:
    losses rtol 1e-4; the encoder's statistics after each step within 1e-4
    of the largest, as for the joint BSRNN; its parameters unchanged bit
    for bit in both packages; the rest trained. A step runs the encoder
    twice in train mode, on the mixture's fbank and then on the
    enrollment's: the statistics after the first step are those two calls
    of the encoder alone, bit for bit."""
    case = "emb_cross"
    batch = _batch(0)
    params, stats = _jax_variables(case)
    freeze = ("spk_model_net",)

    tx = jax_trainer.make_optimizer(jax_exp(**SCHED), weight_decay=1e-4,
                                    clip_grad=5.0, freeze_prefixes=freeze)
    jstate = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=tx.init(params))
    step_fn = jax.jit(jax_trainer.make_train_step(
        jax_get_model("BSRNN_Feats")(**_args(case)), tx,
        jax_parse_loss("SISDR")))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = []
    for _ in range(2):
        jstate, metrics = step_fn(jstate, jbatch)
        want.append((float(metrics["loss"]), _flat(jstate.batch_stats),
                     _flat(jstate.params)))

    model = _port(case, params, stats)
    encoder = _port(case, params, stats).spk_model_net.train()
    opt = trainer.make_optimizer(model, exponential_decrease(**SCHED),
                                 weight_decay=1e-4, clip_grad=5.0,
                                 freeze_prefixes=freeze)
    state = trainer.TrainState(model=model, optimizer=opt)
    step = trainer.make_train_step(parse_loss("SISDR"))
    tbatch = trainer.batch_to_device(batch, "cpu")
    got = []
    for _ in range(2):
        state, metrics = step(state, tbatch)
        got.append((float(metrics["loss"]),
                    {k: v.clone().numpy() for k, v in model.named_buffers()
                     if k.endswith((".mean", ".var"))},
                    {k: v.detach().clone().numpy()
                     for k, v in model.named_parameters()}))
        if len(got) == 1:  # the encoder alone: mixture, then enrollment
            with torch.no_grad():
                for wav in (tbatch["wav_mix"], tbatch["spk_embeds"]):
                    encoder(apply_cmvn(kaldi_fbank(torch.nn.functional.pad(
                        wav[:, None], (256, 256), mode="reflect")[:, 0],
                        **model.fbank_args)), return_frame_feats=True)
            for k, v in encoder.named_buffers():
                np.testing.assert_array_equal(
                    got[0][1]["spk_model_net." + k], v.numpy(), err_msg=k)

    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-4)
    for g, w in zip(got, want):
        _assert_stats(g[1], w[1], 1e-4)
    before = _flat(params)
    frozen = [k for k in before if k.startswith("spk_model_net.")]
    assert frozen and {k: before[k].shape for k in frozen} == {
        k: v.shape for k, v in got[-1][2].items()
        if k.startswith("spk_model_net.")}
    for side in (got[-1][2], want[-1][2]):
        assert all(np.array_equal(side[k], before[k]) for k in frozen)
        assert not np.array_equal(side["cross_proj.kernel"],
                                  before["cross_proj.kernel"])
    lr = SCHED["initial_lr"]
    for k, w in want[-1][2].items():
        diff = np.abs(got[-1][2][k] - w)
        assert diff.max() <= 2 * lr and diff.mean() <= 0.1 * lr, k


def test_registry_and_options():
    """get_model builds BSRNN_Feats; a frame-level cue needs ECAPA's
    frame features, tfmap_emb the joint encoder."""
    model = get_model("BSRNN_Feats")(**_args("emb_cross"))
    assert model._spec_map() == 3 and model.cross
    assert not any(k.startswith(("fuse_", "spk_transform", "pred_linear",
                                 "spk_model_net.linear"))
                   for k in model.state_dict())
    with pytest.raises(ValueError, match="no frame-level features"):
        get_model("BSRNN_Feats")(**dict(_args("emb_cross"),
                                        spk_model="ResNet18"))
    with pytest.raises(ValueError, match="needs the joint"):
        get_model("BSRNN_Feats")(**dict(_args("emb_cross"),
                                        joint_training=False))
    with pytest.raises(ValueError, match="unknown spectral_feat"):
        get_model("BSRNN_Feats")(**dict(_args("emb_cross"),
                                        spectral_feat="tfmap_x"))


def test_recipe_conf_train_average_infer(tmp_path):
    """The librimix v2 bsrnn_feats.yaml (raw 6 s enrollments cut to 0.3 s
    here, tfmap_emb + cross_multiply, spk_model_freeze, compute_dtype
    bfloat16) through bin/train for two epochs of two steps at a narrow
    width (ECAPA at 32 channels, feature_dim 16, one repeat),
    bin/average_model and bin/infer: finite losses, the frozen encoder's
    parameters equal in both checkpoints while its statistics moved, finite
    scores and one wav per target."""
    import yaml

    root = str(tmp_path)
    rng = np.random.default_rng(0)
    tr = _write_set(root, "train", n_mix=6, n_samples=4000, rng=rng)
    va = _write_set(root, "dev", n_mix=4, n_samples=3000, rng=rng)
    overrides = [o for o in _overrides(root, tr, va)
                 if "m_channels" not in o]
    overrides.append("model_args.tse_model.spk_model=ECAPA_TDNN_GLOB_c32")
    state = train(RECIPE, overrides=overrides)
    assert state.step == 4
    models = os.path.join(root, "exp", "models")
    first, last = (load_checkpoint(os.path.join(models, f"checkpoint_{e}"
                                                ".ckpt")) for e in (1, 2))
    encoder = [k for k in last["models"][0] if k.startswith("spk_model_net.")]
    assert encoder and not any(".linear" in k or "pool" in k for k in encoder)
    for k in encoder:
        assert torch.equal(first["models"][0][k], last["models"][0][k]), k
    assert not torch.equal(first["models"][0]["cross_proj.kernel"],
                           last["models"][0]["cross_proj.kernel"])
    assert any(not torch.equal(v, last["batch_stats"][0][k])
               for k, v in first["batch_stats"][0].items())
    dst = os.path.join(root, "avg_model.ckpt")
    average_model.main(["--dst_model", dst, "--src_path", models,
                        "--num", "2"])
    with open(RECIPE) as f:
        conf = yaml.safe_load(f)
    model_args = dict(conf["model_args"]["tse_model"], feature_dim=16,
                      num_repeat=1, spk_emb_dim=16,
                      spk_model="ECAPA_TDNN_GLOB_c32",
                      spk_args=dict(conf["model_args"]["tse_model"]
                                    ["spk_args"], embed_dim=16))
    out = os.path.join(root, "exp_infer")
    sisnr, sisnri = infer(
        {"model": conf["model"], "model_args": {"tse_model": model_args},
         "data_type": "shard",
         "dataset_args": dict(conf["dataset_args"], enroll_sec=0.3)},
        checkpoint=dst, exp_dir=out, device="cpu", length_bucket=1000,
        test_data=va["list"], test_spk2utt=va["enroll_wav.scp"],
        test_spk1_enroll=va["spk1_enroll"],
        test_spk2_enroll=va["spk2_enroll"])
    assert np.isfinite(sisnr) and np.isfinite(sisnri)
    wavs = [n for n in os.listdir(os.path.join(out, "audio"))
            if n.endswith(".wav")]
    assert len(wavs) == 8  # 4 mixtures x 2 targets


def test_f32_kernel_gates_take_the_train_shapes():
    """The recipe's train step (4 rows x 3 s) gives K0 f32 shapes band T
    376 over B' 128 and comm T 32 over B' 1504 (D 128, H 256): the f32
    forward and backward gates take both, so no FMA kernel runs."""
    from wesep_tpu_torch.ops import cuda_lstm_f32

    for t_len, batch in ((376, 32 * 4), (32, 376 * 4)):
        rows = t_len * batch
        assert cuda_lstm_f32.f32_forward_fits(torch.float32, 128, 256, rows)
        assert cuda_lstm_f32.f32_backward_fits(torch.float32, 128, 256,
                                               rows)
