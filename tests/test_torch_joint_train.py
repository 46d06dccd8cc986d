"""Port parity: joint (v2) training with fbank cues, end to end.

The fbank data chain batch for batch against wesep_tpu.data (the same
Python `random` seed draws the same chunks, enrollments and labels; at
dither 0 the features agree, with dither only the keys, order, waveforms
and shapes: the dither noise comes from another generator); two joint
BSRNN train steps against the JAX package's `make_train_step` from the
same parameters, BatchNorm statistics and batch; `spk_model_freeze`,
which keeps the JAX package's prefix `spk_model_net` (BSRNN's scope) and so
freezes nothing in TF-GridNet, whose encoder is `spk_model`, in both
packages; self-estimated speech augmentation (SSA) at probability 0 and
1; and the port's bin/train -> bin/average_model -> bin/infer on a tiny
shard from the v2 recipe conf with `--set` overrides, on the CPU.
"""

import os
import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_spex_train import _write_set
from wesep_tpu.data import BatchLoader as JaxBatchLoader
from wesep_tpu.data import Dataset as JaxDataset
from wesep_tpu.data import tse_collate_fn as jax_collate
from wesep_tpu.models import get_model as jax_get_model
from wesep_tpu.train import trainer as jax_trainer
from wesep_tpu.train.losses import parse_loss as jax_parse_loss
from wesep_tpu.train.schedulers import exponential_decrease as jax_exp
from wesep_tpu_torch.bin import average_model
from wesep_tpu_torch.bin.infer import infer
from wesep_tpu_torch.bin.train import default_enroll_len, load_enroll_maps
from wesep_tpu_torch.bin.train import train
from wesep_tpu_torch.data import BatchLoader, Dataset, tse_collate_fn
from wesep_tpu_torch.models import get_model
from wesep_tpu_torch.ops.fbank import kaldi_fbank
from wesep_tpu_torch.train import trainer
from wesep_tpu_torch.train.checkpoint import find_epoch_checkpoints
from wesep_tpu_torch.train.checkpoint import load_checkpoint
from wesep_tpu_torch.train.losses import parse_loss
from wesep_tpu_torch.train.schedulers import exponential_decrease
from wesep_tpu_torch.utils.jax_params import (
    convtasnet_state_dict_from_jax,
    load_jax_params,
)

torch.set_num_threads(1)  # one intra-op thread per test worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V2_BSRNN = os.path.join(ROOT, "examples/librimix/tse/v2/confs/bsrnn.yaml")
ENROLL_FRAMES = 20  # between the two enrollment lengths: 17 and 29 frames
SPK = dict(spk_model="ResNet18", spk_emb_dim=16,
           spk_args=dict(feat_dim=80, m_channels=4, embed_dim=16,
                         pooling_func="TSTP", two_emb_layer=False))
BSRNN_ARGS = dict(sr=16000, win=512, stride=128, feature_dim=16,
                  num_repeat=1, use_spk_transform=False,
                  spk_fuse_type="multiply", multi_fuse=False,
                  joint_training=True, spk_feat=True, remat=False, **SPK)
GRID_ARGS = dict(n_fft=32, stride=16, n_layers=1, lstm_hidden_units=16,
                 attn_n_head=2, attn_approx_qk_dim=32, emb_dim=8, emb_ks=4,
                 emb_hs=1, spk_fuse_type="multiply", joint_training=True,
                 spk_feat=True, remat=False, **SPK)
SCHED = dict(num_epochs=2, epoch_iter=4, initial_lr=1e-3, final_lr=2.5e-5,
             warm_up_epoch=0)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("joint_data"))
    rng = np.random.default_rng(0)
    tr = _write_set(root, "train", n_mix=6, n_samples=4000, rng=rng)
    va = _write_set(root, "dev", n_mix=4, n_samples=3000, rng=rng)
    return root, tr, va


# --- the fbank data chain -------------------------------------------------


def _chain_batches(dataset_fn, loader_fn, collate, args, state, dict_spk,
                   dataset_args, n=5):
    ds = dataset_fn("shard", args[0], dataset_args, *args[1:], state=state,
                    joint_training=True, dict_spk=dict_spk,
                    repeat_dataset=True, rank=0, world_size=1)
    loader = loader_fn(
        ds, batch_size=2, prefetch=0,
        collate_fn=lambda b: collate(b, fixed_enroll_len=ENROLL_FRAMES))
    loader.set_epoch(3)
    random.seed(11)
    out = []
    for i, b in enumerate(loader):
        out.append(b)
        if i == n - 1:
            break
    return out


@pytest.mark.parametrize("state", ["train", "val"])
@pytest.mark.parametrize("dither", [0.0, 1.0])
def test_fbank_chain_yields_the_jax_batches(sets, state, dither):
    """Same lists, same `random` seed: the chains draw the same chunks,
    enrollments and labels, and `compute_fbank`'s one draw keeps the later
    draws in step. At dither 0 the fbank (after CMVN, wrapped or trimmed to
    ENROLL_FRAMES) within 1e-4 of its largest magnitude (an FFT against the
    JAX package's DFT matmul); with dither (the recipes' 1.0, in the
    validation chain too) the noise differs, so only shapes agree, and
    the features differ from the undithered ones."""
    _, tr, va = sets
    tr_map, dict_spk, _, val_map, val1, val2 = load_enroll_maps(
        {"train_utt2spk": tr["utt2spk"],
         "train_spk2utt": tr["spk2enroll.json"],
         "val_spk2utt": va["enroll_wav.scp"],
         "val_spk1_enroll": va["spk1_enroll"],
         "val_spk2_enroll": va["spk2_enroll"]}, True, True)
    args = (tr["list"], tr_map, None, None) if state == "train" else (
        va["list"], val_map, val1, val2)
    dataset_args = {"resample_rate": 16000, "shuffle": True,
                    "shuffle_args": {"shuffle_size": 4}, "chunk_len": 2000,
                    "speaker_feat": True,
                    "fbank_args": {"num_mel_bins": 80, "frame_shift": 10,
                                   "frame_length": 25, "dither": dither}}
    want = _chain_batches(JaxDataset, JaxBatchLoader, jax_collate, args,
                          state, dict_spk, dataset_args)
    got = _chain_batches(Dataset, BatchLoader, tse_collate_fn, args, state,
                         dict_spk, dataset_args)
    plain = None
    if dither:
        plain = _chain_batches(
            Dataset, BatchLoader, tse_collate_fn, args, state, dict_spk,
            dict(dataset_args, fbank_args={"dither": 0.0}))
    lengths = set()
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["key"] == w["key"] and g["spk"] == w["spk"]
        assert g["length_spk_embeds"] == w["length_spk_embeds"]
        lengths.update(g["length_spk_embeds"])
        for k in ("wav_mix", "wav_targets", "spk_label"):
            np.testing.assert_array_equal(g[k], w[k])
        assert g["spk_embeds"].shape == w["spk_embeds"].shape \
            == (4, ENROLL_FRAMES, 80)
        assert g["spk_embeds"].dtype == np.float32
        if dither:
            assert np.isfinite(g["spk_embeds"]).all()
            assert np.abs(g["spk_embeds"] - plain[i]["spk_embeds"]).max() > 0
        else:
            np.testing.assert_allclose(
                g["spk_embeds"], w["spk_embeds"], rtol=0,
                atol=1e-4 * np.abs(w["spk_embeds"]).max())
    assert lengths == {17, 29}  # both the wrap and the trim were used


def test_default_enroll_len_counts_fbank_frames():
    """The v2 recipes' 6 s enrollment is 598 fbank frames at a 10 ms
    shift; without speaker_feat it is 6 s of samples; embeddings pass."""
    assert default_enroll_len({"speaker_feat": True, "enroll_sec": 6}, True) \
        == 598
    assert default_enroll_len(
        {"speaker_feat": True, "enroll_sec": 3,
         "fbank_args": {"frame_shift": 20}}, True) == 148
    assert default_enroll_len({"enroll_sec": 6}, True) == 96000
    assert default_enroll_len({"speaker_feat": True}, False) is None
    assert default_enroll_len({"enroll_len": 77, "speaker_feat": True},
                              True) == 77


# --- the train step -------------------------------------------------------


def _batch(seed, rows=4, samples=4000, frames=30):
    """Rows as the collator makes them: each mixture of two sources twice,
    with each source as the target. (A target unrelated to its mixture
    puts SI-SDR near -40 dB, where the loss magnifies every rounding.)"""
    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((rows // 2, 2, samples)) * 0.1).astype(
        np.float32)
    return {
        "wav_mix": np.repeat(src.sum(axis=1), 2, axis=0),
        "wav_targets": src.reshape(rows, samples),
        "spk_embeds": rng.standard_normal((rows, frames, 80))
        .astype(np.float32),
    }


def _jax_variables(name, args, batch, seed=0):
    v = jax_get_model(name)(**args).init(
        jax.random.PRNGKey(seed), jnp.asarray(batch["wav_mix"]),
        jnp.asarray(batch["spk_embeds"]), train=False)
    rng = np.random.default_rng(seed + 7)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape)
        .astype(np.float32), v["params"])
    stats = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * np.abs(rng.standard_normal(p.shape))
        .astype(np.float32), v["batch_stats"])
    return params, stats


def _flat(tree):
    return {k: v.numpy() for k, v in convtasnet_state_dict_from_jax(tree)
            .items()}


def _jax_steps(name, args, params, stats, batch, steps=2, freeze=(),
               **step_kw):
    """Losses, BatchNorm statistics and parameters after each step."""
    jmodel = jax_get_model(name)(**args)
    tx = jax_trainer.make_optimizer(jax_exp(**SCHED), weight_decay=1e-4,
                                    clip_grad=5.0, freeze_prefixes=freeze)
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=tx.init(params))
    step_fn = jax.jit(jax_trainer.make_train_step(
        jmodel, tx, jax_parse_loss("SISDR"), **step_kw))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    for _ in range(steps):
        state, metrics = step_fn(state, jbatch)
        out.append((float(metrics["loss"]), _flat(state.batch_stats),
                    _flat(state.params)))
    return out


def _port_steps(name, args, params, stats, batch, steps=2, freeze=(),
                **step_kw):
    model = load_jax_params(get_model(name)(**args), params, stats)
    opt = trainer.make_optimizer(model, exponential_decrease(**SCHED),
                                 weight_decay=1e-4, clip_grad=5.0,
                                 freeze_prefixes=freeze)
    state = trainer.TrainState(model=model, optimizer=opt)
    step = trainer.make_train_step(parse_loss("SISDR"), **step_kw)
    tbatch = trainer.batch_to_device(batch, "cpu")
    out = []
    for _ in range(steps):
        state, metrics = step(state, tbatch)
        out.append((float(metrics["loss"]),
                    {k: v.clone().numpy() for k, v in model.named_buffers()
                     if k.endswith((".mean", ".var"))},
                    {k: v.detach().clone().numpy()
                     for k, v in model.named_parameters()}))
    return out


def _assert_stats(got, want, limit):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=limit * max(np.abs(w).max(), 1.0),
                                   err_msg=k)


def test_two_joint_bsrnn_train_steps_match_jax():
    """Two f32 steps of the joint BSRNN on fbank cues (ResNet18 encoder
    with its BatchNorm in train mode): losses rtol 1e-4; the encoder's
    statistics after each step within 1e-4 of the largest (the second
    step's batch statistics see the first update's parameters, so
    rounding in that update shows there); parameters after two steps
    within 2 * lr (Adam's first steps move an element by about lr *
    sign(g)) and their mean difference below 0.1 * lr."""
    batch = _batch(0)
    params, stats = _jax_variables("BSRNN", BSRNN_ARGS, batch)
    want = _jax_steps("BSRNN", BSRNN_ARGS, params, stats, batch)
    got = _port_steps("BSRNN", BSRNN_ARGS, params, stats, batch)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-4)
    for g, w in zip(got, want):
        _assert_stats(g[1], w[1], 1e-4)
    lr = SCHED["initial_lr"]
    assert set(got[-1][2]) == set(want[-1][2])
    for k, w in want[-1][2].items():
        diff = np.abs(got[-1][2][k] - w)
        assert diff.max() <= 2 * lr and diff.mean() <= 0.1 * lr, k
    # the encoder trained and its statistics moved
    assert any(not np.array_equal(got[-1][2][k], params_k)
               for k, params_k in _flat(params).items()
               if k.startswith("spk_model_net."))


@pytest.mark.parametrize("name", ["BSRNN", "TFGridNet"])
def test_spk_model_freeze_keeps_the_jax_prefix(name):
    """`spk_model_freeze` freezes the top-level scope `spk_model_net`, as
    the JAX package's optimizer mask does: BSRNN's encoder keeps its
    parameters bit for bit in both packages while its statistics move;
    TF-GridNet's encoder, scope `spk_model`, trains in both."""
    args = BSRNN_ARGS if name == "BSRNN" else GRID_ARGS
    batch = _batch(1, samples=1600 if name == "TFGridNet" else 4000)
    params, stats = _jax_variables(name, args, batch)
    freeze = ("spk_model_net",)
    want = _jax_steps(name, args, params, stats, batch, steps=1,
                      freeze=freeze)
    got = _port_steps(name, args, params, stats, batch, steps=1,
                      freeze=freeze)
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=1e-4)
    scope = "spk_model_net." if name == "BSRNN" else "spk_model."
    before = _flat(params)
    encoder = [k for k in before if k.startswith(scope)]
    assert encoder
    for side in (got[0][2], want[0][2]):
        frozen = [np.array_equal(side[k], before[k]) for k in encoder]
        assert all(frozen) if name == "BSRNN" else not any(frozen)
    moved = [k for k in got[0][1] if k.startswith(scope)
             and not np.array_equal(got[0][1][k], _flat(stats)[k])]
    assert moved


@pytest.mark.parametrize("prob", [0.0, 1.0])
def test_ssa_matches_jax(prob):
    """Self-estimated speech augmentation at probability 0 and 1: with 1
    the step's enrollment is the Kaldi fbank (dither 0, int16 scale) after
    CMVN of the model's own estimate from a no-grad forward in train mode.
    Losses of one step rtol 1e-4; the statistics move once a step (the SSA
    pass's are thrown away) and match the JAX package's within 1e-4 of
    their largest."""
    batch = _batch(2)
    params, stats = _jax_variables("BSRNN", BSRNN_ARGS, batch)
    kw = dict(ssa_enroll_prob=prob, ssa_speaker_feat=True,
              fbank_args={"num_mel_bins": 80}, sample_rate=16000, seed=42)
    want = _jax_steps("BSRNN", BSRNN_ARGS, params, stats, batch, steps=1,
                      **kw)
    got = _port_steps("BSRNN", BSRNN_ARGS, params, stats, batch, steps=1,
                      **kw)
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=1e-4)
    _assert_stats(got[0][1], want[0][1], 1e-4)
    # the loss forward of SSA sees another enrollment than the batch's
    plain = _jax_steps("BSRNN", BSRNN_ARGS, params, stats, batch, steps=1)
    assert (got[0][0] == pytest.approx(plain[0][0], rel=1e-4)) == (prob == 0)


def test_ssa_enrollment_is_the_fbank_of_the_estimate():
    """The SSA pass in isolation: the loss forward's enrollment is the
    CMVN'd fbank of the first estimate of a train-mode forward, and the
    model's buffers are as before it."""
    batch = _batch(3, rows=2)
    model = get_model("BSRNN")(**BSRNN_ARGS)
    opt = trainer.make_optimizer(model, exponential_decrease(**SCHED))
    seen = []
    real = model.forward

    def spy(mix, cue):
        seen.append((cue.detach().clone(), model.training))
        return real(mix, cue)

    model.forward = spy
    tbatch = trainer.batch_to_device(batch, "cpu")
    before = {k: v.clone() for k, v in model.named_buffers()}
    step = trainer.make_train_step(parse_loss("SISDR"), ssa_enroll_prob=1.0)
    torch.manual_seed(0)
    with torch.no_grad():
        model.train()
        est = real(tbatch["wav_mix"], tbatch["spk_embeds"])[0]
    for k, v in model.named_buffers():
        v.copy_(before[k])
    step(trainer.TrainState(model=model, optimizer=opt), tbatch)
    assert len(seen) == 2 and all(train for _, train in seen)
    torch.testing.assert_close(seen[0][0], tbatch["spk_embeds"])
    fbank = kaldi_fbank(est, input_scale=32768.0)
    want = fbank - fbank.mean(dim=-2, keepdim=True)
    torch.testing.assert_close(seen[1][0], want, atol=1e-4, rtol=1e-4)


# --- the entry points -----------------------------------------------------


def _overrides(root, tr, va):
    return [
        "device=cpu", f"exp_dir={os.path.join(root, 'exp')}",
        f"train_data={tr['list']}", f"train_utt2spk={tr['utt2spk']}",
        f"train_spk2utt={tr['spk2enroll.json']}",
        f"val_data={va['list']}", f"val_spk2utt={va['enroll_wav.scp']}",
        f"val_spk1_enroll={va['spk1_enroll']}",
        f"val_spk2_enroll={va['spk2_enroll']}",
        "dataloader_args.batch_size=2", "dataloader_args.prefetch_factor=2",
        "dataset_args.sample_num_per_epoch=4", "dataset_args.chunk_len=4000",
        "dataset_args.shuffle_args.shuffle_size=4",
        "dataset_args.enroll_sec=0.3", "num_epochs=2", "num_avg=2",
        "log_batch_interval=1", "model_args.tse_model.feature_dim=16",
        "model_args.tse_model.num_repeat=1",
        "model_args.tse_model.spk_emb_dim=16",
        "model_args.tse_model.spk_args.embed_dim=16",
        "model_args.tse_model.spk_args.m_channels=4",
    ]


def test_v2_conf_train_average_infer(sets, tmp_path):
    """The librimix v2 BSRNN conf (ResNet34, fbank cues with dither,
    compute_dtype bfloat16) through bin/train for two epochs of two steps,
    bin/average_model over both and bin/infer with the v2 dataset args:
    finite losses, checkpoints with the encoder's statistics, the
    statistics of the newest checkpoint in the average, finite scores and
    one wav per target."""
    _, tr, va = sets
    root = str(tmp_path)
    state = train(V2_BSRNN, overrides=_overrides(root, tr, va))
    assert state.step == 4 and state.optimizer.count == 4
    exp = os.path.join(root, "exp")
    log = open(os.path.join(exp, "train.log")).read()
    assert "Epoch 2 train_loss" in log
    models = os.path.join(exp, "models")
    assert [e for e, _ in find_epoch_checkpoints(models)] == [1, 2]
    bundle = load_checkpoint(os.path.join(models, "checkpoint_2.ckpt"))
    stats = bundle["batch_stats"][0]
    assert stats and all(k.startswith("spk_model_net.") for k in stats)
    assert "layer4_2.bn2.mean" in "".join(stats)  # ResNet34's depth
    dst = os.path.join(root, "avg_model.ckpt")
    average_model.main(["--dst_model", dst, "--src_path", models,
                        "--num", "2"])
    for k, v in load_checkpoint(dst)["batch_stats"][0].items():
        assert torch.equal(v, stats[k]), k
    import yaml

    with open(V2_BSRNN) as f:
        conf = yaml.safe_load(f)
    model_args = dict(conf["model_args"]["tse_model"], feature_dim=16,
                      num_repeat=1, spk_emb_dim=16,
                      spk_args=dict(conf["model_args"]["tse_model"]
                                    ["spk_args"], embed_dim=16,
                                    m_channels=4))
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
