"""Port parity: the train step with the simulation on the device, and
bin/train on an online-mixing conf, on the CPU in f32.

The step with `device_augment` against wesep_tpu.train.trainer's, from the
same weights and batch of dry sources: the port's draw function is
replaced by one that returns the draws the JAX step takes from its key
(fold_in(PRNGKey(seed), step) [, microbatch], then 1), replicated with
`jax.random` (tests/test_torch_augment.py). Two steps at accum_steps 1
(reverb, SNR, noise) and 2 (SNR, noise; reverb is held at accum 1, and
its compile would cost 4 s more). Limits: losses rtol 1e-4; the gradient
handed to the optimizer rel. L2 1e-4 in the first step (measured 1.2e-5
and 5.4e-6) and 1e-3 in the second (measured 3.9e-5 and 2.7e-6; it starts
from parameters whose eps-divided elements differ by up to 2 lr, which
moved it to 1.1e-4 in another run with reverb at accum 2); the parameters
after each step as in tests/test_torch_trainer.py (elements whose
gradient was above 1e-3 of their tensor's largest in every step so far
within 5 % of lr, all within 2 lr a step: Adam's first steps move by about
lr * sign(g)). Then bin/train end to end with `device_augment` on and off
(reverb, noise from a synthetic pack), and two gloo ranks under
WESEP_DIST against one process on the same rows.
"""

import functools
import io
import multiprocessing
import os
import re
import tarfile
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_augment import jax_augment_draws
from test_torch_train import SPEAKERS, _config, _voice, _write_set
from wesep_tpu.data import augment as jax_augment
from wesep_tpu.models.bsrnn import BSRNN as JaxBSRNN
from wesep_tpu.train import trainer as jax_trainer
from wesep_tpu.train.losses import parse_loss as jax_parse_loss
from wesep_tpu.train.schedulers import exponential_decrease as jax_exp
from wesep_tpu_torch.data import augment
from wesep_tpu_torch.data.noise_store import build_pack
from wesep_tpu_torch.data.wav_io import wav_bytes, write_wav
from wesep_tpu_torch.train import trainer
from wesep_tpu_torch.train.losses import parse_loss
from wesep_tpu_torch.train.schedulers import exponential_decrease
from torch_online_steps import (
    ARGS,
    AUG,
    MIXTURES,
    SAMPLES,
    SCHED,
    SEED,
    dry_batch,
    free_port,
    port_steps,
    rank_steps,
    seeded_model,
)

torch.set_num_threads(1)  # one intra-op thread per test worker

pytestmark = pytest.mark.xdist_group("online_train")


def jax_step_draws(accum):
    """A stand-in for augment.draw_augment returning, for its k-th call,
    the draws of the JAX step's (step, microbatch) = divmod(k, accum)."""
    calls = []

    def draw(gen, batch, num_src, cfg, reverb_prob, use_random_snr,
             noise_prob, noise_snr):
        step, micro = divmod(len(calls), accum)
        calls.append(batch)
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
        if accum > 1:
            key = jax.random.fold_in(key, micro)
        return jax_augment_draws(
            jax.random.fold_in(key, 1), batch, num_src,
            jax_augment.RirConfig(**cfg._asdict()), reverb_prob,
            use_random_snr, noise_prob, noise_snr)

    draw.calls = calls
    return draw


def _jax_steps(accum, aug, steps=2):
    """`steps` JAX train steps with device_augment from seeded_model()'s
    weights
    -> [(loss, the gradient handed to the optimizer, parameters)]."""
    batch = {k: jnp.asarray(v) for k, v in dry_batch().items()}
    jmodel = JaxBSRNN(**ARGS)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), batch["wav_srcs"].sum(1).repeat(2, 0),
        batch["spk_embeds"], train=False))
    weights = seeded_model().state_dict()

    def tree(node, prefix=""):
        return {k: tree(v, f"{prefix}{k}.") if hasattr(v, "items")
                else jnp.asarray(weights[prefix + k].numpy().reshape(v.shape))
                for k, v in node.items()}

    params = tree(shapes["params"])
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda updates, state, p=None: (updates, updates))
    tx = optax.chain(keep, jax_trainer.make_optimizer(
        jax_exp(**SCHED), weight_decay=1e-4, clip_grad=5.0))
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
        opt_state=tx.init(params))
    step = jax.jit(jax_trainer.make_train_step(
        jmodel, tx, jax_parse_loss("SISDR"), seed=SEED, device_augment=aug,
        accum_steps=accum))
    out = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        out.append((float(metrics["loss"]), _flat(state.opt_state[0]),
                    _flat(state.params)))
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _rel_l2(got, want):
    num = sum(float(np.square(got[k] - w).sum()) for k, w in want.items())
    return np.sqrt(num / sum(float(np.square(w).sum())
                             for w in want.values()))


@pytest.mark.parametrize("accum,aug", [(1, AUG),
                                       (2, dict(AUG, reverb_prob=0.0))],
                         ids=["accum1", "accum2_no_reverb"])
def test_device_augment_step_matches_jax(accum, aug, monkeypatch):
    want = _jax_steps(accum, aug)
    draw = jax_step_draws(accum)
    monkeypatch.setattr(augment, "draw_augment", draw)
    got = port_steps(accum, device_augment=aug)
    # one draw of the (micro)batch's mixtures per microbatch and step
    assert draw.calls == [MIXTURES // accum] * (2 * accum)
    lr = SCHED["initial_lr"]
    firm = {}
    for i, ((loss, grads, params), (w_loss, w_grads, w_params)) in \
            enumerate(zip(got, want)):
        np.testing.assert_allclose(loss, w_loss, rtol=1e-4)
        assert set(grads) == set(w_grads) == set(params)
        # the second step starts from parameters whose eps-divided
        # elements differ by up to 2 lr
        assert _rel_l2(grads, w_grads) <= (1e-4, 1e-3)[i]
        for name, w in w_params.items():
            diff = np.abs(params[name] - w)
            g = np.abs(w_grads[name])
            # firm in this step and every earlier one
            firm[name] = (g > 1e-3 * g.max()) & firm.get(name, True)
            assert diff[firm[name]].max(initial=0.0) <= 0.05 * lr, name
            assert diff.max() <= 2 * (i + 1) * lr, name


def test_device_augment_step_draws_from_its_seed_and_step():
    """The port's own draws: the same seed repeats a step bit for bit, the
    simulation differs between steps on the same batch, a mixture's
    targets are its scaled sources, and the rows must divide by
    accum_steps on wav_srcs' mixtures."""
    a, b = port_steps(steps=2), port_steps(steps=2)
    for (la, ga, _), (lb, gb, _) in zip(a, b):
        assert la == lb
        assert all(np.array_equal(ga[k], gb[k]) for k in ga)
    assert a[0][0] != a[1][0] and np.isfinite(a[0][0])
    step = trainer.make_train_step(parse_loss("SISDR"), device_augment=AUG,
                                   accum_steps=3)
    model = seeded_model()
    state = trainer.TrainState(model=model, optimizer=trainer.make_optimizer(
        model, exponential_decrease(**SCHED)))
    with pytest.raises(ValueError, match="batch rows 4 of wav_srcs"):
        step(state, trainer.batch_to_device(dry_batch(), "cpu"))


def test_two_gloo_ranks_equal_one_process(tmp_path):
    """Two ranks under WESEP_DIST, 2 mixtures each, against one process on
    the 4: every rank draws the global batch's simulation and takes its
    own mixtures'. Losses rtol 1e-6, the gradient rel. L2 1e-5 (the
    all-reduce sums the ranks' gradients in another order), parameters
    within 1e-6 wherever the gradient is above 1e-4 of its tensor's
    largest; the ranks equal each other bit for bit."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=rank_steps,
                         args=(rank, 2, port, str(tmp_path)))
             for rank in range(2)]
    deadline = time.monotonic() + 120
    for p in procs:
        p.start()
    try:
        want = port_steps()
    finally:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    for got in ranks:
        for (loss, grads, params), (w_loss, w_grads, w_params) in zip(
                got, want):
            np.testing.assert_allclose(loss, w_loss, rtol=1e-6)
            assert _rel_l2(grads, w_grads) <= 1e-5
            for name, w in w_params.items():
                g = np.abs(w_grads[name])
                firm = g > 1e-4 * g.max()
                diff = np.abs(params[name] - w)
                assert diff[firm].max(initial=0.0) <= 1e-6, name
    for k in ranks[0][1][2]:
        np.testing.assert_array_equal(ranks[0][1][2][k], ranks[1][1][2][k])
    # per-rank seeding alone would give both ranks' first mixture the same
    # simulation: the draws of mixtures 0 and 2 differ
    draws = augment.draw_augment(augment.step_generator(SEED, 0, 0, "cpu"),
                                 MIXTURES, 2, augment.RirConfig(), 0.5, True,
                                 0.5)
    assert not torch.equal(draws["snr"][0], draws["snr"][2])


@pytest.fixture(scope="module")
def online_data(tmp_path_factory):
    """A single-speaker shard of the three speakers of test_torch_train's
    sets (4 utterances each, 0.6-0.9 s), their embedding scp and utt2spk,
    a premixed validation set, and a noise pack."""
    root = str(tmp_path_factory.mktemp("online_train"))
    rng = np.random.default_rng(3)
    tr = _write_set(root, "train", n_mix=3, n_samples=4000, rng=rng)
    va = _write_set(root, "dev", n_mix=4, n_samples=4000, rng=rng)
    tar_path = os.path.join(root, "single.tar")
    with tarfile.open(tar_path, "w") as tar:
        for i in range(12):
            spk = sorted(SPEAKERS)[i % 3]
            blob = wav_bytes(_voice(rng, SPEAKERS[spk], 9600 + 400 * i),
                             16000)
            for name, data in ((f"utt{i:02d}.spk", spk.encode()),
                               (f"utt{i:02d}.wav", blob)):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
    tr["data"] = os.path.join(root, "single.list")
    with open(tr["data"], "w") as f:
        f.write(tar_path + "\n")
    noise = []
    for i, kind in enumerate(("noise", "music", "speech")):
        path = os.path.join(root, f"{kind}_{i}.wav")
        write_wav(path, (rng.standard_normal(6000 + 3000 * i) * 0.05)
                  .astype(np.float32), 16000)
        noise.append(path)
    return root, tr, va, build_pack(noise, os.path.join(root, "noise.pack"))


@pytest.mark.parametrize("device_augment", [True, False],
                         ids=["device", "host"])
def test_bin_train_on_an_online_conf(online_data, device_augment):
    """bin/train with online mixing, reverb 0.5, noise 0.5 and random SNRs,
    on the device path and on the host path: 3 steps an epoch, finite
    losses, checkpoints, and the epoch's throughput counted."""
    from wesep_tpu_torch.bin.train import train

    root, tr, va, pack = online_data
    config = _config(root, tr, va, num_epochs=1, num_avg=1,
                     log_batch_interval=1,
                     exp_dir=os.path.join(root, f"exp_{device_augment}"))
    config["model_args"]["tse_model"] = dict(ARGS)
    config["dataset_args"] = {
        "resample_rate": 16000, "sample_num_per_epoch": 6, "shuffle": True,
        "shuffle_args": {"shuffle_size": 4}, "chunk_len": SAMPLES,
        "online_mix": True, "device_augment": device_augment,
        "num_speakers": 2, "online_buffer_size": 6, "use_random_snr": True,
        "filter_len": True,
        "filter_args": {"min_num_seconds": 0.5, "max_num_seconds": 15},
        "reverb_prob": 0.5, "noise_prob": 0.5, "noise_lmdb_file": pack}
    state = train(config)
    assert state.step == 3
    log = open(os.path.join(config["exp_dir"], "train.log")).read()
    losses = [float(x) for x in re.findall(
        r"Epoch 1 train_loss (\S+) val_loss (\S+)", log)[0]]
    assert all(np.isfinite(losses))
    rate = float(re.findall(r"-> (\S+) audio-s/s", log)[0])
    assert rate > 0  # 2 mixtures x 2 speakers x 0.25 s a step
    assert re.search(r"3 steps, 3 audio-s", log)
    assert os.path.exists(os.path.join(config["exp_dir"], "models",
                                       "checkpoint_1.ckpt"))


def test_bin_train_builds_the_jax_augmentation_dict(monkeypatch):
    """bin/train hands the step the JAX bin/train's dict: use_random_snr
    false unless the conf says otherwise, resample_rate as sample_rate."""
    from wesep_tpu_torch.bin.train import augment_config

    assert augment_config({"reverb_prob": 0.5}) == {
        "reverb_prob": 0.5, "use_random_snr": False, "noise_prob": 0,
        "noise_snr": (-5.0, 25.0), "sample_rate": 16000}
    assert augment_config({"use_random_snr": True, "resample_rate": 8000,
                           "noise_prob": 0.5, "noise_snr": [0, 10]}) == {
        "reverb_prob": 0, "use_random_snr": True, "noise_prob": 0.5,
        "noise_snr": [0, 10], "sample_rate": 8000}
    got = functools.partial(trainer.make_train_step, parse_loss("SISDR"))
    assert callable(got(device_augment=augment_config({})))
