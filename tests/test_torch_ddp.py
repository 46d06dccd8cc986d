"""Data parallelism of the port on the CPU: two gloo processes.

A data-parallel train step (DistributedDataParallel, BatchNorm statistics
over every rank's rows, the loss averaged over ranks) on 2 x 2 rows,
held against the JAX package's data-parallel step (`make_data_parallel`
on a mesh of two host devices, the batch sharded on its data axis) and
against the port's one-process step on the same 4 rows, from the same
weights: two steps of a small joint BSRNN whose ResNet18 encoder trains
with BatchNorm; losses, gradients, statistics and parameters. And the stop
vote: one rank's stop request ends the epoch on both ranks at the same
vote index. And bin/train under WESEP_DIST=1 with two ranks.

Each spawned process has a 120 s limit; the file takes ~45 s.
"""

import multiprocessing
import os
import socket
import time

import numpy as np
import pytest
import torch

from wesep_tpu_torch.models import get_model
from wesep_tpu_torch.train import trainer
from wesep_tpu_torch.train.executor import STOP_VOTE_INTERVAL, Executor
from wesep_tpu_torch.train.losses import parse_loss
from wesep_tpu_torch.train.schedulers import exponential_decrease
from wesep_tpu_torch.utils.jax_params import convtasnet_state_dict_from_jax

torch.set_num_threads(1)  # one intra-op thread per test worker

pytestmark = pytest.mark.xdist_group("ddp")

ARGS = dict(sr=16000, win=512, stride=128, feature_dim=16, num_repeat=1,
            remat=False,
            use_spk_transform=False, spk_fuse_type="multiply",
            multi_fuse=False, joint_training=True, spk_feat=True,
            spk_model="ResNet18", spk_emb_dim=16,
            spk_args=dict(feat_dim=40, m_channels=4, embed_dim=16,
                          pooling_func="TSTP", two_emb_layer=False))
SCHED = dict(num_epochs=2, epoch_iter=4, initial_lr=1e-3, final_lr=2.5e-5,
             warm_up_epoch=0)
ROWS, SAMPLES, FRAMES = 4, 4000, 30
STOP_AFTER = 5


def _batch():
    """Each mixture of two sources twice, with each source as the target."""
    rng = np.random.default_rng(0)
    src = (rng.standard_normal((ROWS // 2, 2, SAMPLES)) * 0.1).astype(
        np.float32)
    return {"wav_mix": np.repeat(src.sum(axis=1), 2, axis=0),
            "wav_targets": src.reshape(ROWS, SAMPLES),
            "spk_embeds": rng.standard_normal((ROWS, FRAMES, 40))
            .astype(np.float32)}


def _model():
    """The seeded port model, its statistics moved away from 0 and 1."""
    torch.manual_seed(0)
    model = get_model("BSRNN")(**ARGS)
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for name, buf in model.named_buffers():
            if name.endswith((".mean", ".var")):
                buf.add_(torch.rand(buf.shape, generator=g))
    return model


def _jax_reference(steps=2):
    """`steps` steps of the JAX package's data-parallel step
    (`make_data_parallel` on a mesh of two host devices, the batch sharded
    on its data axis) from `_model()`'s weights -> for each step (loss,
    the gradient handed to the optimizer, parameters and statistics after
    it) by the port's names, as numpy."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec

    from wesep_tpu.models import get_model as jax_get_model
    from wesep_tpu.train import trainer as jax_trainer
    from wesep_tpu.train.losses import parse_loss as jax_parse_loss
    from wesep_tpu.train.schedulers import exponential_decrease as jax_exp

    batch = _batch()
    jmodel = jax_get_model("BSRNN")(**ARGS)
    shapes = jax.eval_shape(
        lambda mix, cue: jmodel.init(jax.random.PRNGKey(0), mix, cue,
                                     train=False),
        jnp.asarray(batch["wav_mix"]), jnp.asarray(batch["spk_embeds"]))
    weights = _model().state_dict()

    def tree(node, prefix=""):  # the JAX tree of the port's tensors
        return {k: tree(v, f"{prefix}{k}.") if hasattr(v, "items")
                else weights[prefix + k].numpy().reshape(v.shape)
                for k, v in node.items()}

    params, stats = tree(shapes["params"]), tree(shapes["batch_stats"])
    assert set(convtasnet_state_dict_from_jax(params, stats)) == set(weights)
    # the first link of the chain keeps the gradient it is handed
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda updates, state, p=None: (updates, updates))
    tx = optax.chain(keep, jax_trainer.make_optimizer(
        jax_exp(**SCHED), weight_decay=1e-4, clip_grad=5.0))
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=tx.init(params))
    mesh = jax_trainer.fit_data_mesh(ROWS, jax.devices()[:2])
    assert mesh.devices.size == 2
    step = jax_trainer.make_data_parallel(
        jax_trainer.make_train_step(jmodel, tx, jax_parse_loss("SISDR")),
        mesh, donate_state=False)
    replicated = NamedSharding(mesh, PartitionSpec())
    out = []
    for _ in range(steps):  # a replicated state: one compile for both
        state, metrics = step(jax.device_put(state, replicated),
                              jax_trainer.shard_batch(batch, mesh))
        out.append((float(metrics["loss"]), _flat(state.opt_state[0]),
                    _flat(state.params), _flat(state.batch_stats)))
    return out


def _flat(tree):
    return {k: v.numpy() for k, v in
            convtasnet_state_dict_from_jax(tree).items()}


def _train_steps(rank=0, world=1, steps=2):
    """`steps` train steps of the port from `_model()` on this rank's share
    of the batch's rows -> for each step (loss, the gradient handed to the
    optimizer, parameters and statistics after it), as numpy."""
    model = _model()
    opt = trainer.make_optimizer(model, exponential_decrease(**SCHED),
                                 weight_decay=1e-4, clip_grad=5.0)
    grads = []
    update = opt.update
    opt.update = lambda g: grads.append(
        {k: v.detach().numpy().copy() for k, v in g.items()}) or update(g)
    state = trainer.TrainState(model=model, optimizer=opt)
    step = trainer.make_train_step(parse_loss("SISDR"))
    share = ROWS // world
    batch = {k: v[rank * share:(rank + 1) * share]
             for k, v in _batch().items()}
    tbatch = trainer.batch_to_device(batch, "cpu")
    out = []
    for _ in range(steps):
        state, metrics = step(state, tbatch)
        out.append((float(metrics["loss"]), grads[-1],
                    {k: v.detach().numpy().copy()
                     for k, v in model.named_parameters()},
                    {k: v.numpy().copy() for k, v in model.named_buffers()
                     if k.endswith((".mean", ".var"))}))
    return out


def _vote(rank):
    """An epoch of 40 batches in which rank 1 asks to stop from its 5th
    batch on -> (batches run, stopped)."""
    ran = [0]

    def step(state, batch):
        ran[0] += 1
        return state, {"loss": torch.zeros(())}

    executor = Executor()
    batches = ({"wav_mix": np.zeros((2, 16), np.float32)}
               for _ in range(40))
    executor.train(batches, step, None, 40, 1,
                   should_stop=lambda: rank == 1 and ran[0] >= STOP_AFTER)
    return ran[0], executor.stopped


def _bin_train(rank, world, port, out_dir):
    """bin/train under WESEP_DIST (it joins the group itself) -> (steps,
    rank's parameters)."""
    from wesep_tpu_torch.bin.train import train

    os.environ.update(WESEP_DIST="1", WESEP_COORDINATOR=f"127.0.0.1:{port}",
                      WESEP_NUM_PROCESSES=str(world),
                      WESEP_PROCESS_ID=str(rank))
    config = torch.load(os.path.join(out_dir, "config.pt"))
    state = train(config)
    return state.step, {k: v.detach().numpy().copy()
                        for k, v in state.model.named_parameters()}


def _worker(rank, world, port, out_dir, task):
    torch.set_num_threads(1)
    import torch.distributed as dist

    if task != "bin_train":
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
    try:
        result = {"steps": lambda: _train_steps(rank, world),
                  "vote": lambda: _vote(rank),
                  "bin_train": lambda: _bin_train(rank, world, port,
                                                  out_dir)}[task]()
        torch.save(result, os.path.join(out_dir, f"{task}{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(task, out_dir, world=2, limit=120, meanwhile=lambda: None):
    """`task` in `world` spawned processes, each within `limit` seconds of
    its start -> (each rank's result, what `meanwhile` returned, called in
    this process while the ranks run)."""
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker,
                         args=(rank, world, port, str(out_dir), task))
             for rank in range(world)]
    deadline = time.monotonic() + limit
    for p in procs:
        p.start()
    try:
        here = meanwhile()
    finally:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0] * world
    return [torch.load(os.path.join(out_dir, f"{task}{rank}.pt"),
                       weights_only=False) for rank in range(world)], here


def _rel_l2(got, want):
    num = sum(float(np.square(got[k] - w).sum()) for k, w in want.items())
    return np.sqrt(num / sum(float(np.square(w).sum())
                             for w in want.values()))


def _assert_first_step(got, want, init, loss_rtol, grad_l2, stats_limit):
    """One data-parallel rank's first step against a reference's: the loss
    (the mean over ranks) within `loss_rtol`; the gradient handed to the
    optimizer (the mean over ranks) within rel. L2 `grad_l2`; every
    BatchNorm statistic within `stats_limit` of its largest; the
    parameters within 1e-6 wherever Adam's input (the clipped gradient +
    1e-4 * p) exceeds 1e-6 in magnitude. Below that, Adam's
    g / (sqrt(v) + 1e-8) divides the rounding of a near-zero input by eps
    (such elements moved by up to 1.8e-3): they are held to 2 * lr and
    must be under 1 % of the elements."""
    loss, grads, params, buffers = got
    np.testing.assert_allclose(loss, want[0], rtol=loss_rtol)
    assert set(grads) == set(want[1])
    assert _rel_l2(grads, want[1]) <= grad_l2
    tiny = total = 0
    for k, w in want[2].items():
        g = want[1][k]
        coef = min(5.0 / (np.sqrt(np.square(g).sum()) + 1e-6), 1.0)
        steady = np.abs(g * coef + 1e-4 * init[k]) > 1e-6
        diff = np.abs(params[k] - w)
        assert diff[steady].max(initial=0.0) <= 1e-6, k
        assert diff.max() <= 2 * SCHED["initial_lr"], k
        tiny += int((~steady).sum())
        total += steady.size
    assert tiny <= 0.01 * total, (tiny, total)
    _assert_stats(buffers, want[3], stats_limit)


def _assert_stats(got, want, limit):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=limit * max(np.abs(w).max(), 1.0),
                                   err_msg=k)


def test_ddp_steps_equal_the_one_process_steps(tmp_path):
    """Two data-parallel steps on 2 x 2 rows, every rank against the JAX
    package's data-parallel step on the 4 rows and against two steps of
    the port in one process on them, from the same weights.

    Against the one process, the first step: loss rtol 1e-6, gradient rel.
    L2 1e-5 (measured 2.7e-6: the statistics' sums are formed in another
    order, and the ResNet's BatchNorm-bias gradients nearly cancel),
    statistics 1e-6; the second: loss rtol 1e-6, statistics 1e-5
    (measured 1.3e-6).

    Against JAX, the first step: loss rtol 1e-5 (measured 2.5e-7),
    gradient rel. L2 2e-5 (measured 3.6e-6), statistics 1e-6 (measured
    7.4e-8). The second step starts from parameters in which the
    eps-divided elements differ by up to 2 lr on both sides of the
    comparison (the one-process port differs from JAX as much): its loss
    rtol 1e-4 (measured 8e-6), gradient rel. L2 2e-3 (measured 3.8e-4),
    statistics 5e-4 (measured 7.2e-5), parameters within 2 lr with a mean
    difference below 1e-6 (measured 5.5e-8).

    The ranks' parameters and statistics equal each other bit for bit."""
    ranks, (want, jax_want) = _run_ranks(
        "steps", tmp_path,
        meanwhile=lambda: (_train_steps(), _jax_reference()))
    init = {k: v.detach().numpy() for k, v in _model().named_parameters()}
    assert any(k.startswith("spk_model_net.") and k.endswith(".var")
               for k in want[0][3])
    lr = SCHED["initial_lr"]
    for got in ranks:
        _assert_first_step(got[0], want[0], init, 1e-6, 1e-5, 1e-6)
        np.testing.assert_allclose(got[1][0], want[1][0], rtol=1e-6)
        _assert_stats(got[1][3], want[1][3], 1e-5)
        _assert_first_step(got[0], jax_want[0], init, 1e-5, 2e-5, 1e-6)
        loss, grads, params, buffers = got[1]
        np.testing.assert_allclose(loss, jax_want[1][0], rtol=1e-4)
        assert _rel_l2(grads, jax_want[1][1]) <= 2e-3
        _assert_stats(buffers, jax_want[1][3], 5e-4)
        assert set(params) == set(jax_want[1][2])
        diff = np.concatenate([np.abs(params[k] - w).ravel()
                               for k, w in jax_want[1][2].items()])
        assert diff.max() <= 2 * lr and diff.mean() <= 1e-6
    for k in want[1][2]:
        np.testing.assert_array_equal(ranks[0][1][2][k], ranks[1][1][2][k])
    for k in want[1][3]:
        np.testing.assert_array_equal(ranks[0][1][3][k], ranks[1][1][3][k])


def test_stop_vote_stops_every_rank_at_the_same_index(tmp_path):
    """Rank 1 asks to stop after 5 batches; the vote runs every 8, so both
    ranks run 8 batches and stop. One process reads its flag every batch
    and stops after 5."""
    assert _run_ranks("vote", tmp_path)[0] == [(STOP_VOTE_INTERVAL, True)] * 2
    ran = [0]

    def step(state, batch):
        ran[0] += 1
        return state, {"loss": torch.zeros(())}

    executor = Executor()
    executor.train(({"wav_mix": np.zeros((2, 16), np.float32)}
                    for _ in range(40)), step, None, 40, 1,
                   should_stop=lambda: ran[0] >= STOP_AFTER)
    assert (ran[0], executor.stopped) == (STOP_AFTER, True)


def test_bin_train_under_wesep_dist(tmp_path):
    """WESEP_DIST=1 with two gloo ranks through bin/train (the JAX
    package's environment contract): each rank trains sample_num_per_epoch
    / world / batch_size = 3 steps an epoch, the ranks end with equal
    parameters, and only rank 0 writes the log and the checkpoints."""
    from test_torch_train import _config, _write_set

    root = str(tmp_path)
    rng = np.random.default_rng(0)
    tr = _write_set(root, "train", n_mix=6, n_samples=8000, rng=rng)
    va = _write_set(root, "dev", n_mix=4, n_samples=6000, rng=rng)
    config = _config(root, tr, va, num_epochs=1, num_avg=1)
    torch.save(config, os.path.join(root, "config.pt"))
    (steps0, params0), (steps1, params1) = _run_ranks("bin_train", root)[0]
    assert steps0 == steps1 == 12 // 2 // 2
    for k, v in params0.items():
        np.testing.assert_array_equal(v, params1[k], err_msg=k)
    exp = config["exp_dir"]
    assert sorted(os.listdir(os.path.join(exp, "models"))) == [
        "checkpoint_1.ckpt", "final_checkpoint.ckpt",
        "latest_checkpoint.ckpt"]
    assert [n for n in os.listdir(exp) if n.startswith("train.log")] == [
        "train.log"]
    assert "epoch iteration number: 3" in open(
        os.path.join(exp, "train.log")).read()


def test_wesep_dist_names_the_missing_environment(monkeypatch):
    from wesep_tpu_torch.bin.train import init_distributed

    monkeypatch.setenv("WESEP_DIST", "1")
    monkeypatch.setenv("WESEP_COORDINATOR", "127.0.0.1:1")
    monkeypatch.delenv("WESEP_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("WESEP_PROCESS_ID", raising=False)
    with pytest.raises(ValueError, match="WESEP_NUM_PROCESSES, "
                       "WESEP_PROCESS_ID"):
        init_distributed(torch.device("cpu"))
