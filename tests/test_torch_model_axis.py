"""The port's `model_axis` on the CPU: TF-GridNet over a (data x model)
grid of gloo ranks.

A narrow TF-GridNet (one block, hidden 16, the v1 recipe's emb_ks 4 /
emb_hs 1) with `shard_model_axis`: two ranks at `model_axis: 2` (1 x 2, 3
rows) and four at 2 x 2 (6 rows, 3 a data rank), each against the port in
one process on all the rows and against the JAX package's step
(`make_data_parallel` over a (data, model) mesh of host devices,
`shard_model_axis=True`, run inside the mesh as its bin/train runs it),
from the same weights: two steps' losses, the gradients handed to the
optimizer and the parameters after each. 3 rows a data rank make the inter
branch's folded batch 3 x 23 = 69 rows, an uneven share: each rank's
BiLSTM sees 35 of them (and 123 of the intra branch's 246). The two-rank
spawn also runs bin/train under WESEP_DIST with `model_axis: 2` against
the one-process bin/train on the same shard. And the JAX package's checks
of wesep_tpu/bin/train.py: a model axis that does not divide the device
count, a model without model-axis support, `shard_model_axis: false`.
"""

import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from test_torch_gan import _nested
from test_torch_train import _config, _write_set
from torch_mesh_steps import (
    GRID_ARGS,
    GRID_SCHED,
    grid_batch,
    grid_steps,
    rank_grid,
    run_ranks,
    seeded_grid,
)
from wesep_tpu.models.tfgridnet import TFGridNet as JaxTFGridNet
from wesep_tpu.train import trainer as jax_trainer
from wesep_tpu.train.losses import parse_loss as jax_parse_loss
from wesep_tpu.train.schedulers import exponential_decrease as jax_exp
from wesep_tpu_torch.bin.train import (
    build_model,
    check_model_axis,
    check_model_axis_device,
    train,
)
from wesep_tpu_torch.models.tfgridnet import TFGridNet
from wesep_tpu_torch.utils.jax_params import tfgridnet_state_dict_from_jax

torch.set_num_threads(1)  # one intra-op thread per test worker

pytestmark = pytest.mark.xdist_group("ddp")

LR = GRID_SCHED["initial_lr"]
# leaves whose true gradient is zero (test_torch_tfgridnet_train): their
# gradient is rounding noise, held to the 2 lr bound alone
NOISE_ONLY = ("attn_norm_K_bias", "deconv.bias")
# (loss rtol, gradient rel. L2, parameters where the gradient is firm) of
# the first step and the second, against the one process and against JAX.
# The first step starts from equal weights; its Adam update turns elements
# whose gradient is within rounding of zero into +-lr, so the second starts
# from weights that differ there (by up to 2 lr) on both sides of the JAX
# comparison: the one-process port is as far from JAX (test_torch_ddp's
# limits for the same reason)
ONE_LIMITS = ((1e-6, 1e-5, 1e-6), (1e-6, 1e-5, 1e-6))
JAX_LIMITS = ((1e-5, 2e-5, 1e-6), (1e-4, 2e-3, 0.05 * LR))
# the first gradient of the per-share reference (grid_steps' `shares`)
# against the whole batch's and against every rank of the 2 x 2 grid
SHARE_LIMIT = 1e-6


def _jax_steps(rows, data, model, steps=2):
    """`steps` JAX train steps of TF-GridNet with shard_model_axis=True on
    a (data, model) mesh of host devices, the batch sharded on 'data',
    from seeded_grid()'s weights -> [(loss, the gradient handed to the
    optimizer, parameters)] by the port's names."""
    jmodel = JaxTFGridNet(**GRID_ARGS, shard_model_axis=True)
    params = _nested({k: v for k, v in seeded_grid().state_dict().items()})
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda updates, state, p=None: (updates, updates))
    tx = optax.chain(keep, jax_trainer.make_optimizer(
        jax_exp(**GRID_SCHED), weight_decay=1e-4, clip_grad=5.0))
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
        opt_state=tx.init(params))
    mesh = Mesh(np.asarray(jax.devices()[:data * model]).reshape(data, model),
                ("data", "model"))
    step = jax_trainer.make_data_parallel(
        jax_trainer.make_train_step(jmodel, tx, jax_parse_loss("SISDR")),
        mesh, donate_state=False)
    out = []
    with mesh:
        for _ in range(steps):
            state, metrics = step(
                jax.device_put(state, NamedSharding(mesh, PartitionSpec())),
                jax_trainer.shard_batch(grid_batch(rows), mesh))
            out.append((float(metrics["loss"]), _by_name(state.opt_state[0]),
                        _by_name(state.params)))
    return out


def _by_name(tree):
    return {k: v.numpy() for k, v in
            tfgridnet_state_dict_from_jax(jax.device_get(tree)).items()}


def _rel_l2(got, want):
    num = sum(float(np.square(got[k] - w).sum()) for k, w in want.items())
    return np.sqrt(num / sum(float(np.square(w).sum())
                             for w in want.values()))


def _assert_steps(got, want, limits):
    """Each step's loss, the gradient handed to the optimizer (rel. L2) and
    the parameters wherever the step's gradient is above 1e-3 of its
    tensor's largest within the step's `limits`; every parameter within 2
    lr a step taken (Adam's first steps are about lr * sign(g), so a
    gradient at rounding level may take either sign), NOISE_ONLY leaves
    on that bound alone."""
    for i, ((loss, grads, params), (w_loss, w_grads, w_params)) in enumerate(
            zip(got, want)):
        loss_rtol, grad_l2, firm_limit = limits[i]
        np.testing.assert_allclose(loss, w_loss, rtol=loss_rtol)
        assert set(grads) == set(w_grads)
        assert _rel_l2(grads, w_grads) <= grad_l2, (i, _rel_l2(grads,
                                                              w_grads))
        for k, w in w_params.items():
            g = np.abs(w_grads[k])
            firm = g > 1e-3 * g.max()
            diff = np.abs(params[k] - w)
            if not k.endswith(NOISE_ONLY):
                assert diff[firm].max(initial=0.0) <= firm_limit, (i, k)
            assert diff.max() <= 2 * LR * (i + 1), (i, k)


def _bin_config(root):
    """bin/train on a tiny shard: the narrow TF-GridNet, 3 steps of 2
    rows, one validation step, no prefetch thread (the chain's draws from
    Python's global random then come in one order)."""
    rng = np.random.default_rng(0)
    tr = _write_set(root, "train", n_mix=3, n_samples=4000, rng=rng)
    va = _write_set(root, "dev", n_mix=2, n_samples=4000, rng=rng)
    args = dict(GRID_ARGS)
    return _config(root, tr, va, num_epochs=1, num_avg=1,
                   model={"tse_model": "TFGridNet"},
                   model_args={"tse_model": args},
                   dataloader_args={"batch_size": 1, "prefetch_factor": 0},
                   dataset_args={"resample_rate": 16000,
                                 "sample_num_per_epoch": 3, "shuffle": True,
                                 "shuffle_args": {"shuffle_size": 4},
                                 "chunk_len": 1200})


def test_two_ranks_at_model_axis_2(tmp_path):
    """1 x 2 (3 rows, both ranks on all of them): every rank against the
    one process and the JAX (1, 2) mesh.

    ONE_LIMITS against the one process (measured: losses 0 and 0,
    gradient rel. L2 6.8e-7 and 3.9e-7: the shares' sums and the
    gradient's all-reduce run in another order; firm parameters 7.5e-9 and
    6e-8). JAX_LIMITS against JAX (measured: losses 2.1e-7 and 1.4e-6,
    gradient 2.6e-6 and 1.27e-3, the one-process port 2.6e-6 and 1.27e-3
    likewise; firm parameters 1.5e-8 and 4e-6). The ranks equal each other
    bit for bit; each rank's BiLSTMs see 123 intra and 35 inter folded
    rows, the one process 246 and 69.

    bin/train at model_axis 2 on both ranks equals the one-process
    bin/train: 3 steps, parameters within 2 lr a step and 1e-5 in mean."""
    root = str(tmp_path)
    config = _bin_config(root)
    one = dict(config, exp_dir=os.path.join(root, "exp_one"))
    grid = dict(config, exp_dir=os.path.join(root, "exp_grid"),
                model_axis=2)

    def here():
        state = train(one)
        return (grid_steps(3), _jax_steps(3, 1, 2),
                {k: v.detach().numpy() for k, v in
                 state.model.named_parameters()})

    ranks, (want, jax_want, bin_want) = run_ranks(
        rank_grid, 2, tmp_path, 2, 3, grid, meanwhile=here)
    assert [r["mesh"] for r in ranks] == [(0, 1, 0), (0, 1, 1)]
    assert want[1] == {"intra": 246, "inter": 69}
    for r in ranks:
        assert r["seen"] == {"intra": 123, "inter": 35}
        _assert_steps(r["steps"], want[0], ONE_LIMITS)
        _assert_steps(r["steps"], jax_want, JAX_LIMITS)
    for k, v in ranks[0]["steps"][-1][2].items():
        np.testing.assert_array_equal(v, ranks[1]["steps"][-1][2][k])
    for steps, params in (r["bin"] for r in ranks):
        assert steps == 3
        diff = np.concatenate([np.abs(params[k] - w).ravel()
                               for k, w in bin_want.items()])
        assert diff.max() <= 2 * LR * 3 and diff.mean() <= 1e-5
    exp = grid["exp_dir"]
    assert [n for n in os.listdir(exp) if n.startswith("train.log")] == [
        "train.log"]
    text = open(os.path.join(exp, "train.log")).read()
    assert "mesh: 1 data x 2 model devices" in text
    assert "epoch iteration number: 3" in text


def test_four_ranks_at_2_by_2(tmp_path):
    """2 x 2 (6 rows, 3 a data rank): ranks d * 2 + m, every rank against
    the one process on the 6 rows and the JAX (2, 2) mesh, at the two-rank
    test's limits (measured against the one process: losses 0 and 7e-8,
    gradient 7.3e-7 and 9.6e-7, firm parameters 1.5e-8 and 6e-8; against
    JAX: losses 0 and 9.8e-7, gradient 1.0e-6 and 3.0e-5, firm parameters
    1.5e-8 and 1.2e-7). The ranks equal each other bit for bit.

    bin/train at 2 x 2 (each model group's first rank reads its data
    rank's rows and sends them to the other; 2 steps and a validation
    step): every rank takes its 2 steps, the four end bit for bit equal,
    and only rank 0 writes the log. Every rank's first gradient is within
    SHARE_LIMIT of the per-share reference in one process (measured
    4.2e-7)."""
    root = str(tmp_path)
    config = _bin_config(root)
    grid = dict(config, exp_dir=os.path.join(root, "exp_grid"),
                model_axis=2,
                dataset_args=dict(config["dataset_args"],
                                  sample_num_per_epoch=4))
    ranks, (want, jax_want, shares) = run_ranks(
        rank_grid, 4, tmp_path, 2, 6, grid,
        meanwhile=lambda: (grid_steps(6), _jax_steps(6, 2, 2),
                           grid_steps(6, steps=1, shares=(2, 2))[0]))
    assert [r["mesh"] for r in ranks] == [(0, 2, 0), (0, 2, 1), (1, 2, 0),
                                          (1, 2, 1)]
    assert want[1] == {"intra": 492, "inter": 138}
    for r in ranks:
        assert r["seen"] == {"intra": 123, "inter": 35}
        _assert_steps(r["steps"], want[0], ONE_LIMITS)
        _assert_steps(r["steps"], jax_want, JAX_LIMITS)
        # the per-share reference of chip_smoke.py's phase 18 (d)
        assert _rel_l2(r["steps"][0][1], shares[0][1]) <= SHARE_LIMIT
    for r in ranks[1:]:
        for k, v in ranks[0]["steps"][-1][2].items():
            np.testing.assert_array_equal(v, r["steps"][-1][2][k])
    assert [r["bin"][0] for r in ranks] == [2] * 4
    for r in ranks[1:]:
        for k, v in ranks[0]["bin"][1].items():
            np.testing.assert_array_equal(v, r["bin"][1][k])
    exp = grid["exp_dir"]
    assert [n for n in os.listdir(exp) if n.startswith("train.log")] == [
        "train.log"]
    text = open(os.path.join(exp, "train.log")).read()
    assert "mesh: 2 data x 2 model devices" in text
    assert "epoch iteration number: 2" in text


def test_per_share_reference_is_the_full_batch_step():
    """The grid's reference in one process (chip_smoke.py phase 18 (d)):
    each data rank's 3 rows in turn as make_train_step's microbatches, each
    block's sharded branches on each model rank's share in turn
    (mesh.run_sharded with an int). Its BiLSTMs see a rank's folded rows
    (123 intra, 35 inter). The loss is SI-SDR's mean over rows and each
    data share holds 3 of the 6, so the shares' mean is the whole batch's
    mean (the count agrees): the loss at rtol 1e-6 and the combined
    gradient within SHARE_LIMIT rel. L2 of the whole batch's step
    (measured: loss 0, gradient 6.6e-7). The four ranks at 2 x 2 are held
    to it in test_four_ranks_at_2_by_2 (measured 4.2e-7; 7.3e-7 from the
    whole batch's)."""
    (got,), seen = grid_steps(6, steps=1, shares=(2, 2))
    (want,), whole = grid_steps(6, steps=1)
    assert seen == {"intra": 123, "inter": 35}
    assert whole == {"intra": 492, "inter": 138}
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert set(got[1]) == set(want[1])
    assert _rel_l2(got[1], want[1]) <= SHARE_LIMIT, _rel_l2(got[1], want[1])


def test_model_axis_checks_as_the_jax_package(tmp_path, caplog):
    """One process at model_axis 2 raises the JAX package's ValueError
    (2 does not divide the device count 1); a model without model-axis
    support raises; `shard_model_axis: false` warns of redundant compute;
    build_model turns the sharding on by default under model_axis > 1, and
    TF-GridNet takes the argument. Across several cards the model axis is
    refused for now (it runs on CPU processes)."""
    cuda = torch.device("cuda", 0)
    with pytest.raises(NotImplementedError, match="model_axis=2 across 4 "
                       "cards is not ported yet"):
        check_model_axis_device(2, 4, cuda)
    check_model_axis_device(2, 4, torch.device("cpu"))
    check_model_axis_device(1, 4, cuda)
    root = str(tmp_path)
    rng = np.random.default_rng(0)
    tr = _write_set(root, "train", n_mix=2, n_samples=4000, rng=rng)
    with pytest.raises(ValueError, match="model_axis=2 must divide device "
                       "count 1"):
        train(_config(root, tr, tr, model_axis=2))
    logger = logging.getLogger("test_model_axis")
    bsrnn = build_model(_config(root, tr, tr, model_axis=2))[0]
    with pytest.raises(ValueError, match="no model-axis sharding support"):
        check_model_axis(bsrnn, "BSRNN", 2, logger, 0)
    check_model_axis(bsrnn, "BSRNN", 1, logger, 0)
    grid_conf = _config(root, tr, tr, model_axis=2,
                        model={"tse_model": "TFGridNet"},
                        model_args={"tse_model": dict(GRID_ARGS)})
    model, args = build_model(grid_conf)
    assert args["shard_model_axis"] is True and model.shard_model_axis
    check_model_axis(model, "TFGridNet", 2, logger, 0)
    off = dict(grid_conf, model_args={"tse_model": dict(
        GRID_ARGS, shard_model_axis=False)})
    model, args = build_model(off)
    assert args["shard_model_axis"] is False
    with caplog.at_level(logging.WARNING, logger="test_model_axis"):
        check_model_axis(model, "TFGridNet", 2, logger, 0)
    assert "redundant replicated compute" in caplog.text
    assert not build_model(dict(grid_conf, model_axis=1))[0].shard_model_axis
    # without a model group the flag changes nothing
    batch = {k: torch.from_numpy(v) for k, v in grid_batch(2).items()}
    with torch.no_grad():
        plain = TFGridNet(**GRID_ARGS)
        sharded = TFGridNet(**GRID_ARGS, shard_model_axis=True)
        sharded.load_state_dict(plain.state_dict())
        sharded.set_model_group(None)
        torch.testing.assert_close(
            sharded(batch["wav_mix"], batch["spk_embeds"])[0],
            plain(batch["wav_mix"], batch["spk_embeds"])[0], rtol=0, atol=0)
