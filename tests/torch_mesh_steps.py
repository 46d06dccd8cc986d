"""The port's side of tests/test_torch_gan_ddp.py and
tests/test_torch_model_axis.py: the models, batches and steps that the
spawned gloo ranks and the one-process references run. It imports neither
JAX nor the JAX package, so the ranks start quickly.

`run_ranks(target, world, out_dir, *args)` spawns `world` processes of
`target(rank, world, port, out_dir, *args)`, each of which joins a gloo
group on bin/train's environment contract (WESEP_DIST) and saves its
result to out_dir/rank<r>.pt.
"""

import multiprocessing
import os
import socket
import time

import numpy as np
import torch

from wesep_tpu_torch.models.bsrnn import BSRNN
from wesep_tpu_torch.models.discriminator import CMGANDiscriminator
from wesep_tpu_torch.models.tfgridnet import TFGridNet
from wesep_tpu_torch.train import trainer, trainer_gan
from wesep_tpu_torch.train.losses import parse_loss, si_sdr_loss
from wesep_tpu_torch.train.schedulers import exponential_decrease

# --- the MetricGAN step (test_torch_gan's small BSRNN and discriminator) ---
GAN_ARGS = dict(spk_emb_dim=16, feature_dim=8, num_repeat=1,
                joint_training=False, use_spk_transform=False,
                spk_fuse_type="multiply", multi_fuse=False, remat=False)
GAN_SCHED = dict(num_epochs=1, epoch_iter=10, initial_lr=1e-3,
                 final_lr=1e-4, warm_up_epoch=0)
GAN_WD, GAN_CLIP, GAN_W, HID = 1e-4, 3.0, 0.05, 4
GAN_ROWS, GAN_SAMPLES = 4, 4000
INVALID_ROW = 1  # the metric stub marks this global row invalid: rank 0's


def gan_batch():
    """4 rows: each a source plus half another as the mixture, the source
    as the target; row INVALID_ROW's target starts with an exact 0."""
    rng = np.random.default_rng(3)
    src = (rng.standard_normal((GAN_ROWS, GAN_SAMPLES)) * 0.1).astype(
        np.float32)
    targets = src.copy()
    targets[INVALID_ROW, 0] = 0.0
    return {"wav_mix": (src + 0.5 * np.roll(src, 1, axis=0)).astype(
                np.float32),
            "wav_targets": targets,
            "spk_embeds": rng.standard_normal((GAN_ROWS, 16)).astype(
                np.float32)}


def gan_masks(features):
    """The fixed dropout masks of the global rows, [GAN_ROWS, f] for each
    dropout layer's width f: keep 0.7, kept elements scaled by 1 / 0.7."""
    rng = np.random.default_rng(5)
    return {f: ((rng.random((GAN_ROWS, f)) < 0.7) / 0.7).astype(np.float32)
            for f in features}


def stub_metric(est, ref):
    """metric_sisdr_norm's values; a row whose reference starts with an
    exact 0 is invalid."""
    values, valid = trainer_gan.metric_sisdr_norm(est, ref)
    return values, valid & (ref[:, 0] != 0)


def seeded_gan_models():
    torch.manual_seed(0)
    return BSRNN(**GAN_ARGS), CMGANDiscriminator(hid_chans=HID)


def _fixed_dropout(masks):
    def dropout_mask(self, batch, generator=None, device=None):
        assert batch == GAN_ROWS, batch  # the global rows are drawn
        return [torch.from_numpy(masks[f]) for f in self.dropout_features]
    return dropout_mask


def gan_steps(rows=slice(None), steps=2):
    """`steps` port GAN steps from seeded_gan_models() on the batch's
    `rows`, the metric stub and the fixed global dropout masks -> for each
    step {"metrics", "g_grads", "d_grads" (handed to the optimizers),
    "g", "d" (parameters after it), "d_buffers" (u, sigma)}."""
    gen, disc = seeded_gan_models()
    real = CMGANDiscriminator.dropout_mask
    CMGANDiscriminator.dropout_mask = _fixed_dropout(
        gan_masks(disc.dropout_features))
    try:
        return _gan_steps(gen, disc, rows, steps)
    finally:
        CMGANDiscriminator.dropout_mask = real


def _gan_steps(gen, disc, rows, steps):
    states, grads = [], {"g": [], "d": []}
    for tag, model in (("g", gen), ("d", disc)):
        opt = trainer.make_optimizer(model, exponential_decrease(**GAN_SCHED),
                                     weight_decay=GAN_WD, clip_grad=GAN_CLIP)
        update = opt.update
        opt.update = lambda g, update=update, tag=tag: grads[tag].append(
            {k: v.detach().numpy().copy() for k, v in g.items()}) or update(g)
        states.append(trainer.TrainState(model=model, optimizer=opt))
    step = trainer_gan.make_gan_train_step(
        [si_sdr_loss], gan_loss_weight=GAN_W, metric_fn=stub_metric)
    batch = trainer.batch_to_device(
        {k: v[rows] for k, v in gan_batch().items()}, "cpu")
    out, states = [], tuple(states)
    for _ in range(steps):
        states, metrics = step(states, batch)
        out.append({
            "metrics": {k: float(v) for k, v in metrics.items()},
            "g_grads": grads["g"][-1], "d_grads": grads["d"][-1],
            "g": {k: v.detach().numpy().copy()
                  for k, v in gen.named_parameters()},
            "d": {k: v.detach().numpy().copy()
                  for k, v in disc.named_parameters()},
            "d_buffers": {k: v.numpy().copy()
                          for k, v in disc.named_buffers()
                          if k.endswith((".u", ".sigma"))}})
    return out


def rank_gan(rank, world, port, out_dir, config=None):
    """Two GAN steps on this rank's rows in a group joined as bin/train_gan
    joins it; then, with `config`, bin/train_gan under WESEP_DIST ->
    {"steps", "bin" ((G's step, D's step), both models' state)}."""
    share = GAN_ROWS // world
    result = {"steps": gan_steps(slice(rank * share, (rank + 1) * share))}
    if config is not None:
        from wesep_tpu_torch.bin.train_gan import train_gan

        g_state, d_state = train_gan(config)
        result["bin"] = ((g_state.step, d_state.step), {
            tag: {k: v.detach().numpy().copy()
                  for k, v in st.model.state_dict().items()}
            for tag, st in (("g", g_state), ("d", d_state))})
    return result


# --- TF-GridNet under model_axis (test_torch_tfgridnet_train's widths) ---
GRID_ARGS = dict(n_fft=32, stride=16, n_layers=1, lstm_hidden_units=16,
                 attn_n_head=2, attn_approx_qk_dim=32, emb_dim=8, emb_ks=4,
                 emb_hs=1, spk_emb_dim=16, spk_fuse_type="multiply",
                 joint_training=False)
GRID_SCHED = dict(num_epochs=2, epoch_iter=4, initial_lr=1e-3,
                  final_lr=2.5e-5, warm_up_epoch=0)
GRID_SAMPLES = 1200  # 76 frames: T' 82 and Q' 23 folded rows a row


def grid_batch(rows):
    """`rows` rows: each a source plus another, the first as the target."""
    rng = np.random.default_rng(7)
    src = (rng.standard_normal((rows, 2, GRID_SAMPLES)) * 0.1).astype(
        np.float32)
    return {"wav_mix": src.sum(axis=1), "wav_targets": src[:, 0].copy(),
            "spk_embeds": rng.standard_normal((rows, 16)).astype(np.float32)}


def seeded_grid(**kw):
    torch.manual_seed(0)
    return TFGridNet(**GRID_ARGS, **kw)


def grid_steps(rows, mesh=None, steps=2, shares=None):
    """`steps` port train steps of seeded_grid(shard_model_axis=True) on
    the data rank's share of grid_batch(rows) (all of it without a mesh;
    `shares` = (data ranks, model ranks) takes each step in one process as
    chip_smoke.py's one-card reference of the grid does: each data rank's
    rows in turn as make_train_step's microbatches, each block's sharded
    branches on each model rank's share in turn) -> ([(loss, the gradient
    handed to the optimizer, parameters)], the folded rows the first
    forward's intra and inter BiLSTMs saw)."""
    model = seeded_grid(shard_model_axis=True)
    if mesh is not None:
        mesh.attach(model)
    data_shares = 1
    if shares is not None:
        data_shares, model_shares = shares
        model.set_model_group(model_shares)
    opt = trainer.make_optimizer(model, exponential_decrease(**GRID_SCHED),
                                 weight_decay=1e-4, clip_grad=5.0)
    grads, update = [], opt.update
    opt.update = lambda g: grads.append(
        {k: v.detach().numpy().copy() for k, v in g.items()}) or update(g)
    state = trainer.TrainState(model=model, optimizer=opt, mesh=mesh)
    seen = {}

    def record(name):
        def hook(module, args):
            seen.setdefault(name, args[0].shape[0])
        return hook

    for name in ("intra", "inter"):
        getattr(model.block_0, f"{name}_rnn").register_forward_pre_hook(
            record(name))
    data_rank, data_size = (mesh.data_rank, mesh.data_size) if mesh \
        else (0, 1)
    share = rows // data_size
    batch = trainer.batch_to_device(
        {k: v[data_rank * share:(data_rank + 1) * share]
         for k, v in grid_batch(rows).items()}, "cpu")
    step = trainer.make_train_step(parse_loss("SISDR"),
                                   accum_steps=data_shares)
    out = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        out.append((float(metrics["loss"]), grads[-1],
                    {k: v.detach().numpy().copy()
                     for k, v in model.named_parameters()}))
    return out, seen


def rank_grid(rank, world, port, out_dir, model_axis, rows, config=None):
    """grid_steps on this rank's place in the (world / model_axis) x
    model_axis grid; then, with `config`, bin/train under WESEP_DIST ->
    {"steps", "seen", "mesh" (data rank, data size, model rank), "bin"
    (steps, parameters)}."""
    from wesep_tpu_torch.train.mesh import make_mesh

    mesh = make_mesh(model_axis)
    steps, seen = grid_steps(rows, mesh)
    result = {"steps": steps, "seen": seen,
              "mesh": (mesh.data_rank, mesh.data_size, mesh.model_rank)}
    if config is not None:
        from wesep_tpu_torch.bin.train import train

        state = train(config)
        result["bin"] = (state.step, {
            k: v.detach().numpy().copy()
            for k, v in state.model.named_parameters()})
    return result


# --- spawning ---
def _rank_main(target, rank, world, port, out_dir, args):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from wesep_tpu_torch.bin.train import init_distributed

    os.environ.update(WESEP_DIST="1", WESEP_COORDINATOR=f"127.0.0.1:{port}",
                      WESEP_NUM_PROCESSES=str(world),
                      WESEP_PROCESS_ID=str(rank))
    init_distributed(torch.device("cpu"))
    try:
        result = target(rank, world, port, out_dir, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(target, world, out_dir, *args, limit=120,
              meanwhile=lambda: None):
    """`target` in `world` spawned ranks, each within `limit` s of its
    start -> (each rank's result, what `meanwhile` returned, run here
    while the ranks run)."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(target, rank, world, port, str(out_dir), args))
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
    return [torch.load(os.path.join(str(out_dir), f"rank{r}.pt"),
                       weights_only=False) for r in range(world)], here
