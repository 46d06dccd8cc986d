"""The port's side of tests/test_torch_online_train.py: a tiny BSRNN, its
batch of dry sources and train steps with the simulation on the device.
It imports neither JAX nor the JAX package, so the ranks the test spawns
start quickly."""

import os
import socket

import numpy as np
import torch

from wesep_tpu_torch.models.bsrnn import BSRNN
from wesep_tpu_torch.train import trainer
from wesep_tpu_torch.train.losses import parse_loss
from wesep_tpu_torch.train.schedulers import exponential_decrease

ARGS = dict(sr=16000, win=512, stride=128, feature_dim=8, num_repeat=1,
            spk_fuse_type="multiply", use_spk_transform=False,
            multi_fuse=False, joint_training=False, spk_emb_dim=16,
            remat=False)
SCHED = dict(num_epochs=2, epoch_iter=4, initial_lr=1e-3, final_lr=1e-4,
             warm_up_epoch=0)
AUG = {"reverb_prob": 0.5, "use_random_snr": True, "noise_prob": 0.5,
       "noise_snr": (-5.0, 25.0), "sample_rate": 16000}
SEED = 42
MIXTURES, SAMPLES = 4, 4000


def dry_batch():
    """4 mixtures of 2 sources x 4000 samples, their noise chunks and the
    8 rows' 16-d embeddings."""
    rng = np.random.default_rng(0)
    return {"wav_srcs": (rng.standard_normal((MIXTURES, 2, SAMPLES))
                         * 0.1).astype(np.float32),
            "wav_noise": (rng.standard_normal((MIXTURES, SAMPLES))
                          * 0.01).astype(np.float32),
            "spk_embeds": rng.standard_normal((2 * MIXTURES, 16)).astype(
                np.float32)}


def seeded_model():
    torch.manual_seed(0)
    return BSRNN(**ARGS)


def port_steps(accum=1, steps=2, rows=None, device_augment=None):
    """`steps` port train steps from seeded_model() on the batch's mixtures
    `rows` (a slice; all by default), augmented with `device_augment`
    (default AUG) -> [(loss, the gradient handed to the optimizer,
    parameters)]."""
    model = seeded_model()
    opt = trainer.make_optimizer(model, exponential_decrease(**SCHED),
                                 weight_decay=1e-4, clip_grad=5.0)
    grads = []
    update = opt.update
    opt.update = lambda g: grads.append(
        {k: v.detach().numpy().copy() for k, v in g.items()}) or update(g)
    state = trainer.TrainState(model=model, optimizer=opt)
    step = trainer.make_train_step(parse_loss("SISDR"), seed=SEED,
                                   device_augment=device_augment or AUG,
                                   accum_steps=accum)
    batch = dry_batch()
    if rows is not None:
        batch = {"wav_srcs": batch["wav_srcs"][rows],
                 "wav_noise": batch["wav_noise"][rows],
                 "spk_embeds": batch["spk_embeds"][
                     2 * rows.start:2 * rows.stop]}
    tbatch = trainer.batch_to_device(batch, "cpu")
    out = []
    for _ in range(steps):
        state, metrics = step(state, tbatch)
        out.append((float(metrics["loss"]), grads[-1],
                    {k: v.detach().numpy().copy()
                     for k, v in model.named_parameters()}))
    return out


def rank_steps(rank, world, port, out_dir):
    """Two steps in a gloo group joined as bin/train joins it (WESEP_DIST),
    on this rank's share of the mixtures; saved to out_dir/rank<r>.pt."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from wesep_tpu_torch.bin.train import init_distributed

    os.environ.update(WESEP_DIST="1", WESEP_COORDINATOR=f"127.0.0.1:{port}",
                      WESEP_NUM_PROCESSES=str(world),
                      WESEP_PROCESS_ID=str(rank))
    init_distributed(torch.device("cpu"))
    try:
        share = MIXTURES // world
        result = port_steps(rows=slice(rank * share, (rank + 1) * share))
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
