"""MetricGAN training entry point: a TSE generator and the CMGAN metric
discriminator, one device a process.

Counterpart of wesep_tpu/bin/train_gan.py with its semantics: bin/train's
data chain, loss table and generator (`model.tse_model`), plus a
discriminator (`model.discriminator`, default CMGAN_Discriminator, with
`model_args.discriminator`), each with its own optimizer chain (clip ->
+ weight_decay * p -> Adam -> its own schedule: `optimizer_args` and
`scheduler(_args).discriminator`, defaulting to the generator's), and
train/trainer_gan's step with `gan_loss_weight` (default 0.05) and
`gan_metric`: `pesq` (default; P.862 on the device), `pesq_host` (per row
on the host) or `sisdr`. Every epoch trains `epoch_iter` GAN steps,
validates the generator and writes `models/checkpoint_<N>.ckpt`, a
two-model bundle ([G, D] parameters, optimizer states and buffers, the
step), with a `latest_checkpoint.ckpt` link, and `final_checkpoint.ckpt`
at the end; `--checkpoint` resumes both models and both optimizers;
SIGTERM ends the epoch at the next batch and writes
`preempt_epoch<N>.ckpt`. bin/average_model averages model 0 of such
bundles, the generator, which bin/infer decodes.

As the JAX package does, it reads neither `compute_dtype` (the GAN step
runs in f32) nor `model_init` (the generator starts from its seeded init).
It runs on `cuda` unless the config or the caller gives `device: cpu`.

Data parallelism on bin/train's contract (WESEP_DIST=1, WESEP_COORDINATOR,
WESEP_NUM_PROCESSES, WESEP_PROCESS_ID; one process a card): each rank
reads its share of the shard list, trains sample_num_per_epoch / world /
batch_size GAN steps an epoch on its rows, and the step reduces both
models' gradients over the ranks (train/trainer_gan.py); only rank 0 logs
to a file and writes checkpoints. As the JAX train_gan builds a data-only
mesh whatever `model_axis` says, `model_axis` changes nothing here.
`--checkpoint` takes this package's two-model bundles or the JAX
package's msgpack ones (G at index 0, D at index 1).

    python -m wesep_tpu_torch.bin.train_gan --config confs/dpcc_init_gan.yaml \\
        [--set key.sub=value ...] [--checkpoint path]
    WESEP_DIST=1 WESEP_COORDINATOR=localhost:29400 WESEP_NUM_PROCESSES=2 \\
        WESEP_PROCESS_ID=<0|1> python -m wesep_tpu_torch.bin.train_gan ...
"""

import argparse
import functools
import os


def get_args():
    parser = argparse.ArgumentParser(description="wesep_tpu_torch train_gan")
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", default=None,
                        help="resume from checkpoint_<N>.ckpt")
    parser.add_argument(
        "--set", dest="overrides", action="append", default=[],
        metavar="KEY=VALUE", help="config overrides (dot paths)",
    )
    return parser.parse_args()


def train_gan(config, checkpoint=None, overrides=None, **kwargs):
    """Run the configured MetricGAN training; return the final
    (generator, discriminator) TrainStates."""
    from wesep_tpu_torch.bin.train import (
        build_loaders,
        build_model,
        load_enroll_maps,
        relink,
        resume_epoch,
        setup_run,
        sigterm_stop,
    )
    from wesep_tpu_torch.models import get_model
    from wesep_tpu_torch.train.checkpoint import (
        restore_train_state,
        save_checkpoint,
        split_state,
    )
    from wesep_tpu_torch.train.executor import Executor
    from wesep_tpu_torch.train.schedulers import get_scheduler
    from wesep_tpu_torch.train.trainer import (
        TrainState,
        batch_to_device,
        make_eval_step,
        make_optimizer,
    )
    from wesep_tpu_torch.train.trainer_gan import (
        make_gan_train_step,
        metric_pesq,
        metric_pesq_callback,
        metric_sisdr_norm,
    )
    from wesep_tpu_torch.utils.config import table_row

    configs, device, model_dir, logger, (
        criterion, loss_posi, loss_weight), (rank, world_size) = setup_run(
            config, overrides, kwargs)
    tse_args = configs["model_args"]["tse_model"]
    joint_training = tse_args.get("joint_training", False)
    multi_task = tse_args.get("multi_task", False)
    train_loader, val_loader, epoch_iter, val_iter = build_loaders(
        configs, *load_enroll_maps(configs, joint_training, multi_task),
        rank=rank, world_size=world_size)
    logger.info("epoch iteration number: %d", epoch_iter)
    logger.info("val iteration number: %d", val_iter)

    # generator + discriminator, each with its own schedule and optimizer
    gen = build_model(configs, device)[0].to(device)
    disc_name = configs["model"].get("discriminator", "CMGAN_Discriminator")
    disc_args = configs.get("model_args", {}).get("discriminator") or {}
    # D as the JAX train_gan draws it: params and spectral-norm state from
    # PRNGKey(1), whatever the config's seed
    disc = get_model(disc_name)(**disc_args).to(device).init_like_jax(
        1, device)
    g_sched_args = dict(configs["scheduler_args"]["tse_model"],
                        num_epochs=configs["num_epochs"],
                        epoch_iter=epoch_iter)
    d_sched_args = dict(configs["scheduler_args"].get("discriminator",
                                                      g_sched_args))
    d_sched_args.setdefault("num_epochs", configs["num_epochs"])
    d_sched_args.setdefault("epoch_iter", epoch_iter)
    g_sched = get_scheduler(configs["scheduler"]["tse_model"], **g_sched_args)
    d_sched = get_scheduler(
        configs["scheduler"].get("discriminator",
                                 configs["scheduler"]["tse_model"]),
        **d_sched_args)
    g_opt_args = configs.get("optimizer_args", {}).get("tse_model", {})
    d_opt_args = configs.get("optimizer_args", {}).get("discriminator",
                                                       g_opt_args)
    clip = configs.get("clip_grad", 5.0)
    g_state = TrainState(gen, make_optimizer(
        gen, g_sched, weight_decay=g_opt_args.get("weight_decay", 0.0),
        clip_grad=clip))
    d_state = TrainState(disc, make_optimizer(
        disc, d_sched, weight_decay=d_opt_args.get("weight_decay", 0.0),
        clip_grad=clip))
    for name, m in (("tse_model", gen), ("discriminator", disc)):
        logger.info("%s size: %.2f M", name,
                    sum(p.numel() for p in m.parameters()) / 1e6)

    sr = configs["dataset_args"].get("resample_rate", 16000)
    metric = {
        "pesq": functools.partial(metric_pesq, fs=sr),
        "pesq_host": functools.partial(metric_pesq_callback, fs=sr),
        "sisdr": metric_sisdr_norm,
    }[configs.get("gan_metric", "pesq")]
    gan_step = make_gan_train_step(
        criterion, loss_posi, loss_weight, multi_task,
        gan_loss_weight=configs.get("gan_loss_weight", 0.05),
        metric_fn=metric, seed=configs.get("seed", 42))
    eval_step = make_eval_step(criterion)

    start_epoch = 1
    if checkpoint:
        restore_train_state(g_state, checkpoint, model_index=0)
        restore_train_state(d_state, checkpoint, model_index=1)
        start_epoch = resume_epoch(checkpoint)
        logger.info("Load checkpoint: %s", checkpoint)
    logger.info("start_epoch: %d", start_epoch)

    def save(name):
        if rank != 0:
            return
        (g_params, g_bufs), (d_params, d_bufs) = split_state(gen), \
            split_state(disc)
        save_checkpoint(
            os.path.join(model_dir, name), [g_params, d_params],
            [g_state.optimizer.state_dict(), d_state.optimizer.state_dict()],
            [g_bufs, d_bufs], step=g_state.step)

    # the executor runs one "train step" on (G, D) state pairs and logs
    # g_loss; se_loss and d_loss are averaged here from the same tensors
    extra = {"se_loss": [], "d_loss": []}

    def step(states, batch):
        states, metrics = gan_step(states, batch)
        for k in extra:
            extra[k].append(metrics[k])
        return states, metrics

    device_put = functools.partial(batch_to_device, device=device)
    executor = Executor()
    log_interval = configs.get("log_batch_interval", 100)
    logger.info(table_row(("Train/Val", "Epoch", "iter", "Loss", "rate")))
    states = (g_state, d_state)
    with sigterm_stop() as stop_requested:
        for epoch in range(start_epoch, configs["num_epochs"] + 1):
            train_loader.set_epoch(epoch)
            for v in extra.values():
                v.clear()
            states, g_loss = executor.train(
                train_loader, step, states, epoch_iter, epoch, logger,
                log_interval, device_put, sample_rate=sr,
                should_stop=stop_requested)
            if executor.stopped:
                save(f"preempt_epoch{epoch}.ckpt")
                logger.warning(
                    "preempted during epoch %d: saved preempt_epoch%d.ckpt; "
                    "resume with --checkpoint", epoch, epoch)
                break
            val_loss = executor.cv(val_loader, eval_step, g_state, val_iter,
                                   epoch, logger, log_interval, device_put)
            means = {k: sum(float(x) for x in v) / max(len(v), 1)
                     for k, v in extra.items()}
            logger.info(
                "Epoch %d g_loss %.4f se_loss %.4f d_loss %.4f val %.4f",
                epoch, g_loss, means["se_loss"], means["d_loss"], val_loss)
            if epoch % configs.get("save_epoch_interval", 1) == 0:
                name = f"checkpoint_{epoch}.ckpt"
                save(name)
                if rank == 0:
                    relink(model_dir, "latest_checkpoint.ckpt", name)
        else:
            if rank == 0:
                relink(model_dir, "final_checkpoint.ckpt",
                       f"checkpoint_{configs['num_epochs']}.ckpt")
    return states


def main():
    args = get_args()
    train_gan(args.config, checkpoint=args.checkpoint,
              overrides=args.overrides)


if __name__ == "__main__":
    main()
