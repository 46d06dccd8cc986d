"""Training entry point: YAML-config driven, one process on one device.

Counterpart of wesep_tpu/bin/train.py with the same semantics: the train
and validation chains (pre-extracted embeddings, or enrollment wavs and
speaker labels for a jointly trained ConvTasNet / SpEx+), the model, the
loss table, the optimizer chain and the schedule come from the config; every epoch trains `epoch_iter` batches,
validates, and writes `models/checkpoint_<N>.ckpt` (parameters and BatchNorm
statistics, optimizer state, step) with a `latest_checkpoint.ckpt` link, and `final_checkpoint
.ckpt` at the end; `--checkpoint` resumes by file name; SIGTERM ends the
epoch at the next batch and writes `preempt_epoch<N>.ckpt`. Several devices
or processes (`model_axis`, WESEP_DIST) come with the data-parallel slice.

It runs on `cuda` unless the config or the caller gives `device: cpu`.

    python -m wesep_tpu_torch.bin.train --config confs/bsrnn.yaml \\
        [--set key.sub=value ...] [--checkpoint path]
"""

import argparse
import functools
import os
import re
import signal
from pprint import pformat


def get_args():
    parser = argparse.ArgumentParser(description="wesep_tpu_torch train")
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", default=None,
                        help="resume from checkpoint_<N>.ckpt")
    parser.add_argument(
        "--set", dest="overrides", action="append", default=[],
        metavar="KEY=VALUE", help="config overrides (dot paths)",
    )
    return parser.parse_args()


def load_enroll_maps(configs, joint_training, multi_task):
    """Cue maps of the train and validation sets: pre-extracted embeddings
    or, for joint training, enrollment wavs (train: spk -> [(utt, wav
    path)], validation: utt -> wav path) and, with `multi_task`, the
    speaker-to-id map of the training speakers."""
    from wesep_tpu_torch.utils.file_utils import (
        load_speaker_embeddings,
        read_label_file,
        read_spk2enroll_json,
        read_vec_scp_file,
    )

    dict_spk = {}
    tr_utt2spk = configs["train_utt2spk"]
    tr_spk_embeds = configs.get("train_spk_embeds", None)
    if not joint_training and tr_spk_embeds:
        tr_spk2embed_dict = load_speaker_embeddings(tr_spk_embeds, tr_utt2spk)
    else:
        tr_spk2embed_dict, dict_spk_all = read_spk2enroll_json(
            configs["train_spk2utt"])
        if multi_task:
            dict_spk = dict_spk_all
    with open(tr_utt2spk) as f:
        n_train_utts = sum(1 for _ in f)
    val_spk_embeds = configs.get("val_spk_embeds", None)
    if not joint_training and val_spk_embeds:
        val_spk2embed_dict = read_vec_scp_file(val_spk_embeds)
    else:
        val_spk2embed_dict = read_label_file(configs["val_spk2utt"])
    val_spk1_embed = read_label_file(configs["val_spk1_enroll"])
    val_spk2_embed = read_label_file(configs["val_spk2_enroll"])
    return (tr_spk2embed_dict, dict_spk, n_train_utts, val_spk2embed_dict,
            val_spk1_embed, val_spk2_embed)


def default_enroll_len(dataset_args, joint_training):
    """Samples every enrollment wav is wrapped or trimmed to, so that all
    batches have one shape: `enroll_len`, else enroll_sec * sample rate for
    joint training, else None (embeddings pass through)."""
    enroll_len = dataset_args.get("enroll_len", None)
    if enroll_len is None and joint_training:
        enroll_len = int(dataset_args.get("enroll_sec", 6)
                         * dataset_args.get("resample_rate", 16000))
    return enroll_len


def _relink(model_dir: str, link: str, target: str):
    path = os.path.join(model_dir, link)
    if os.path.islink(path) or os.path.exists(path):
        os.remove(path)
    os.symlink(target, path)


def train(config, checkpoint=None, overrides=None, **kwargs):
    """Run the configured training; return the final TrainState."""
    import torch
    import yaml

    from wesep_tpu_torch.data import (
        BatchLoader,
        Dataset,
        MultiWorkerLoader,
        tse_collate_fn,
    )
    from wesep_tpu_torch.device import resolve_device
    from wesep_tpu_torch.models import get_model
    from wesep_tpu_torch.train.checkpoint import (
        load_pretrained_model,
        restore_train_state,
        save_checkpoint,
        split_state,
    )
    from wesep_tpu_torch.train.executor import Executor
    from wesep_tpu_torch.train.losses import parse_loss
    from wesep_tpu_torch.train.schedulers import get_scheduler
    from wesep_tpu_torch.train.trainer import (
        TrainState,
        batch_to_device,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )
    from wesep_tpu_torch.utils.config import (
        deep_update,
        parse_config_or_kwargs,
        parse_override_args,
        set_seed,
        setup_logger,
        table_row,
    )

    if os.environ.get("WESEP_DIST"):
        raise NotImplementedError(
            "WESEP_DIST (several processes) waits for the data-parallel "
            "slice; see ROADMAP.md queue A, data parallelism")
    configs = parse_config_or_kwargs(config, **kwargs)
    deep_update(configs, parse_override_args(overrides))
    if int(configs.get("model_axis", 1)) > 1:
        raise NotImplementedError(
            "model_axis > 1 (a model-sharding mesh) waits for the "
            "data-parallel slice; see ROADMAP.md queue A, data parallelism")
    device = resolve_device(configs.get("device"))

    exp_dir = configs["exp_dir"]
    model_dir = os.path.join(exp_dir, "models")
    os.makedirs(model_dir, exist_ok=True)
    logger = setup_logger(exp_dir)
    logger.info("exp_dir is: %s", exp_dir)
    for line in pformat(configs).split("\n"):
        logger.info(line)
    set_seed(configs.get("seed", 42))

    criterion = parse_loss(configs.get("loss", "SISDR"))
    loss_args = configs.get("loss_args") or {}
    loss_posi = loss_args.get("loss_posi", [[0]])
    loss_weight = loss_args.get("loss_weight", [[1.0]])

    model_name = configs["model"]["tse_model"]
    model_args = dict(configs["model_args"]["tse_model"])
    joint_training = model_args.get("joint_training", False)
    multi_task = model_args.get("multi_task", False)
    if joint_training and not model_name.startswith("ConvTasNet"):
        raise NotImplementedError(
            f"joint_training of {model_name} (an external speaker encoder "
            "on fbank features) is not ported yet; see ROADMAP.md queue A "
            "item 4 (the joint v2 BSRNN and TF-GridNet)")

    (tr_spk2embed_dict, dict_spk, n_train_utts, val_spk2embed_dict,
     val_spk1_embed, val_spk2_embed) = load_enroll_maps(
        configs, joint_training, multi_task)

    dataset_args = configs["dataset_args"]
    online_mix = dataset_args.get("online_mix", False)
    device_augment = online_mix and dataset_args.get("device_augment", True)

    def build_train_dataset(worker_id=0, num_workers=1):
        return Dataset(
            configs["data_type"], configs["train_data"], dataset_args,
            tr_spk2embed_dict, None, None, state="train",
            joint_training=joint_training, dict_spk=dict_spk,
            whole_utt=configs.get("whole_utt", False),
            repeat_dataset=configs.get("repeat_dataset", True),
            noise_prob=dataset_args.get("noise_prob", 0),
            reverb_prob=dataset_args.get("reverb_prob", 0),
            noise_enroll_prob=dataset_args.get("noise_enroll_prob", 0),
            reverb_enroll_prob=dataset_args.get("reverb_enroll_prob", 0),
            specaug_enroll_prob=dataset_args.get("specaug_enroll_prob", 0),
            online_mix=online_mix, device_augment=device_augment,
            noise_lmdb_file=dataset_args.get("noise_lmdb_file", None),
            worker_id=worker_id, num_workers=num_workers,
        )

    train_dataset = build_train_dataset()
    val_dataset = Dataset(
        configs["data_type"], configs["val_data"], dataset_args,
        val_spk2embed_dict, val_spk1_embed, val_spk2_embed, state="val",
        joint_training=joint_training,
        whole_utt=configs.get("whole_utt", False),
        repeat_dataset=True, online_mix=False,
    )

    dataloader_args = dict(configs.get("dataloader_args", {}))
    batch_size = dataloader_args.get("batch_size", 8)
    collate = functools.partial(
        tse_collate_fn,
        fixed_enroll_len=default_enroll_len(dataset_args, joint_training))
    num_workers = dataloader_args.get("num_workers", 0)
    if num_workers and num_workers > 1:
        train_loader = MultiWorkerLoader(
            [build_train_dataset(w, num_workers) for w in range(num_workers)],
            batch_size=batch_size, collate_fn=collate, drop_last=True,
        )
    else:
        train_loader = BatchLoader(
            train_dataset, batch_size=batch_size, collate_fn=collate,
            drop_last=True,
            prefetch=dataloader_args.get("prefetch_factor", 4),
        )
    val_loader = BatchLoader(
        val_dataset, batch_size=batch_size, collate_fn=collate,
        drop_last=True, prefetch=2,
    )

    sample_num = dataset_args.get("sample_num_per_epoch", 0) or (
        n_train_utts // 2)
    epoch_iter = max(sample_num // batch_size, 1)
    val_iter = max(len(val_spk2embed_dict) // 2 // batch_size, 1)
    logger.info("epoch iteration number: %d", epoch_iter)
    logger.info("val iteration number: %d", val_iter)

    # model / optimizer / scheduler
    model_args.pop("spk_model_init", None)
    model = get_model(model_name)(**model_args).to(device)
    sched_args = dict(configs["scheduler_args"]["tse_model"])
    sched_args["num_epochs"] = configs["num_epochs"]
    sched_args["epoch_iter"] = epoch_iter
    schedule = get_scheduler(configs["scheduler"]["tse_model"], **sched_args)
    opt_args = configs.get("optimizer_args", {}).get("tse_model", {})
    freeze = ("spk_model_net",) if model_args.get("spk_model_freeze", False) \
        else ()
    optimizer = make_optimizer(
        model, schedule,
        weight_decay=opt_args.get("weight_decay", 0.0),
        clip_grad=configs.get("clip_grad", 5.0),
        freeze_prefixes=freeze,
    )

    # mixed precision: 'compute_dtype: bfloat16' (or 'enable_amp') runs the
    # forward and backward in bf16 with f32 parameters and accumulation
    dtype_name = configs.get(
        "compute_dtype", "bfloat16" if configs.get("enable_amp") else None)
    compute_dtype = getattr(torch, dtype_name) if dtype_name else None
    accum_steps = int(
        configs.get("accum_grad", configs.get("accum_steps", 1)) or 1)
    train_step = make_train_step(
        criterion, loss_posi, loss_weight, multi_task,
        compute_dtype=compute_dtype, accum_steps=accum_steps,
        ssa_enroll_prob=dataset_args.get("SSA_enroll_prob", 0),
        device_augment=dataset_args if device_augment else None,
    )
    eval_step = make_eval_step(criterion)
    state = TrainState(model=model, optimizer=optimizer, step=0)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("tse_model size: %.2f M", n_params / 1e6)

    model_init = configs.get("model_init", {}).get("tse_model")
    if model_init:
        logger.info("Load initial model from %s", model_init)
        load_pretrained_model(model, model_init)
    start_epoch = 1
    if checkpoint:
        restore_train_state(state, checkpoint)
        m = re.findall(r"(?<=checkpoint_)\d+(?=\.ckpt)", checkpoint)
        start_epoch = int(m[0]) + 1 if m else 1
        mp = re.findall(r"(?<=preempt_epoch)\d+(?=\.ckpt)", checkpoint)
        if mp:  # redo the interrupted epoch with the saved optimizer state
            start_epoch = int(mp[0])
        logger.info("Load checkpoint: %s", checkpoint)
    logger.info("start_epoch: %d", start_epoch)

    with open(os.path.join(exp_dir, "config.yaml"), "w") as fout:
        fout.write(yaml.dump(configs))

    def save(name):
        params, buffers = split_state(model)
        save_checkpoint(
            os.path.join(model_dir, name), [params],
            [optimizer.state_dict()], [buffers], step=state.step)
        _relink(model_dir, "latest_checkpoint.ckpt", name)

    # preemption safety: SIGTERM asks for a clean stop at the next batch
    # boundary; the loop then writes a resumable mid-epoch checkpoint
    stop_requested = {"flag": False}

    def _on_term(signum, frame):
        stop_requested["flag"] = True

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        pass  # not the main thread (callers inside another program, tests)

    device_put = functools.partial(batch_to_device, device=device)
    executor = Executor()
    log_interval = configs.get("log_batch_interval", 100)
    logger.info(table_row(("Train/Val", "Epoch", "iter", "Loss", "rate")))
    for epoch in range(start_epoch, configs["num_epochs"] + 1):
        train_loader.set_epoch(epoch)
        state, train_loss = executor.train(
            train_loader, train_step, state, epoch_iter, epoch, logger,
            log_interval, device_put,
            sample_rate=dataset_args.get("resample_rate", 16000),
            should_stop=lambda: stop_requested["flag"],
        )
        if executor.stopped:
            save(f"preempt_epoch{epoch}.ckpt")
            logger.warning(
                "preempted during epoch %d: saved preempt_epoch%d.ckpt; "
                "resume with --checkpoint (epoch %d restarts with this "
                "optimizer state)", epoch, epoch, epoch)
            break
        val_loss = executor.cv(val_loader, eval_step, state, val_iter, epoch,
                               logger, log_interval, device_put)
        logger.info("Epoch %d train_loss %.4f val_loss %.4f",
                    epoch, train_loss, val_loss)
        if (epoch % configs.get("save_epoch_interval", 1) == 0
                or epoch >= configs["num_epochs"] - configs.get("num_avg", 2)):
            save(f"checkpoint_{epoch}.ckpt")
    if not executor.stopped:
        _relink(model_dir, "final_checkpoint.ckpt",
                f"checkpoint_{configs['num_epochs']}.ckpt")
    return state


def main():
    args = get_args()
    train(args.config, checkpoint=args.checkpoint, overrides=args.overrides)


if __name__ == "__main__":
    main()
