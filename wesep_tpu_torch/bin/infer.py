"""Inference entry point: whole-utterance TSE + SI-SNR(i) reporting.

Counterpart of wesep_tpu/bin/infer.py with the same semantics, so the two
agree on the same shard and weights:

- the cue of a target is a pre-extracted embedding or, for a jointly
  trained ConvTasNet / SpEx+, an enrollment wav wrapped or trimmed to
  `enroll_sec` seconds; multi-scale models are scored on their first
  (short-window) estimate;
- each mixture gives one row per target speaker; rows are buffered per
  length bucket (`length_bucket`, default 16000 samples), zero-padded to
  the bucket and decoded `infer_batch_size` rows at a time (default 2);
  a bucket's remainder rows are zero-padded rows whose outputs are dropped.
  The padding matters: BSRNN's GroupNorms take their statistics over the
  padded frames too;
- each estimate is trimmed to its utterance, peak-normalised to 0.9 and
  written as `Utt{n}-{key}-T{row}.wav`, with `spk{i}.scp` listing them;
- per-utterance and average SI-SNR / SI-SNRi and the acceptance rate
  (SI-SNRi > 1 dB) are logged; the averages are returned.

It runs on `cuda` unless the config or the caller gives `device: cpu`.

    python -m wesep_tpu_torch.bin.infer --config conf.yaml --set checkpoint=...
"""

import argparse
import functools
import os
import time

import numpy as np
import torch


def get_args():
    parser = argparse.ArgumentParser(description="wesep_tpu_torch infer")
    parser.add_argument("--config", required=True)
    parser.add_argument(
        "--set", dest="overrides", action="append", default=[],
        metavar="KEY=VALUE",
    )
    return parser.parse_args()


def generate_enhanced_scp(audio_dir: str, n_spk: int = 2):
    """Write spk{i}.scp from the Utt*-{key}-T{i-1}.wav naming convention."""
    names = sorted(os.listdir(audio_dir))
    for i in range(1, n_spk + 1):
        with open(os.path.join(audio_dir, f"spk{i}.scp"), "w") as f:
            for name in names:
                parts = name[:-4].split("-")
                if (name.endswith(".wav") and len(parts) >= 3
                        and parts[-1] == f"T{i - 1}"):
                    key = "-".join(parts[1:-1])
                    f.write(f"{key} {os.path.join(audio_dir, name)}\n")


def infer(config, overrides=None, **kwargs):
    """Decode the configured test set; return (avg SI-SNR, avg SI-SNRi)."""
    from wesep_tpu_torch.bin.train import default_enroll_len
    from wesep_tpu_torch.data import BatchLoader, Dataset, tse_collate_fn_2spk
    from wesep_tpu_torch.data.wav_io import write_wav
    from wesep_tpu_torch.device import resolve_device
    from wesep_tpu_torch.models import get_model
    from wesep_tpu_torch.train.checkpoint import load_checkpoint, model_state
    from wesep_tpu_torch.utils.config import (
        deep_update,
        parse_config_or_kwargs,
        parse_override_args,
        set_seed,
        setup_logger,
    )
    from wesep_tpu_torch.utils.file_utils import (
        read_label_file,
        read_vec_scp_file,
    )
    from wesep_tpu_torch.utils.score import cal_SISNRi

    start = time.time()
    configs = parse_config_or_kwargs(config, **kwargs)
    deep_update(configs, parse_override_args(overrides))
    device = resolve_device(configs.get("device"))
    save_wav = configs.get("save_wav", True)
    set_seed(configs.get("seed", 42))
    sample_rate = 16000 if configs.get("fs", "16k") in (None, "16k", 16000) \
        else 8000

    model_args = dict(configs["model_args"]["tse_model"])
    model_args.pop("spk_model_init", None)
    joint_training = model_args.get("joint_training", False)
    model_name = configs["model"]["tse_model"]
    if joint_training and not model_name.startswith("ConvTasNet"):
        raise NotImplementedError(
            f"joint_training inference of {model_name} (an external speaker "
            "encoder on fbank features) is not ported yet; see ROADMAP.md "
            "queue A item 4 (the joint v2 BSRNN and TF-GridNet)")
    model = get_model(model_name)(**model_args)
    model_path = configs["checkpoint"]

    logger = setup_logger(configs["exp_dir"], name="infer.log")
    logger.info("Load checkpoint from %s", model_path)
    audio_dir = os.path.join(configs["exp_dir"], "audio")
    os.makedirs(audio_dir, exist_ok=True)
    model.load_state_dict(model_state(load_checkpoint(model_path)))
    model.to(device).eval()

    test_spk_embeds = configs.get("test_spk_embeds", None)
    if not joint_training and test_spk_embeds:
        test_spk2embed_dict = read_vec_scp_file(test_spk_embeds)
    else:
        test_spk2embed_dict = read_label_file(configs["test_spk2utt"])
    test_dataset = Dataset(
        configs["data_type"],
        configs["test_data"],
        configs["dataset_args"],
        test_spk2embed_dict,
        read_label_file(configs["test_spk1_enroll"]),
        read_label_file(configs["test_spk2_enroll"]),
        state="test",
        joint_training=joint_training,
        whole_utt=configs.get("whole_utt", True),
    )
    # one enrollment length (bin/train's default), so every step of one
    # length bucket has one shape
    collate = functools.partial(
        tse_collate_fn_2spk, fixed_enroll_len=default_enroll_len(
            dict(configs["dataset_args"], resample_rate=sample_rate),
            joint_training))
    loader = BatchLoader(test_dataset, batch_size=1, collate_fn=collate,
                         drop_last=False)
    logger.info("test number: %d", len(test_spk2embed_dict) // 2)

    bucket = int(configs.get("length_bucket", 16000))
    rows_per_step = int(configs.get("infer_batch_size", 2))

    total_sisnr = total_sisnri = 0.0
    total_cnt = accept_cnt = 0
    audio_total = 0.0

    def _flush(pad_len, rows):
        nonlocal total_sisnr, total_sisnri, total_cnt, accept_cnt
        mix_b = np.zeros((rows_per_step, pad_len), np.float32)
        enr_b = np.zeros(
            (rows_per_step,) + rows[0]["enroll"].shape, np.float32
        )
        for r_i, r in enumerate(rows):
            mix_b[r_i, : r["t_len"]] = r["mix"]
            enr_b[r_i] = r["enroll"]
        with torch.inference_mode():
            est = model(torch.from_numpy(mix_b).to(device),
                        torch.from_numpy(enr_b).to(device))[0]
        if isinstance(est, (list, tuple)):
            est = est[0]  # multi-scale decoders: the short-window estimate
        ests = est.float().cpu().numpy()
        for r, est in zip(rows, ests):
            est = est[: r["t_len"]]
            est = est / np.max(np.abs(est)) * 0.9
            if save_wav:
                write_wav(
                    os.path.join(
                        audio_dir, f"Utt{r['utt']}-{r['key']}-T{r['row']}.wav"
                    ),
                    est,
                    sample_rate,
                )
            sisnr, sisnri = cal_SISNRi(est, r["target"], r["mix"])
            logger.info(
                "Utt=%d Key=%s Target=%s SI-SNR=%.3f SI-SNRi=%.3f",
                r["utt"], r["key"], r["spk"], sisnr, sisnri,
            )
            total_sisnr += sisnr
            total_sisnri += sisnri
            total_cnt += 1
            if sisnri > 1.0:
                accept_cnt += 1

    groups = {}  # pad_len -> buffered rows
    for i, batch in enumerate(loader):
        mix = batch["wav_mix"]
        t_len = mix.shape[-1]
        pad_len = ((t_len + bucket - 1) // bucket) * bucket
        audio_total += t_len / sample_rate * mix.shape[0]
        for j in range(mix.shape[0]):
            groups.setdefault(pad_len, []).append({
                "mix": mix[j], "target": batch["wav_targets"][j],
                "enroll": batch["spk_embeds"][j],
                "t_len": t_len, "utt": i + 1, "row": j,
                "key": batch["key"][j], "spk": batch["spk"][j],
            })
            if len(groups[pad_len]) == rows_per_step:
                _flush(pad_len, groups.pop(pad_len))
    for pad_len in sorted(groups):
        _flush(pad_len, groups[pad_len])
    elapsed = time.time() - start
    if total_cnt:
        logger.info("Average SI-SNR: %.3f", total_sisnr / total_cnt)
        logger.info("Average SI-SNRi: %.3f", total_sisnri / total_cnt)
        logger.info(
            "Acceptance rate (SI-SNRi > 1dB): %.3f", accept_cnt / total_cnt,
        )
    logger.info(
        "Processed %.1fs audio in %.1fs (RTF %.4f)",
        audio_total, elapsed, elapsed / max(audio_total, 1e-9),
    )
    if save_wav:
        generate_enhanced_scp(audio_dir)
    return (
        total_sisnr / max(total_cnt, 1),
        total_sisnri / max(total_cnt, 1),
    )


def main():
    args = get_args()
    infer(args.config, overrides=args.overrides)


if __name__ == "__main__":
    main()
