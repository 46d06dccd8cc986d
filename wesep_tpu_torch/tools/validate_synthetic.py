"""Self-contained synthetic-recipe validation: build data, train, infer.

Counterpart of wesep_tpu/tools/validate_synthetic.py, with the same corpus
byte for byte and the same configs key for key, plus the device. It
generates a synthetic TSE corpus ("speakers" = distinct spectral
envelopes), writes a complete shard recipe and config, runs the port's
bin/train (or bin/train_gan) and bin/infer, and reports SI-SNRi: an end to
end check of the whole stack (data plane -> training -> checkpointing ->
infer) that needs no external corpora. `FLOORS` holds the convergence
floors of the JAX package's battery (tests/test_quality_floors.py), one row
a model family, each at `SMALL`.

It runs on the card unless `--device cpu` is given.

    python -m wesep_tpu_torch.tools.validate_synthetic --work_dir /tmp/v \
        --num_epochs 4 [--model BSRNN] [--device cpu]
"""

import argparse
import io
import json
import os
import tarfile

import numpy as np
import yaml

# the battery's size: tests/test_quality_floors.py's _SMALL
SMALL = dict(chunk_len=8000, utts_per_spk=8, batch_size=8)
# (name, run() arguments, SI-SNRi floor in dB): the parametrize rows of
# tests/test_quality_floors.py::test_synthetic_convergence_floor
FLOORS = (
    ("bsrnn", dict(model="BSRNN", num_epochs=3), 8.5),
    ("dpccn", dict(model="DPCCN", num_epochs=3), 7.3),
    ("spexplus", dict(model="ConvTasNet", num_epochs=16), 3.4),
    ("tfgridnet", dict(model="TFGridNet", num_epochs=10), 6.1),
    ("online_mix", dict(num_epochs=5, online_mix=True), 5.6),
    ("gan", dict(model="BSRNN", num_epochs=4, gan=True), 10.8),
)


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--work_dir", required=True)
    parser.add_argument("--model", default="BSRNN")
    parser.add_argument("--num_spk", type=int, default=8)
    parser.add_argument("--utts_per_spk", type=int, default=12)
    parser.add_argument("--num_epochs", type=int, default=4)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--feature_dim", type=int, default=32)
    parser.add_argument("--num_repeat", type=int, default=2)
    parser.add_argument("--chunk_len", type=int, default=32000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--gan", action="store_true",
        help="train via the MetricGAN path (bin.train_gan: CMGAN "
        "discriminator + on-device P.862 targets) instead of plain "
        "bin.train: the GAN-path convergence row of the battery",
    )
    parser.add_argument(
        "--online_mix", action="store_true",
        help="validate the online-mix path: single-speaker training "
        "shards, joint speaker encoder on raw enrollment wavs, mixtures "
        "simulated on the device inside the train step (voxceleb-recipe "
        "architecture)",
    )
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def model_args_for(args):
    """Small pre-extracted-embedding configs per flagship family (the
    same contract as the recipe confs, scaled for a quick synthetic
    convergence run)."""
    name = args.model
    if name.startswith("BSRNN"):
        return {
            "sr": 16000, "win": 512, "stride": 128,
            "feature_dim": args.feature_dim,
            "num_repeat": args.num_repeat,
            "spk_fuse_type": "multiply", "use_spk_transform": False,
            "multi_fuse": False, "joint_training": False,
            "spk_emb_dim": 32,
        }
    if name == "DPCCN":
        return {
            "win": 512, "stride": 128, "spk_emb_dim": 32,
            "spk_fuse_type": "multiply", "use_spk_transform": False,
            "tcn_layers": 1, "joint_training": False,
        }
    if name == "TFGridNet":
        return {
            "n_layers": 2, "lstm_hidden_units": 48, "emb_dim": 16,
            "attn_n_head": 2, "attn_approx_qk_dim": 128,
            "emb_ks": 4, "emb_hs": 1, "spk_emb_dim": 32,
            "spk_fuse_type": "multiply", "joint_training": False,
        }
    if name == "ConvTasNet":  # SpEx+ family, single-scale decoder
        return {
            "L": 20, "N": 128, "X": 6, "R": 2, "B": 128, "H": 256,
            "P": 3, "norm": "gLN", "causal": False, "skip_con": False,
            "spk_emb_dim": 32, "spk_fuse_type": "concatConv",
            "encoder_type": "Multi", "decoder_type": "Single",
            "joint_training": False,
        }
    raise ValueError(f"no synthetic-validation config for {name}")


def synth_utt(rng, spk_freqs, t=48000, sr=16000):
    """Amplitude-modulated multi-tone 'speech' with a speaker-specific
    spectral envelope."""
    ts = np.arange(t) / sr
    sig = np.zeros(t)
    for f, a in spk_freqs:
        am = 0.5 + 0.5 * np.sin(
            2 * np.pi * rng.uniform(1.5, 6.0) * ts + rng.uniform(0, 6.28)
        )
        sig += a * am * np.sin(2 * np.pi * f * ts + rng.uniform(0, 6.28))
    sig += 0.01 * rng.standard_normal(t)
    return (sig / (np.abs(sig).max() + 1e-9) * 0.5).astype(np.float32)


def _make_spk_freqs(args, rng):
    spks = [f"spk{i:02d}" for i in range(args.num_spk)]
    return spks, {
        s: [(float(rng.uniform(150, 3500)), float(rng.uniform(0.4, 1.0)))
            for _ in range(4)]
        for s in spks
    }


def _add(tar, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def make_premixed_split(root, name, n_utts, seed, spks, spk_freqs):
    from wesep_tpu_torch.data.wav_io import wav_bytes

    srng = np.random.default_rng(seed)
    path = os.path.join(root, f"{name}.tar")
    keys = {}
    with tarfile.open(path, "w") as tar:
        for u in range(n_utts):
            i, j = srng.choice(len(spks), 2, replace=False)
            s1 = synth_utt(srng, spk_freqs[spks[i]])
            s2 = synth_utt(srng, spk_freqs[spks[j]])
            key = f"{name}{u:03d}"
            keys[key] = (spks[i], spks[j])
            _add(tar, f"{key}.spk1", spks[i].encode())
            _add(tar, f"{key}.spk2", spks[j].encode())
            _add(tar, f"{key}.wav", wav_bytes(s1 + s2, 16000))
            _add(tar, f"{key}_spk1.wav", wav_bytes(s1, 16000))
            _add(tar, f"{key}_spk2.wav", wav_bytes(s2, 16000))
    with open(os.path.join(root, f"{name}.list"), "w") as f:
        f.write(path + "\n")
    for idx in (1, 2):
        with open(os.path.join(root, f"{name}.spk{idx}_enroll"),
                  "w") as f:
            for key, (a, b) in keys.items():
                f.write(f"{key} utt_{a if idx == 1 else b}\n")
    return keys


def build_corpus(args):
    from wesep_tpu_torch.utils.file_utils import write_vec_ark_scp

    rng = np.random.default_rng(args.seed)
    root = args.work_dir
    os.makedirs(root, exist_ok=True)
    spks, spk_freqs = _make_spk_freqs(args, rng)
    # embeddings: one-hot-ish per speaker
    embeds = {
        f"utt_{s}": (np.eye(args.num_spk, 32)[i] + 0.01).astype(np.float32)
        for i, s in enumerate(spks)
    }
    _, scp = write_vec_ark_scp(os.path.join(root, "embed"), embeds)
    with open(os.path.join(root, "single.utt2spk"), "w") as f:
        for s in spks:
            f.write(f"utt_{s} {s}\n")

    n_train = args.num_spk * args.utts_per_spk
    make_premixed_split(root, "train", n_train, args.seed + 1, spks,
                        spk_freqs)
    make_premixed_split(root, "dev", max(n_train // 8, 2), args.seed + 2,
                        spks, spk_freqs)
    make_premixed_split(root, "test", max(n_train // 8, 2), args.seed + 3,
                        spks, spk_freqs)
    return scp, n_train


def build_corpus_online(args):
    """Single-speaker training shards + raw-wav enrollments: the
    voxceleb-recipe (online-mix) data layout over the same synthetic
    speakers; dev/test stay premixed like the reference recipe."""
    from wesep_tpu_torch.data.wav_io import wav_bytes, write_wav

    rng = np.random.default_rng(args.seed)
    root = args.work_dir
    os.makedirs(root, exist_ok=True)
    spks, spk_freqs = _make_spk_freqs(args, rng)

    enroll_dir = os.path.join(root, "enroll")
    os.makedirs(enroll_dir, exist_ok=True)
    spk2enroll = {}
    with open(os.path.join(root, "enroll_wav.scp"), "w") as f:
        for s in spks:
            p = os.path.join(enroll_dir, f"{s}.wav")
            write_wav(p, synth_utt(rng, spk_freqs[s]), 16000)
            spk2enroll[s] = [[f"utt_{s}", p]]
            f.write(f"utt_{s} {p}\n")
    with open(os.path.join(root, "spk2enroll.json"), "w") as f:
        json.dump(spk2enroll, f)

    tar_path = os.path.join(root, "train.tar")
    with tarfile.open(tar_path, "w") as tar, open(
        os.path.join(root, "utt2spk"), "w"
    ) as u2s:
        for s in spks:
            for u in range(args.utts_per_spk):
                key = f"{s}_{u:02d}"
                _add(tar, f"{key}.spk", s.encode())
                _add(tar, f"{key}.wav",
                     wav_bytes(synth_utt(rng, spk_freqs[s]), 16000))
                u2s.write(f"{key} {s}\n")
    with open(os.path.join(root, "train.list"), "w") as f:
        f.write(tar_path + "\n")

    n_train = args.num_spk * args.utts_per_spk
    make_premixed_split(root, "dev", max(n_train // 8, 2), args.seed + 2,
                        spks, spk_freqs)
    make_premixed_split(root, "test", max(n_train // 8, 2), args.seed + 3,
                        spks, spk_freqs)
    return n_train


def run(work_dir, model="BSRNN", num_epochs=4, online_mix=False,
        device=None, **kw):
    """Programmatic entry -> SI-SNRi (dB). Same defaults as the CLI;
    `device` is cuda unless given (cpu runs the plain versions)."""
    args = argparse.Namespace(
        work_dir=work_dir, model=model, num_spk=8, utts_per_spk=12,
        num_epochs=num_epochs, batch_size=8, feature_dim=32,
        num_repeat=2, chunk_len=32000, seed=0, online_mix=online_mix,
        gan=False, device=device,
    )
    for k, v in kw.items():
        setattr(args, k, v)
    return _run(args)


def main():
    return _run(get_args())


def _schedule():
    """The optimizer and scheduler keys both configs share."""
    return {
        "model_init": {"tse_model": None},
        "optimizer": {"tse_model": "Adam"},
        "optimizer_args": {"tse_model": {"lr": 1e-3,
                                         "weight_decay": 1e-4}},
        "scheduler": {"tse_model": "ExponentialDecrease"},
        "scheduler_args": {"tse_model": {
            "initial_lr": 1e-3, "final_lr": 2e-4,
            "warm_up_epoch": 0, "warm_from_zero": False,
        }},
    }


def _common(args, root, n_train):
    """The run keys both configs share, the device included."""
    return {
        "exp_dir": os.path.join(root, "exp"),
        "data_type": "shard",
        "train_data": os.path.join(root, "train.list"),
        "val_data": os.path.join(root, "dev.list"),
        "val_spk1_enroll": os.path.join(root, "dev.spk1_enroll"),
        "val_spk2_enroll": os.path.join(root, "dev.spk2_enroll"),
        "seed": 17,
        "num_epochs": args.num_epochs,
        "num_avg": 1,
        "save_epoch_interval": 1,
        "log_batch_interval": 5,
        "clip_grad": 5.0,
        "compute_dtype": "bfloat16",
        "loss": "SISDR",
        "loss_args": {},
        "dataloader_args": {"batch_size": args.batch_size,
                            "prefetch_factor": 2},
        "dataset_args": {
            "resample_rate": 16000,
            "shuffle": True,
            "shuffle_args": {"shuffle_size": 64},
            "chunk_len": args.chunk_len,
            "sample_num_per_epoch": n_train,
        },
        "device": getattr(args, "device", None) or "cuda",
    }


def _infer(cfg_path, root, **cues):
    from wesep_tpu_torch.bin.infer import infer

    print("== inference ==")
    sisnr, sisnri = infer(
        cfg_path,
        checkpoint=os.path.join(root, "exp/models/final_checkpoint.ckpt"),
        test_data=os.path.join(root, "test.list"),
        test_spk1_enroll=os.path.join(root, "test.spk1_enroll"),
        test_spk2_enroll=os.path.join(root, "test.spk2_enroll"),
        length_bucket=16000,
        **cues,
    )
    print(json.dumps({"SI-SNR": round(sisnr, 2),
                      "SI-SNRi": round(sisnri, 2)}))
    return sisnri


def _write_config(root, config):
    cfg_path = os.path.join(root, "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.dump(config, f)
    return cfg_path


def _run(args):
    root = args.work_dir
    if args.online_mix:
        return main_online(args)
    scp, n_train = build_corpus(args)
    config = _common(args, root, n_train)
    config.update({
        "train_spk_embeds": scp,
        "train_utt2spk": os.path.join(root, "single.utt2spk"),
        "val_spk_embeds": scp,
        "model": {"tse_model": args.model},
        "model_args": {"tse_model": model_args_for(args)},
    })
    config.update(_schedule())
    if getattr(args, "gan", False):
        config["model"]["discriminator"] = "CMGAN_Discriminator"
        config["model_args"]["discriminator"] = {"hid_chans": 8}
        config["gan_loss_weight"] = 0.05
        config["gan_metric"] = "pesq"
    cfg_path = _write_config(root, config)

    if getattr(args, "gan", False):
        from wesep_tpu_torch.bin.train_gan import train_gan

        print(f"== GAN-training {args.model} for {args.num_epochs} epochs ==")
        train_gan(cfg_path)
    else:
        from wesep_tpu_torch.bin.train import train

        print(f"== training {args.model} for {args.num_epochs} epochs ==")
        train(cfg_path)
    return _infer(cfg_path, root, test_spk_embeds=scp)


def main_online(args):
    """Online-mix validation: train with the mixtures simulated on the
    device inside the train step (they never exist on the host) and a
    jointly trained speaker encoder, then decode the premixed test split."""
    root = args.work_dir
    n_train = build_corpus_online(args)
    config = _common(args, root, n_train)
    config.update({
        "train_utt2spk": os.path.join(root, "utt2spk"),
        "train_spk2utt": os.path.join(root, "spk2enroll.json"),
        "val_spk2utt": os.path.join(root, "enroll_wav.scp"),
        "model": {"tse_model": "BSRNN"},
        "model_args": {"tse_model": {
            "sr": 16000, "win": 512, "stride": 128,
            "feature_dim": args.feature_dim,
            "num_repeat": args.num_repeat,
            "spk_fuse_type": "multiply", "use_spk_transform": False,
            "multi_fuse": False, "joint_training": True,
            "spk_model": "ResNet18",
            "spk_args": {"feat_dim": 80, "embed_dim": 32,
                         "pooling_func": "TSTP", "two_emb_layer": False},
            "spk_emb_dim": 32, "spk_feat": False,
            "feat_type": "consistent",
            "spksInTrain": args.num_spk,
        }},
    })
    config["dataset_args"].update({
        "online_mix": True,
        "device_augment": True,
        "num_speakers": 2,
        "online_buffer_size": 64,
        "use_random_snr": True,
        "reverb_prob": 0.0,
        "noise_prob": 0.0,
        "speaker_feat": False,
        "enroll_sec": 3,
    })
    config.update(_schedule())
    cfg_path = _write_config(root, config)

    from wesep_tpu_torch.bin.train import train

    print(f"== training online-mix BSRNN for {args.num_epochs} epochs ==")
    train(cfg_path)
    return _infer(cfg_path, root,
                  test_spk2utt=os.path.join(root, "enroll_wav.scp"))


if __name__ == "__main__":
    main()
