#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (wesep_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script exits 0 only when all
pass):

1. device: the card's name, power limit and the torch/CUDA versions;
2. build: every CUDA kernel of the serving path, from csrc/ with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the v1 pBSRNN gives it, in f32 and bf16, with its time, its
   plain version's time, cuDNN's time for the same function and the
   card's bound for the work;
4. serve: the full-width v1 pBSRNN (feature_dim 128, 6 repeats, multiply
   fuse, 256-d embeddings; random weights from a seed) decodes a small
   shard through the port's bin/infer on the card; the kernel's launch
   count must show it ran 12 times per forward, and the kernel forward
   must agree with the plain-LSTM forward of the same model.

The last lines are the card line of nvidia-smi, one JSON object describing
the kernels, and {"ok": true, "device": {...}}.
"""

import io
import json
import math
import os
import statistics
import subprocess
import sys
import tarfile
import tempfile
import time

import numpy as np
import torch

SEED = 0
D, H = 128, 256  # BSRNN feature_dim 128 -> BiLSTM input 128, hidden 256
MAIN_SHAPES = {"band": (376, 64), "comm": (32, 752)}  # (T, B') at 2 rows x 3 s
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # H100 SXM
PEAK_BYTES = 3.35e12
V1_MODEL_ARGS = dict(sr=16000, win=512, stride=128, feature_dim=128,
                     num_repeat=6, spk_fuse_type="multiply",
                     use_spk_transform=False, multi_fuse=False,
                     joint_training=False, spk_emb_dim=256)
SHARD_SECONDS = (3.0, 3.0, 3.0, 3.0, 4.37)
BUCKET = 16000
ROWS_PER_STEP = 2


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def time_ms(fn, warmup=2, runs=10):
    """Median of `runs` CUDA-event timings of fn(), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tolerance(ref):
    """Max abs error allowed against the plain version: 1e-4 in f32 (the
    sum order differs over T steps); in bf16, 4 units in the last place at
    the output's largest magnitude, since h is rounded to bf16 every step
    and a different f32 sum order may flip one rounding."""
    if ref.dtype == torch.float32:
        return 1e-4
    amax = max(ref.float().abs().max().item(), 2.0 ** -126)
    return 4 * 2.0 ** (math.floor(math.log2(amax)) - 7)  # 8-bit significand


def bilstm_bound(t_len, batch, dtype):
    """Least time of one BiLSTM layer on the card: the larger of its
    operations over the peak rate of its type and its bytes (x, weights
    and biases read once, y written once) over the memory rate."""
    size = torch.tensor([], dtype=dtype).element_size()
    flops = 2 * 2 * t_len * batch * (D + H) * 4 * H
    nbytes = (batch * t_len * D * size + 2 * (D + H) * 4 * H * size
              + 2 * 4 * H * 4 + batch * t_len * 2 * H * size)
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    by_bytes = nbytes / PEAK_BYTES * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def check_kernel(name, t_len, batch, dtype):
    """Kernel vs plain version (and cuDNN) at one main-path shape."""
    from wesep_tpu_torch.ops.cuda_lstm import (
        bilstm_layer,
        bilstm_layer_reference,
    )

    torch.manual_seed(SEED)
    lstm = torch.nn.LSTM(D, H, batch_first=True, bidirectional=True)
    lstm = lstm.cuda().to(dtype)
    lstm.flatten_parameters()
    gen = torch.Generator().manual_seed(SEED)
    x = (torch.randn(batch, t_len, D, generator=gen) * 0.2).cuda().to(dtype)

    def weights(sfx):
        p = {n: getattr(lstm, n + sfx).detach() for n in
             ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")}
        return (p["weight_ih_l0"].t().contiguous(),
                (p["bias_ih_l0"].float() + p["bias_hh_l0"].float()),
                p["weight_hh_l0"].t().contiguous())

    args = (x, *weights(""), *weights("_reverse"))
    y = bilstm_layer(*args)
    torch.cuda.synchronize()
    ref = bilstm_layer_reference(*args)
    with torch.inference_mode():
        lib = lstm(x)[0]
    err = (y.float() - ref.float()).abs().max().item()
    err_lib = (y.float() - lib.float()).abs().max().item()
    tol = tolerance(ref)
    ms = time_ms(lambda: bilstm_layer(*args))
    plain_ms = time_ms(lambda: bilstm_layer_reference(*args), 1, 5)
    with torch.inference_mode():
        library_ms = time_ms(lambda: lstm(x))
    bound_ms, bound_by = bilstm_bound(t_len, batch, dtype)
    case = {
        "shape": name, "dtype": str(dtype).replace("torch.", ""),
        "T": t_len, "B": batch, "D": D, "H": H,
        "max_abs_err": err, "tolerance": tol,
        "max_abs_err_vs_cudnn": err_lib,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    log("kernel bilstm_layer", json.dumps(case))
    if not (err <= tol and err_lib <= tol and torch.isfinite(y).all()):
        raise AssertionError(f"bilstm_layer disagrees at {case}")
    return case


def write_shard(root, rng):
    """Premixed shard of SHARD_SECONDS mixtures + 256-d embeddings +
    enrollment lists; returns the infer config entries and the lengths."""
    from wesep_tpu_torch.data.wav_io import wav_bytes
    from wesep_tpu_torch.utils.file_utils import write_vec_ark_scp

    emb_dim = V1_MODEL_ARGS["spk_emb_dim"]
    lengths = [int(round(s * 16000)) for s in SHARD_SECONDS]
    keys = [f"mix{i:02d}" for i in range(len(lengths))]
    embeds = {}
    with tarfile.open(os.path.join(root, "test.tar"), "w") as tar:
        for key, n in zip(keys, lengths):
            srcs = []
            for spk in (1, 2):
                embeds[f"{key}_enr{spk}"] = rng.standard_normal(emb_dim)
                # a few harmonic partials with noise, per speaker
                t = np.arange(n) / 16000.0
                f0 = rng.uniform(90, 250)
                s = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6))
                        / k for k in range(1, 6))
                s = 0.1 * s + 0.02 * rng.standard_normal(n)
                srcs.append(s.astype(np.float32))
            members = [(f"{key}.spk1", b"spk1"), (f"{key}.spk2", b"spk2"),
                       (f"{key}.wav", wav_bytes(srcs[0] + srcs[1], 16000)),
                       (f"{key}_spk1.wav", wav_bytes(srcs[0], 16000)),
                       (f"{key}_spk2.wav", wav_bytes(srcs[1], 16000))]
            for name, data in members:
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
    _, scp = write_vec_ark_scp(os.path.join(root, "embed"), embeds)
    with open(os.path.join(root, "test.list"), "w") as f:
        f.write(os.path.join(root, "test.tar") + "\n")
    for spk in (1, 2):
        with open(os.path.join(root, f"spk{spk}_enroll"), "w") as f:
            f.writelines(f"{k} {k}_enr{spk}\n" for k in keys)
    return dict(
        test_data=os.path.join(root, "test.list"),
        test_spk_embeds=scp,
        test_spk1_enroll=os.path.join(root, "spk1_enroll"),
        test_spk2_enroll=os.path.join(root, "spk2_enroll"),
    ), lengths


def forward_steps(lengths):
    """Forward calls bin/infer makes: rows (2 per mixture) buffered per
    length bucket, ROWS_PER_STEP at a time."""
    rows = {}
    for n in lengths:
        pad = math.ceil(n / BUCKET) * BUCKET
        rows[pad] = rows.get(pad, 0) + 2
    return sum(math.ceil(r / ROWS_PER_STEP) for r in rows.values())


def serve(root):
    """Phase 4: the v1 pBSRNN through bin/infer on the card."""
    from wesep_tpu_torch.bin.infer import infer
    from wesep_tpu_torch.data.wav_io import read_wav
    from wesep_tpu_torch.models.bsrnn import BSRNN
    from wesep_tpu_torch.models.common import LSTM
    from wesep_tpu_torch.ops.cuda_lstm import bilstm_layer
    from wesep_tpu_torch.train.checkpoint import save_checkpoint

    rng = np.random.default_rng(SEED)
    data, lengths = write_shard(root, rng)
    torch.manual_seed(SEED)
    model = BSRNN(**V1_MODEL_ARGS)
    ckpt = os.path.join(root, "avg_model.pt")
    save_checkpoint(ckpt, [model.state_dict()])
    config = {
        "model": {"tse_model": "BSRNN"},
        "model_args": {"tse_model": dict(V1_MODEL_ARGS)},
        "data_type": "shard",
        "dataset_args": {"resample_rate": 16000},
        "exp_dir": os.path.join(root, "exp"),
        "checkpoint": ckpt,
        "length_bucket": BUCKET,
        "infer_batch_size": ROWS_PER_STEP,
        "device": "cuda",
        **data,
    }

    steps = forward_steps(lengths)
    bilstm_layer.launches = 0
    t0 = time.perf_counter()
    avg_sisnr, avg_sisnri = infer(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bilstm_layer.launches
    audio_s = 2 * sum(lengths) / 16000.0
    log(f"serve: {2 * len(lengths)} requests (mixture x target) in {steps} "
        f"forward steps, {wall:.3f} s wall, RTF {wall / audio_s:.5f}, "
        f"avg SI-SNR {avg_sisnr:.3f} dB, avg SI-SNRi {avg_sisnri:.3f} dB "
        "(random weights: shows the chain ran, not quality)")
    per_forward = 2 * V1_MODEL_ARGS["num_repeat"]  # band + comm per BSNet
    log(f"serve: bilstm_layer launches {launches} (expected {per_forward} "
        f"x {steps})")
    if launches != per_forward * steps:
        raise AssertionError(f"{launches} kernel launches, expected "
                             f"{per_forward * steps}")
    if not (math.isfinite(avg_sisnr) and math.isfinite(avg_sisnri)):
        raise AssertionError("non-finite SI-SNR from infer")
    audio = os.path.join(root, "exp", "audio")
    wavs = sorted(n for n in os.listdir(audio) if n.endswith(".wav"))
    if len(wavs) != 2 * len(lengths):
        raise AssertionError(f"{len(wavs)} outputs for {2 * len(lengths)} "
                             "requests")
    for name, n in zip(wavs[::2], lengths):
        wav, _ = read_wav(os.path.join(audio, name))
        if wav.shape != (1, n) or not np.isfinite(wav).all():
            raise AssertionError(f"bad output {name}: {wav.shape}")

    # kernel forward vs plain-LSTM forward of the same model, f32
    model = model.cuda().eval()
    gen = torch.Generator().manual_seed(SEED + 1)
    mix = (torch.randn(ROWS_PER_STEP, 48000, generator=gen) * 0.1).cuda()
    emb = torch.randn(ROWS_PER_STEP, 256, generator=gen).cuda()
    lstms = [m for m in model.modules() if isinstance(m, LSTM)]
    with torch.inference_mode():
        est = model(mix, emb)[0]
        step_ms = time_ms(lambda: model(mix, emb), warmup=1, runs=5)
        for m in lstms:
            m.plain = True
        try:
            est_plain = model(mix, emb)[0]
            plain_step_ms = time_ms(lambda: model(mix, emb), 1, 3)
        finally:
            for m in lstms:
                m.plain = False
    if not torch.isfinite(est).all() or est.shape != mix.shape:
        raise AssertionError("kernel forward is not finite / wrong shape")
    rel = ((est - est_plain).norm() / est_plain.norm()).item()
    log(f"serve: forward [2 x 3 s] {step_ms:.3f} ms/step with the kernel, "
        f"{plain_step_ms:.3f} ms/step with the plain LSTM; "
        f"{2 * 3.0 / (step_ms / 1e3):.1f} audio-s/s, RTF "
        f"{step_ms / 1e3 / 6.0:.5f}; kernel vs plain rel L2 {rel:.3e} "
        "(limit 1e-3)")
    if not rel <= 1e-3:
        raise AssertionError(f"kernel forward differs from plain: {rel}")
    return launches, {
        "requests": 2 * len(lengths), "steps": steps, "wall_s": wall,
        "rtf_wall": wall / audio_s, "step_ms": step_ms,
        "plain_step_ms": plain_step_ms, "rel_l2_vs_plain": rel,
        "avg_sisnri": avg_sisnri,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 1
    from wesep_tpu_torch.ops import _build

    # numbers are compared in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(card)

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build("bilstm_layer")
    log(f"build: bilstm_layer.cu in {time.perf_counter() - t0:.2f} s")
    with open(lib + ".log") as f:
        log(f.read().strip())

    # 3. kernels against their plain versions
    cases = [check_kernel(name, t_len, batch, dtype)
             for name, (t_len, batch) in MAIN_SHAPES.items()
             for dtype in (torch.float32, torch.bfloat16)]

    # 4. serve
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        launches, served = serve(root)
    log("serve summary", json.dumps(served))

    band = cases[0]  # band RNN in f32: the shape and type bin/infer runs most
    kernels = [{
        "name": "bilstm_layer",
        "route": "cuda",
        "source": "wesep_tpu_torch/csrc/bilstm_layer.cu",
        "replaces": "wesep_tpu/ops/pallas_lstm.py:834",
        "launches": launches,
        "max_abs_err": band["max_abs_err"],
        "ms": band["ms"],
        "plain_ms": band["plain_ms"],
        "bound_ms": band["bound_ms"],
        "bound_by": band["bound_by"],
        "library_ms": band["library_ms"],
        "cases": cases,
    }]
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
