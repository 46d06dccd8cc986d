#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (wesep_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script exits 0 only when all
pass):

1. device: the card's name, power limit and the torch/CUDA versions;
2. build: every CUDA kernel of the serving and training paths, from csrc/
   with nvcc (one nvcc per source, started together), with the nvcc logs;
3. kernels: each kernel against its plain PyTorch version on the card, in
   f32 and bf16, with its time, its plain version's time, a library call's
   time for the same function and the card's bound for the work: the
   forward kernel at the serving shapes, then the forward kernel with the
   cell-state output and the two backward kernels at the training shapes;
4. serve: the full-width v1 pBSRNN (feature_dim 128, 6 repeats, multiply
   fuse, 256-d embeddings; random weights from a seed) decodes a small
   shard through the port's bin/infer on the card; the kernel's launch
   count must show it ran 12 times per forward, and the kernel forward
   must agree with the plain-LSTM forward of the same model;
5. train: the same model trains through the port's bin/train on the card,
   in bf16 at batch_size 8 (16 rows x 3 s per step), a few steps and one
   validation pass on synthetic shards; the launch counts must show 12
   forward launches per train and validation step and 12 launches of each
   backward kernel per train step; losses must be finite, the parameters
   must move, and the checkpoint must hold parameters, optimizer state and
   step and load as bin/infer loads it. Then the gradients of every
   parameter through the kernels against those through the plain LSTM
   (f32, 2 rows x 3 s), and the time and peak memory of a train step.

The last lines are the card line of nvidia-smi, one JSON object describing
the kernels, and {"ok": true, "device": {...}}.
"""

import io
import json
import math
import os
import re
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
TRAIN_SHAPES = {"band": (376, 512), "comm": (32, 6016)}  # at 16 rows x 3 s
TRAIN_BATCH = 8     # mixtures per step; the collator makes 2 rows of each
TRAIN_STEPS = 4     # epoch_iter of the training run
CHUNK = 48000       # 3 s
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


def _bound(flops, nbytes, dtype):
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    by_bytes = nbytes / PEAK_BYTES * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def backward_bounds(t_len, batch, dtype):
    """Least times of the two backward kernels on the card, and of the
    forward kernel when it also writes the cell states. Operations per
    product 2 * T * B * K * 4H for each direction; bytes: every input read
    once, every output written once (the dg scratch is an output of the
    serial kernel and an input of the weight-gradient kernel)."""
    size = torch.tensor([], dtype=dtype).element_size()
    rows, h4 = t_len * batch, 4 * H
    product = 2 * 2 * rows * (D + H) * h4  # both directions, one K = D + H
    weights = 2 * (D + H) * h4 * size + 2 * h4 * 4
    x_b, y_b, cs_b = rows * D * size, rows * 2 * H * size, rows * 2 * H * 4
    dg_b = 2 * rows * h4 * size
    forward = _bound(product, x_b + weights + y_b + cs_b, dtype)
    # recompute of the gates, then dh and dx
    serial = _bound(2 * product, x_b + 2 * weights + y_b + cs_b + y_b
                    + 2 * x_b + dg_b + (batch + 7) // 8 * 2 * h4 * 4, dtype)
    splits = max(1, min(8, -(-rows // 4096)))
    wgrad = _bound(product, x_b + y_b + dg_b
                   + splits * 2 * (D + H) * h4 * 4, dtype)
    return forward, serial, wgrad


def rel_err(got, ref):
    """Max abs error relative to the reference's largest magnitude."""
    scale = max(ref.float().abs().max().item(), 1e-12)
    return (got.float() - ref.float()).abs().max().item() / scale


def check_training_kernels(name, t_len, batch, dtype):
    """Forward with cell states and both backward kernels against their
    plain versions (and cuDNN's forward + backward) at one training shape.

    Limits, relative to the largest magnitude of the plain version's
    result: f32 1e-4 (dW sums 192,512 terms in another order; the order is
    fixed, so the result does not change from run to run); bf16 2e-2 for
    dx, dW and db (dgates and dh are rounded to bf16 at every step, and a
    sum that differs in its last bit flips such a rounding now and then),
    and the forward's rule (4 bf16 units in the last place) for ys."""
    from wesep_tpu_torch.ops import cuda_lstm as k

    torch.manual_seed(SEED)
    lstm = torch.nn.LSTM(D, H, batch_first=True, bidirectional=True)
    lstm = lstm.cuda().to(dtype)
    lstm.flatten_parameters()
    gen = torch.Generator().manual_seed(SEED)
    x = (torch.randn(batch, t_len, D, generator=gen) * 0.2).cuda().to(dtype)
    dys = (torch.randn(batch, t_len, 2 * H, generator=gen) * 0.1).cuda() \
        .to(dtype)

    def weights(sfx):
        p = {n: getattr(lstm, n + sfx).detach().float() for n in
             ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")}
        return (p["weight_ih_l0"].t().contiguous(),
                p["bias_ih_l0"] + p["bias_hh_l0"],
                p["weight_hh_l0"].t().contiguous())

    args = (x, *weights(""), *weights("_reverse"))  # f32 parameters
    limit = 1e-4 if dtype == torch.float32 else 2e-2

    # forward with the cell states
    ys, cs = k._forward_cuda(*args, with_cs=True)
    torch.cuda.synchronize()
    ref_ys, ref_cs = k.bilstm_layer_reference(*args, return_cs=True)
    err_y = (ys.float() - ref_ys.float()).abs().max().item()
    err_c = rel_err(cs, ref_cs)
    fwd_ms = time_ms(lambda: k._forward_cuda(*args, with_cs=True), 1, 5)
    fwd_plain_ms = time_ms(
        lambda: k.bilstm_layer_reference(*args, return_cs=True), 0, 2)

    # the backward kernels, from the plain forward's saved tensors so that
    # only the adjoint differs
    dx, db, dg = k.bilstm_layer_backward(*args, ref_ys, ref_cs, dys)
    dw = k.bilstm_layer_wgrad(x, ref_ys, dg)
    torch.cuda.synchronize()
    ref = k.bilstm_layer_backward_reference(*args, ref_ys, ref_cs, dys)
    ref_dw = torch.stack([torch.cat([ref[1], ref[3]]),
                          torch.cat([ref[4], ref[6]])])
    ref_db = torch.stack([ref[2], ref[5]])
    errs = {"dx": rel_err(dx, ref[0]), "db": rel_err(db, ref_db),
            "dwx": rel_err(dw[:, :D], ref_dw[:, :D]),
            "dwh": rel_err(dw[:, D:], ref_dw[:, D:])}
    wgrad_ref = k.bilstm_layer_wgrad_reference(x, ref_ys, dg)
    err_wgrad = rel_err(dw, wgrad_ref)
    bwd_ms = time_ms(
        lambda: k.bilstm_layer_backward(*args, ref_ys, ref_cs, dys), 1, 5)
    wgrad_ms = time_ms(lambda: k.bilstm_layer_wgrad(x, ref_ys, dg), 1, 5)
    bwd_plain_ms = time_ms(
        lambda: k.bilstm_layer_backward_reference(*args, ref_ys, ref_cs, dys),
        0, 2)
    wgrad_plain_ms = time_ms(
        lambda: k.bilstm_layer_wgrad_reference(x, ref_ys, dg), 1, 3)

    # library yardsticks, never called by the port: cuDNN's LSTM forward
    # and backward with the same weights, and one cuBLAS product for dW
    xg = x.clone().requires_grad_()
    lib_y = lstm(xg)[0]
    lib_params = list(lstm.parameters())
    lib_grads = torch.autograd.grad(lib_y, [xg] + lib_params, dys,
                                    retain_graph=True)
    err_lib_dx = rel_err(lib_grads[0], ref[0])
    err_lib_dwx = rel_err(lib_grads[1].t(), ref[1])
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        lib_y, [xg] + lib_params, dys, retain_graph=True), 1, 5)

    def lib_fwd_bwd():
        torch.autograd.grad(lstm(xg)[0], [xg] + lib_params, dys)

    lib_fwd_bwd_ms = time_ms(lib_fwd_bwd, 1, 5)
    with torch.inference_mode():
        lib_fwd_ms = time_ms(lambda: lstm(x), 1, 5)
    del lib_y, lib_grads
    a_mat = torch.cat([x, ref_ys[..., :H]], dim=-1).reshape(-1, D + H)
    dg0 = dg[0].reshape(-1, 4 * H)
    lib_wgrad_ms = time_ms(lambda: torch.matmul(a_mat.t(), dg0), 1, 5) * 2

    (f_ms, f_by), (s_ms, s_by), (w_ms, w_by) = backward_bounds(
        t_len, batch, dtype)
    case = {
        "shape": "train_" + name, "dtype": str(dtype).replace("torch.", ""),
        "T": t_len, "B": batch, "D": D, "H": H, "rel_limit": limit,
        "forward": {"max_abs_err": err_y, "tolerance": tolerance(ref_ys),
                    "cs_rel_err": err_c, "ms": fwd_ms,
                    "plain_ms": fwd_plain_ms, "library_ms": lib_fwd_ms,
                    "bound_ms": f_ms, "bound_by": f_by},
        "backward": {"rel_err": {n: errs[n] for n in ("dx", "db")},
                     "max_abs_err": (dx.float() - ref[0].float()).abs()
                     .max().item(),
                     "rel_err_cudnn_vs_plain": {"dx": err_lib_dx,
                                                "dwx": err_lib_dwx},
                     "ms": bwd_ms, "plain_ms": bwd_plain_ms,
                     "library_ms": lib_bwd_ms,
                     "library_fwd_bwd_ms": lib_fwd_bwd_ms,
                     "bound_ms": s_ms, "bound_by": s_by,
                     "dg_scratch_bytes": dg.numel() * dg.element_size()},
        "wgrad": {"rel_err": {"dwx": errs["dwx"], "dwh": errs["dwh"],
                              "vs_plain_product": err_wgrad},
                  "max_abs_err": (dw - wgrad_ref).abs().max().item(),
                  "ms": wgrad_ms, "plain_ms": wgrad_plain_ms,
                  "library_ms": lib_wgrad_ms,
                  "bound_ms": w_ms, "bound_by": w_by},
    }
    log("kernels at training shape", json.dumps(case))
    cs_limit = limit if dtype == torch.float32 else 5e-2
    ok = (err_y <= tolerance(ref_ys) and err_c <= cs_limit
          and all(e <= limit for e in errs.values())
          and err_wgrad <= 1e-4
          and all(torch.isfinite(t).all() for t in (ys, cs, dx, db, dw)))
    if not ok:
        raise AssertionError(f"training-shape kernels disagree: {case}")
    if dtype == torch.float32 and not (err_lib_dx <= 1e-3
                                       and err_lib_dwx <= 1e-3):
        raise AssertionError(f"plain backward disagrees with cuDNN: {case}")
    return case


def write_shard(root, rng, name, seconds):
    """Premixed shard `name`.tar of len(seconds) two-speaker mixtures, with
    its list, 256-d embeddings (scp), utt2spk and enrollment lists, as the
    recipes lay them out; returns their paths and the lengths."""
    from wesep_tpu_torch.data.wav_io import wav_bytes
    from wesep_tpu_torch.utils.file_utils import write_vec_ark_scp

    emb_dim = V1_MODEL_ARGS["spk_emb_dim"]
    lengths = [int(round(s * 16000)) for s in seconds]
    keys = [f"{name}{i:02d}" for i in range(len(lengths))]
    embeds, utt2spk = {}, {}
    tar_path = os.path.join(root, f"{name}.tar")
    with tarfile.open(tar_path, "w") as tar:
        for key, n in zip(keys, lengths):
            srcs = []
            for spk in (1, 2):
                embeds[f"{key}_enr{spk}"] = rng.standard_normal(emb_dim)
                utt2spk[f"{key}_enr{spk}"] = f"{key}_s{spk}"
                # a few harmonic partials with noise, per speaker
                t = np.arange(n) / 16000.0
                f0 = rng.uniform(90, 250)
                s = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6))
                        / k for k in range(1, 6))
                s = 0.1 * s + 0.02 * rng.standard_normal(n)
                srcs.append(s.astype(np.float32))
            members = [(f"{key}.spk1", f"{key}_s1".encode()),
                       (f"{key}.spk2", f"{key}_s2".encode()),
                       (f"{key}.wav", wav_bytes(srcs[0] + srcs[1], 16000)),
                       (f"{key}_spk1.wav", wav_bytes(srcs[0], 16000)),
                       (f"{key}_spk2.wav", wav_bytes(srcs[1], 16000))]
            for member, data in members:
                info = tarfile.TarInfo(member)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
    _, scp = write_vec_ark_scp(os.path.join(root, f"{name}_embed"), embeds)
    paths = {"data": os.path.join(root, f"{name}.list"), "spk_embeds": scp,
             "utt2spk": os.path.join(root, f"{name}.utt2spk")}
    with open(paths["data"], "w") as f:
        f.write(tar_path + "\n")
    with open(paths["utt2spk"], "w") as f:
        f.writelines(f"{u} {s}\n" for u, s in utt2spk.items())
    for spk in (1, 2):
        paths[f"spk{spk}_enroll"] = os.path.join(root, f"{name}_spk{spk}_enroll")
        with open(paths[f"spk{spk}_enroll"], "w") as f:
            f.writelines(f"{k} {k}_enr{spk}\n" for k in keys)
    return paths, lengths


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
    paths, lengths = write_shard(root, rng, "test", SHARD_SECONDS)
    data = {f"test_{k}": v for k, v in paths.items() if k != "utt2spk"}
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


def rows_loss(text):
    """The TRAIN rows' running mean losses from a train log."""
    return [float(v) for v in re.findall(
        r"\|\s+TRAIN\s+\|\s+1\s+\|\s+\d+\s+\|\s+(\S+)\s+\|", text)]


def param_grads(model, mix, emb, target):
    """Gradients of the SI-SDR loss w.r.t. every parameter, by name."""
    from wesep_tpu_torch.train.losses import si_sdr_loss

    names, params = zip(*model.named_parameters())
    loss = si_sdr_loss(model(mix, emb)[0], target).mean()
    return dict(zip(names, torch.autograd.grad(loss, params)))


def train_phase(root):
    """Phase 5: the v1 pBSRNN through bin/train on the card."""
    from wesep_tpu_torch.bin.train import train
    from wesep_tpu_torch.models.bsrnn import BSRNN
    from wesep_tpu_torch.models.common import LSTM
    from wesep_tpu_torch.ops import cuda_lstm as k
    from wesep_tpu_torch.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from wesep_tpu_torch.train.losses import parse_loss
    from wesep_tpu_torch.train.schedulers import exponential_decrease
    from wesep_tpu_torch.train.trainer import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    rng = np.random.default_rng(SEED + 2)
    tr, _ = write_shard(root, rng, "train", [4.0] * (2 * TRAIN_BATCH))
    va, _ = write_shard(root, rng, "dev", [3.5] * TRAIN_BATCH)
    torch.manual_seed(SEED)
    init = BSRNN(**V1_MODEL_ARGS)
    init_path = os.path.join(root, "init.ckpt")
    save_checkpoint(init_path, [init.state_dict()])
    # the values of examples/librimix/tse/v1/confs/bsrnn.yaml; one epoch of
    # TRAIN_STEPS batches on the synthetic shards
    config = {
        "device": "cuda", "exp_dir": os.path.join(root, "exp_train"),
        "data_type": "shard",
        "train_data": tr["data"], "train_spk_embeds": tr["spk_embeds"],
        "train_utt2spk": tr["utt2spk"],
        "val_data": va["data"], "val_spk_embeds": va["spk_embeds"],
        "val_spk1_enroll": va["spk1_enroll"],
        "val_spk2_enroll": va["spk2_enroll"],
        "dataloader_args": {"batch_size": TRAIN_BATCH, "drop_last": True,
                            "prefetch_factor": 6},
        "dataset_args": {"resample_rate": 16000,
                         "sample_num_per_epoch": TRAIN_STEPS * TRAIN_BATCH,
                         "shuffle": True,
                         "shuffle_args": {"shuffle_size": 2500},
                         "chunk_len": CHUNK, "speaker_feat": False},
        "compute_dtype": "bfloat16", "log_batch_interval": 1,
        "loss": "SISDR", "loss_args": {},
        "model": {"tse_model": "BSRNN"},
        "model_args": {"tse_model": dict(V1_MODEL_ARGS)},
        "model_init": {"tse_model": init_path},
        "num_avg": 2, "num_epochs": 1,
        "optimizer": {"tse_model": "Adam"},
        "optimizer_args": {"tse_model": {"lr": 0.001, "weight_decay": 0.0001}},
        "clip_grad": 5.0, "save_epoch_interval": 1,
        "scheduler": {"tse_model": "ExponentialDecrease"},
        "scheduler_args": {"tse_model": {
            "final_lr": 2.5e-05, "initial_lr": 0.001,
            "warm_from_zero": False, "warm_up_epoch": 0}},
        "seed": 42,
    }
    counters = (k.bilstm_layer, k.bilstm_layer_backward, k.bilstm_layer_wgrad)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    state = train(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    per_pass = 2 * V1_MODEL_ARGS["num_repeat"]  # band + comm per BSNet
    val_steps = 1  # 16 validation enrollments / 2 / batch_size 8
    expected = [per_pass * (TRAIN_STEPS + val_steps), per_pass * TRAIN_STEPS,
                per_pass * TRAIN_STEPS]
    log(f"train: {TRAIN_STEPS} steps + {val_steps} validation step through "
        f"bin/train in {wall:.3f} s wall; launches forward / backward / "
        f"wgrad {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")
    with open(os.path.join(config["exp_dir"], "train.log")) as f:
        text = f.read()
    losses = rows_loss(text)
    epoch = re.findall(r"Epoch 1 train_loss (\S+) val_loss (\S+)", text)
    log(f"train: running mean loss per step {losses}, epoch {epoch}")
    if len(losses) != TRAIN_STEPS or len(epoch) != 1 or not all(
            math.isfinite(v) for v in losses + [float(e) for e in epoch[0]]):
        raise AssertionError("missing or non-finite training losses")
    if state.step != TRAIN_STEPS:
        raise AssertionError(f"{state.step} updates, expected {TRAIN_STEPS}")
    moved = {n: (p.detach().cpu() - init.state_dict()[n]).abs().max().item()
             for n, p in state.model.named_parameters()}
    if not all(v > 0 for v in moved.values()):
        raise AssertionError("parameters that did not change: "
                             f"{[n for n, v in moved.items() if v == 0]}")
    models = os.path.join(config["exp_dir"], "models")
    bundle = load_checkpoint(os.path.join(models, "checkpoint_1.ckpt"))
    if not (bundle["step"] == TRAIN_STEPS
            and bundle["opt_states"][0]["count"] == TRAIN_STEPS
            and set(bundle["opt_states"][0]["mu"]) == set(moved)
            and os.path.islink(os.path.join(models, "final_checkpoint.ckpt"))):
        raise AssertionError("checkpoint_1.ckpt lacks optimizer state or step")
    served = BSRNN(**V1_MODEL_ARGS)  # as bin/infer loads it
    served.load_state_dict(bundle["models"][0])
    for n, p in served.named_parameters():
        if not torch.equal(p.detach(), state.model.state_dict()[n].cpu()):
            raise AssertionError(f"checkpoint differs from the model at {n}")
    del state

    # gradients through the kernels against gradients through the plain
    # LSTM: f32, 2 rows x 3 s, relative L2 per parameter (limit 1e-3: the
    # two paths differ only in the order of f32 sums)
    gen = torch.Generator().manual_seed(SEED + 3)
    model = BSRNN(**V1_MODEL_ARGS)
    model.load_state_dict(init.state_dict())
    model = model.cuda().train()
    mix = (torch.randn(2, CHUNK, generator=gen) * 0.1).cuda()
    target = (torch.randn(2, CHUNK, generator=gen) * 0.1).cuda()
    emb = torch.randn(2, 256, generator=gen).cuda()
    lstms = [m for m in model.modules() if isinstance(m, LSTM)]
    got = param_grads(model, mix, emb, target)
    for m in lstms:
        m.plain = True
    want = param_grads(model, mix, emb, target)
    for m in lstms:
        m.plain = False
    rel = {n: ((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-20))
           .item() for n in want}
    worst = max(rel, key=rel.get)
    log(f"train: gradients of {len(rel)} parameters, kernels vs plain LSTM "
        f"(f32): worst relative L2 {rel[worst]:.3e} at {worst} (limit 1e-3)")
    if not rel[worst] <= 1e-3:
        raise AssertionError(f"gradients differ: {worst} {rel[worst]}")
    del got, want

    # time and peak memory of one train step at the recipe's size
    rows = 2 * TRAIN_BATCH
    batch = {
        "wav_mix": (torch.randn(rows, CHUNK, generator=gen) * 0.1).cuda(),
        "wav_targets": (torch.randn(rows, CHUNK, generator=gen) * 0.1).cuda(),
        "spk_embeds": torch.randn(rows, 256, generator=gen).cuda(),
    }
    opt = make_optimizer(model, exponential_decrease(
        num_epochs=1, epoch_iter=100, initial_lr=1e-3, final_lr=2.5e-5,
        warm_up_epoch=0), weight_decay=1e-4, clip_grad=5.0)
    tstate = TrainState(model=model, optimizer=opt)
    step = make_train_step(parse_loss("SISDR"),
                           compute_dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(tstate, batch), warmup=1, runs=5)
    peak = torch.cuda.max_memory_allocated()
    for m in lstms:
        m.plain = True
    plain_step_ms = time_ms(lambda: step(tstate, batch), warmup=0, runs=1)
    for m in lstms:
        m.plain = False
    audio = rows * CHUNK / 16000.0
    log(f"train: step [16 rows x 3 s, bf16] {step_ms:.3f} ms with the "
        f"kernels, {plain_step_ms:.3f} ms with the plain LSTM; "
        f"{audio / (step_ms / 1e3):.1f} audio-s/s; peak memory "
        f"{peak / 2 ** 30:.2f} GiB")
    return dict(zip(("bilstm_layer", "bilstm_layer_backward",
                     "bilstm_layer_wgrad"), launches)), {
        "steps": TRAIN_STEPS, "val_steps": val_steps, "wall_s": wall,
        "running_mean_loss": losses, "step_ms": step_ms,
        "plain_step_ms": plain_step_ms,
        "audio_s_per_s": audio / (step_ms / 1e3),
        "peak_memory_bytes": peak, "grad_rel_l2_worst": rel[worst],
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

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {', '.join(n + '.cu' for n in libs)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for lib in libs.values():
        with open(lib + ".log") as f:
            log(f.read().strip())

    # 3. kernels against their plain versions
    cases = [check_kernel(name, t_len, batch, dtype)
             for name, (t_len, batch) in MAIN_SHAPES.items()
             for dtype in (torch.float32, torch.bfloat16)]
    train_cases = [check_training_kernels(name, t_len, batch, dtype)
                   for name, (t_len, batch) in TRAIN_SHAPES.items()
                   for dtype in (torch.float32, torch.bfloat16)]

    # 4. serve
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        serve_launches, served = serve(root)
    log("serve summary", json.dumps(served))

    # 5. train
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        train_launches, trained = train_phase(root)
    log("train summary", json.dumps(trained))

    # the headline case of each kernel: the band RNN, the shape that takes
    # most of its path's time, in the dtype that path runs (serving f32,
    # training bf16)
    band = cases[0]
    train_band = train_cases[1]
    sources = {"bilstm_layer": "wesep_tpu_torch/csrc/bilstm_layer.cu",
               "bilstm_layer_backward":
                   "wesep_tpu_torch/csrc/bilstm_layer_bwd.cu",
               "bilstm_layer_wgrad":
                   "wesep_tpu_torch/csrc/bilstm_layer_bwd.cu"}
    replaces = {"bilstm_layer": "wesep_tpu/ops/pallas_lstm.py:834",
                "bilstm_layer_backward": "wesep_tpu/ops/pallas_lstm.py:932",
                "bilstm_layer_wgrad": "wesep_tpu/ops/pallas_lstm.py:932"}
    headline = {"bilstm_layer": band,
                "bilstm_layer_backward": train_band["backward"],
                "bilstm_layer_wgrad": train_band["wgrad"]}
    kernels = []
    for name, head in headline.items():
        entry = {"name": name, "route": "cuda", "source": sources[name],
                 "replaces": replaces[name],
                 "launches": train_launches[name]}
        entry.update({key: head[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")})
        if name == "bilstm_layer":
            entry["launches_by_path"] = {"serve": serve_launches,
                                         "train": train_launches[name]}
            entry["cases"] = cases + [
                dict(c["forward"], shape=c["shape"], dtype=c["dtype"],
                     T=c["T"], B=c["B"]) for c in train_cases]
        else:
            part = "backward" if name == "bilstm_layer_backward" else "wgrad"
            entry["cases"] = [
                dict(c[part], shape=c["shape"], dtype=c["dtype"], T=c["T"],
                     B=c["B"], rel_limit=c["rel_limit"])
                for c in train_cases]
        kernels.append(entry)
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
