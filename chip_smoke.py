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
   time for the same function (where one exists) and the card's bound for
   the work: the BiLSTM forward kernel at the serving shapes, the forward
   kernel with the cell-state output and the two backward kernels at the
   training shapes; then the fused TCN block, forward and backward, at
   SpEx+'s serving shape (2 rows) and training shape (16 rows) at
   dilations 1 and 128, and one speaker-fused block through its module;
   then the unfold-fused BiLSTM layer (forward, serial adjoint, weight
   gradients, with cuDNN's LSTM over the materialised frames as yardstick)
   at TF-GridNet's intra and inter RNN shapes for serving (2 rows x 3 s)
   and training (8 rows x 1 s), in f32 and bf16, and once at hs 2, with
   the weight gradients repeated bit for bit; and the plain layer's
   kernels at TF-GridNet's materialised shapes (D = H = 192);
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
   (f32, 2 rows x 3 s), and the time and peak memory of a train step;
6. serve SpEx+: the full-width ConvTasNet of
   examples/librimix/tse/v2/confs/spexplus.yaml (random weights from a
   seed) decodes a small shard with 6 s enrollment wavs through bin/infer:
   32 launches of the fused block per forward, kernel forward against the
   plain blocks' forward;
7. train SpEx+: the same model trains through bin/train with the recipe's
   loss table ([SISDR, CE] over the three scales and the speaker logits),
   bf16, batch_size 8 (16 rows x 3 s), a few steps and one validation
   step: 32 forward and 32 backward launches per train step, 32 forward
   per validation step; finite losses, parameters and BatchNorm statistics
   that moved, a checkpoint that bin/infer decodes from, whole-model
   gradients through the kernels against those through the plain blocks,
   and the time and peak memory of a train step;
8. serve TF-GridNet: the full-width model of
   examples/librimix/tse/v1/confs/tfgridnet.yaml (random weights from a
   seed) decodes a small shard through bin/infer twice, with
   WESEP_LSTM_UNFOLD=1 (12 launches of the unfold-fused kernel per
   forward, none of the plain layer's) and without it (12 of the plain
   layer's, none of the unfold-fused); on each route the kernels' forward
   against the plain versions' forward, and the step time;
9. train TF-GridNet: the same model trains through bin/train with
   WESEP_LSTM_UNFOLD=1, bf16, batch_size 4 (8 rows x 1 s), a few steps
   and one validation step: 12 forward launches per train and validation
   step and 12 of each backward kernel per train step; finite losses,
   parameters that moved, a checkpoint that bin/infer decodes from,
   whole-model gradients through the kernels against those through the
   plain versions, and the time and peak memory of a train step on both
   routes.

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
# SpEx+ (examples/librimix/tse/v2/confs/spexplus.yaml) at full width
SPEX_MODEL_ARGS = dict(N=256, L=20, B=256, H=512, P=3, X=8, R=4,
                       spk_emb_dim=256, norm="gLN", causal=False,
                       skip_con=False, spk_fuse_type="concatConv",
                       multi_fuse=True, encoder_type="Multi",
                       decoder_type="Multi", joint_training=True,
                       multi_task=True, spks_in_train=251)
SPEX_BLOCKS = SPEX_MODEL_ARGS["R"] * SPEX_MODEL_ARGS["X"]  # fused blocks
SPEX_T = (CHUNK - 20) // 10 + 1  # 4799 encoder frames of a 3 s chunk
SPEX_TRAIN_STEPS = 3
ENROLL_SECONDS = 6.0
TCN_C, TCN_H, TCN_K = 256, 512, 3
BUCKET = 16000
ROWS_PER_STEP = 2

# TF-GridNet (examples/librimix/tse/v1/confs/tfgridnet.yaml) at full width
GRID_MODEL_ARGS = dict(n_srcs=1, sr=16000, n_fft=128, stride=64,
                       n_layers=6, lstm_hidden_units=192, attn_n_head=4,
                       attn_approx_qk_dim=512, emb_dim=48, emb_ks=4,
                       emb_hs=1, spk_emb_dim=256, spk_fuse_type="multiply",
                       joint_training=False)
GRID_C, GRID_H, GRID_KS = 48, 192, 4
GRID_RNNS = 2 * GRID_MODEL_ARGS["n_layers"]  # intra + inter per block
GRID_BATCH = 4         # the conf's batch_size: 8 rows of 1 s per step
GRID_CHUNK = 16000
GRID_TRAIN_STEPS = 4
# parameters whose true gradient is zero, so that two correct versions
# return rounding noise: the keys' norm bias adds one logit to every key of
# a query, which the softmax cancels; the real part of the deconv bias is a
# constant spectrum, an impulse at the first sample of each frame, where
# the periodic Hann window is 0
GRID_NOISE_ONLY = ("attn_norm_K_bias", "deconv.bias")


def grid_rnn_shapes(rows, samples):
    """(B', L) of the intra (frequency) and inter (time) RNNs of a
    TF-GridNet block for `rows` rows of `samples` samples: the frames and
    the 65 bins, each padded by 2 * (emb_ks - emb_hs) (hs 1)."""
    olp = GRID_KS - GRID_MODEL_ARGS["emb_hs"]
    t_pad = samples // GRID_MODEL_ARGS["stride"] + 1 + 2 * olp
    q_pad = GRID_MODEL_ARGS["n_fft"] // 2 + 1 + 2 * olp
    return {"intra": (rows * t_pad, q_pad), "inter": (rows * q_pad, t_pad)}


# the unfold-fused layer at TF-GridNet's shapes: serving 2 rows x 3 s and
# training 8 rows x 1 s
UNFOLD_SHAPES = {
    f"{path}_{rnn}": shape
    for path, rows, samples in (("serve", ROWS_PER_STEP, CHUNK),
                                ("train", 2 * GRID_BATCH, GRID_CHUNK))
    for rnn, shape in grid_rnn_shapes(rows, samples).items()}


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


def bilstm_bound(t_len, batch, dtype, d=D, h=H, x_elems=None):
    """Least time of one BiLSTM layer on the card: the larger of its
    operations over the peak rate of its type and its bytes (x, weights
    and biases read once, y written once) over the memory rate. d is the
    length of a step's input row, `x_elems` as in backward_bounds."""
    size = torch.tensor([], dtype=dtype).element_size()
    flops = 2 * 2 * t_len * batch * (d + h) * 4 * h
    x_elems = batch * t_len * d if x_elems is None else x_elems
    nbytes = (x_elems * size + 2 * (d + h) * 4 * h * size
              + 2 * 4 * h * 4 + batch * t_len * 2 * h * size)
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    by_bytes = nbytes / PEAK_BYTES * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def check_kernel(name, t_len, batch, dtype, d=D, h=H):
    """Kernel vs plain version (and cuDNN) at one main-path shape."""
    from wesep_tpu_torch.ops.cuda_lstm import (
        bilstm_layer,
        bilstm_layer_reference,
    )

    torch.manual_seed(SEED)
    lstm = torch.nn.LSTM(d, h, batch_first=True, bidirectional=True)
    lstm = lstm.cuda().to(dtype)
    lstm.flatten_parameters()
    gen = torch.Generator().manual_seed(SEED)
    x = (torch.randn(batch, t_len, d, generator=gen) * 0.2).cuda().to(dtype)

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
    bound_ms, bound_by = bilstm_bound(t_len, batch, dtype, d, h)
    case = {
        "shape": name, "dtype": str(dtype).replace("torch.", ""),
        "T": t_len, "B": batch, "D": d, "H": h,
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


def backward_bounds(t_len, batch, dtype, d=D, h=H, x_elems=None):
    """Least times of the two backward kernels on the card, and of the
    forward kernel when it also writes the cell states. Operations per
    product 2 * T * B * K * 4H for each direction; bytes: every input read
    once, every output written once (the dg scratch is an output of the
    serial kernel and an input of the weight-gradient kernel). d is the
    length of a step's input row; `x_elems`, where given, the elements of
    the stream the rows are read from (the unfold-fused layer reads its
    frames from a raw stream of B * L * C elements)."""
    size = torch.tensor([], dtype=dtype).element_size()
    rows, h4 = t_len * batch, 4 * h
    product = 2 * 2 * rows * (d + h) * h4  # both directions, one K = d + h
    weights = 2 * (d + h) * h4 * size + 2 * h4 * 4
    x_b = (rows * d if x_elems is None else x_elems) * size
    y_b, cs_b = rows * 2 * h * size, rows * 2 * h * 4
    dg_b = 2 * rows * h4 * size
    forward = _bound(product, x_b + weights + y_b + cs_b, dtype)
    # recompute of the gates, then dh and dx
    serial = _bound(2 * product, x_b + 2 * weights + y_b + cs_b + y_b
                    + 2 * rows * d * size + dg_b
                    + (batch + 7) // 8 * 2 * h4 * 4, dtype)
    splits = max(1, min(8, -(-rows // 4096)))
    wgrad = _bound(product, x_b + y_b + dg_b
                   + splits * 2 * (d + h) * h4 * 4, dtype)
    return forward, serial, wgrad


def rel_err(got, ref):
    """Max abs error relative to the reference's largest magnitude."""
    scale = max(ref.float().abs().max().item(), 1e-12)
    return (got.float() - ref.float()).abs().max().item() / scale


def check_training_kernels(name, t_len, batch, dtype, d=D, h=H):
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
    lstm = torch.nn.LSTM(d, h, batch_first=True, bidirectional=True)
    lstm = lstm.cuda().to(dtype)
    lstm.flatten_parameters()
    gen = torch.Generator().manual_seed(SEED)
    x = (torch.randn(batch, t_len, d, generator=gen) * 0.2).cuda().to(dtype)
    dys = (torch.randn(batch, t_len, 2 * h, generator=gen) * 0.1).cuda() \
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
            "dwx": rel_err(dw[:, :d], ref_dw[:, :d]),
            "dwh": rel_err(dw[:, d:], ref_dw[:, d:])}
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
    a_mat = torch.cat([x, ref_ys[..., :h]], dim=-1).reshape(-1, d + h)
    dg0 = dg[0].reshape(-1, 4 * h)
    lib_wgrad_ms = time_ms(lambda: torch.matmul(a_mat.t(), dg0), 1, 5) * 2

    (f_ms, f_by), (s_ms, s_by), (w_ms, w_by) = backward_bounds(
        t_len, batch, dtype, d, h)
    case = {
        "shape": "train_" + name, "dtype": str(dtype).replace("torch.", ""),
        "T": t_len, "B": batch, "D": d, "H": h, "rel_limit": limit,
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


TCN_GRADS = ("dx", "db1_eff", "dw1", "dp0", "dkd", "dbd", "dg0w", "dg0b",
             "dp1", "dw2", "db2", "dg1w", "dg1b")


def tcn_args(batch, dtype, seed=SEED):
    """Seeded inputs of one fused block at SpEx+'s widths: the thirteen
    arguments (x in `dtype`, f32 parameters) and a cotangent dy."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
    u = lambda n: torch.rand(n, generator=gen) + 0.5  # noqa: E731
    c, h, k = TCN_C, TCN_H, TCN_K
    args = [r(batch, SPEX_T, c) * 0.5, r(batch, h) * 0.1, r(c, h) * 0.06,
            torch.tensor([0.25]), r(k, h) * 0.3, r(h) * 0.1, u(h),
            r(h) * 0.2, torch.tensor([0.2]), r(h, c) * 0.04, r(c) * 0.1,
            u(h), r(h) * 0.2]
    args = [a.cuda() for a in args]
    args[0] = args[0].to(dtype)
    return args, (r(batch, SPEX_T, c) * 0.1).cuda().to(dtype)


def tcn_bounds(batch, dtype):
    """Least times of the fused block on the card, forward and backward:
    the operations the JAX package counts for it (forward 4 B T C H +
    2 B T H k; backward, the model's count, 8 B T C H + 4 B T H k) and the
    bytes of every input read once and every output written once (x, the
    parameters, y; x, dy, the parameters, dx and the f32 gradients)."""
    size = torch.tensor([], dtype=dtype).element_size()
    c, h, k = TCN_C, TCN_H, TCN_K
    rows = batch * SPEX_T
    stream = rows * c * size
    params = (2 * c * h + k * h) * size + (batch * h + 5 * h + c + 2) * 4
    forward = _bound(4 * rows * c * h + 2 * rows * h * k,
                     2 * stream + params + batch * 16, dtype)
    grads = (2 * c * h + k * h + batch * h + 5 * h + c + 2) * 4
    backward = _bound(8 * rows * c * h + 4 * rows * h * k,
                      3 * stream + params + batch * 16 + grads, dtype)
    return forward, backward


def rel_l2(got, ref):
    return ((got.float() - ref.float()).norm()
            / ref.float().norm().clamp_min(1e-20)).item()


def tcn_limits(dtype):
    """Limits of the fused block against its plain version.

    y: f32 1e-4 of the largest magnitude (the products and the gLN sums
    run in another order); bf16 4 units in the last place at the largest
    magnitude (q is rounded to bf16, and a sum that differs in its last
    bit flips such a rounding). Gradients: among tens of millions of PReLU
    inputs a few lie within an f32 rounding of zero, where kernel and
    plain version take different branches; one such flip moves one element
    of dv or ds by (1 - slope) of its size, which no sum order can avoid.
    So a gradient is held to a relative L2 error of 2e-3 (f32) or 2e-2
    (bf16: dv, ds and dn0 are rounded) and to a largest error of 5e-2 of
    its largest magnitude."""
    if dtype == torch.float32:
        return {"y": 1e-4, "grad_l2": 2e-3, "grad_max": 5e-2}
    return {"y": None, "grad_l2": 2e-2, "grad_max": 5e-2}


def check_tcn(name, batch, dtype, dilation):
    """K4 and K4b against their plain versions at one SpEx+ shape."""
    from wesep_tpu_torch.ops import cuda_tcn as k

    args, dy = tcn_args(batch, dtype)
    conf = (dilation, TCN_K, False, 1e-5)
    limits = tcn_limits(dtype)
    y, stats = k._forward_cuda(*args, *conf)
    torch.cuda.synchronize()
    ref_y, ref_stats = k.tcn_block_gln_reference(*args, *conf,
                                                 return_stats=True)
    err_y = (y.float() - ref_y.float()).abs().max().item()
    tol_y = tolerance(ref_y) if limits["y"] is None else \
        limits["y"] * ref_y.float().abs().max().item()
    err_stats = rel_err(stats, ref_stats)
    # the backward from the plain forward's statistics, so that only the
    # adjoint differs
    grads = k.tcn_block_gln_backward(*args, ref_stats, dy, *conf)
    torch.cuda.synchronize()
    again = k.tcn_block_gln_backward(*args, ref_stats, dy, *conf)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip(grads, again))
    ref = k.tcn_block_gln_backward_reference(*args, ref_stats, dy, *conf)
    l2 = {n: rel_l2(g, w) for n, g, w in zip(TCN_GRADS, grads, ref)}
    mx = {n: rel_err(g, w) for n, g, w in zip(TCN_GRADS, grads, ref)}
    err_dx = (grads[0].float() - ref[0].float()).abs().max().item()
    del again, ref

    fwd_ms = time_ms(lambda: k._forward_cuda(*args, *conf), 2, 10)
    bwd_ms = time_ms(
        lambda: k.tcn_block_gln_backward(*args, ref_stats, dy, *conf), 2, 10)
    fwd_plain_ms = time_ms(
        lambda: k.tcn_block_gln_reference(*args, *conf), 1, 5)
    bwd_plain_ms = time_ms(lambda: k.tcn_block_gln_backward_reference(
        *args, ref_stats, dy, *conf), 1, 5)
    (f_ms, f_by), (b_ms, b_by) = tcn_bounds(batch, dtype)
    case = {
        "shape": name, "dtype": str(dtype).replace("torch.", ""),
        "B": batch, "T": SPEX_T, "C": TCN_C, "H": TCN_H, "k": TCN_K,
        "dilation": dilation, "limits": limits,
        "forward": {"max_abs_err": err_y, "tolerance": tol_y,
                    "stats_rel_err": err_stats, "ms": fwd_ms,
                    "plain_ms": fwd_plain_ms, "library_ms": None,
                    "bound_ms": f_ms, "bound_by": f_by},
        "backward": {"max_abs_err": err_dx, "rel_l2": l2, "rel_max": mx,
                     "same_bits_twice": same_bits, "ms": bwd_ms,
                     "plain_ms": bwd_plain_ms, "library_ms": None,
                     "bound_ms": b_ms, "bound_by": b_by},
    }
    log("kernel tcn_block_gln", json.dumps(case))
    ok = (err_y <= tol_y and err_stats <= 1e-4 and same_bits
          and all(v <= limits["grad_l2"] for v in l2.values())
          and all(v <= limits["grad_max"] for v in mx.values())
          and all(torch.isfinite(t).all() for t in (y, *grads)))
    if not ok:
        raise AssertionError(f"tcn_block_gln disagrees at {case}")
    return case


def check_fused_tcn_block(dtype):
    """One speaker-fused block through its module (the embedding folded
    into the per-sample bias): y and the gradients of x, the embedding and
    every parameter, kernels against the plain version of the same
    module."""
    from wesep_tpu_torch.models.convtasnet import FuseTCNBlock

    torch.manual_seed(SEED)
    block = FuseTCNBlock(TCN_C, 256, TCN_H, TCN_K, dilation=1,
                         norm="gLN").cuda()
    gen = torch.Generator().manual_seed(SEED + 4)
    x = (torch.randn(2, SPEX_T, TCN_C, generator=gen) * 0.5).cuda() \
        .to(dtype).requires_grad_()
    emb = torch.randn(2, 256, generator=gen).cuda().to(dtype).requires_grad_()
    dy = (torch.randn(2, SPEX_T, TCN_C, generator=gen) * 0.1).cuda().to(dtype)
    names, params = zip(*block.named_parameters())

    def run():
        y = block(x, emb)
        return y, torch.autograd.grad(y, (x, emb) + params, dy)

    y, grads = run()
    block.plain = True
    try:
        ref_y, ref = run()
    finally:
        block.plain = False
    limits = tcn_limits(dtype)
    err_y = (y.float() - ref_y.float()).abs().max().item()
    tol_y = tolerance(ref_y) if limits["y"] is None else \
        limits["y"] * ref_y.float().abs().max().item()
    l2 = {n: rel_l2(g, w)
          for n, g, w in zip(("x", "embed") + names, grads, ref)}
    case = {"shape": "fused_block", "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err_y, "tolerance": tol_y, "grad_rel_l2": l2}
    log("kernel tcn_block_gln through FuseTCNBlock", json.dumps(case))
    if not (err_y <= tol_y
            and all(v <= limits["grad_l2"] for v in l2.values())):
        raise AssertionError(f"fused TCN block disagrees: {case}")
    return case


def write_enrollments(root, rng, name, paths, keys):
    """6 s enrollment wavs for the shard `name` (one per mixture and
    target), with the utt -> wav scp, spk2enroll.json and a single.utt2spk,
    as the v2 recipe lays them out."""
    from wesep_tpu_torch.data.wav_io import write_wav

    n = int(ENROLL_SECONDS * 16000)
    os.makedirs(os.path.join(root, f"{name}_enroll"), exist_ok=True)
    spk2enroll, utt2wav = {}, {}
    for key in keys:
        for spk in (1, 2):
            utt = f"{key}_enr{spk}"
            t = np.arange(n) / 16000.0
            f0 = rng.uniform(90, 250)
            wav = 0.1 * sum(np.sin(2 * np.pi * f0 * h * t) / h
                            for h in range(1, 6))
            wav = wav + 0.02 * rng.standard_normal(n)
            path = os.path.join(root, f"{name}_enroll", utt + ".wav")
            write_wav(path, wav.astype(np.float32), 16000)
            utt2wav[utt] = path
            spk2enroll[f"{key}_s{spk}"] = [[utt, path]]
    paths["spk2utt"] = os.path.join(root, f"{name}_enroll_wav.scp")
    with open(paths["spk2utt"], "w") as f:
        f.writelines(f"{u} {p}\n" for u, p in utt2wav.items())
    paths["spk2enroll"] = os.path.join(root, f"{name}_spk2enroll.json")
    with open(paths["spk2enroll"], "w") as f:
        json.dump(spk2enroll, f)
    return paths


def spex_shard(root, rng, name, seconds):
    paths, lengths = write_shard(root, rng, name, seconds)
    keys = [f"{name}{i:02d}" for i in range(len(lengths))]
    return write_enrollments(root, rng, name, paths, keys), lengths


def tcn_blocks(model):
    from wesep_tpu_torch.models.convtasnet import FuseTCNBlock, TCNBlock

    return [m for m in model.modules()
            if isinstance(m, (TCNBlock, FuseTCNBlock))]


def set_plain(blocks, plain):
    for m in blocks:
        m.plain = plain


def serve_spex(root):
    """Phase 6: SpEx+ through bin/infer on the card."""
    from wesep_tpu_torch.bin.infer import infer
    from wesep_tpu_torch.data.wav_io import read_wav
    from wesep_tpu_torch.models.convtasnet import ConvTasNet
    from wesep_tpu_torch.ops.cuda_tcn import tcn_block_gln
    from wesep_tpu_torch.train.checkpoint import save_checkpoint, split_state

    rng = np.random.default_rng(SEED + 5)
    paths, lengths = spex_shard(root, rng, "spextest", SHARD_SECONDS)
    torch.manual_seed(SEED)
    model = ConvTasNet(**SPEX_MODEL_ARGS)
    ckpt = os.path.join(root, "spex_avg_model.pt")
    params, buffers = split_state(model)
    save_checkpoint(ckpt, [params], batch_stats=[buffers])
    config = {
        "model": {"tse_model": "ConvTasNet"},
        "model_args": {"tse_model": dict(SPEX_MODEL_ARGS)},
        "data_type": "shard",
        "dataset_args": {"resample_rate": 16000, "speaker_feat": False,
                         "enroll_sec": ENROLL_SECONDS},
        "exp_dir": os.path.join(root, "exp_spex"),
        "checkpoint": ckpt, "length_bucket": BUCKET,
        "infer_batch_size": ROWS_PER_STEP, "device": "cuda",
        "test_data": paths["data"], "test_spk2utt": paths["spk2utt"],
        "test_spk1_enroll": paths["spk1_enroll"],
        "test_spk2_enroll": paths["spk2_enroll"],
    }
    steps = forward_steps(lengths)
    tcn_block_gln.launches = 0
    t0 = time.perf_counter()
    avg_sisnr, avg_sisnri = infer(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tcn_block_gln.launches
    audio_s = 2 * sum(lengths) / 16000.0
    log(f"serve SpEx+: {2 * len(lengths)} requests in {steps} forward steps, "
        f"{wall:.3f} s wall, RTF {wall / audio_s:.5f}, avg SI-SNR "
        f"{avg_sisnr:.3f} dB, avg SI-SNRi {avg_sisnri:.3f} dB (random "
        "weights: shows the chain ran, not quality)")
    log(f"serve SpEx+: tcn_block_gln launches {launches} (expected "
        f"{SPEX_BLOCKS} x {steps})")
    if launches != SPEX_BLOCKS * steps:
        raise AssertionError(f"{launches} kernel launches, expected "
                             f"{SPEX_BLOCKS * steps}")
    if not (math.isfinite(avg_sisnr) and math.isfinite(avg_sisnri)):
        raise AssertionError("non-finite SI-SNR from infer")
    audio = os.path.join(root, "exp_spex", "audio")
    wavs = sorted(n for n in os.listdir(audio) if n.endswith(".wav"))
    if len(wavs) != 2 * len(lengths):
        raise AssertionError(f"{len(wavs)} outputs for {2 * len(lengths)} "
                             "requests")
    for name, n in zip(wavs[::2], lengths):
        wav, _ = read_wav(os.path.join(audio, name))
        if wav.shape != (1, n) or not np.isfinite(wav).all():
            raise AssertionError(f"bad output {name}: {wav.shape}")

    # kernel forward against the plain blocks' forward of the same model
    model = model.cuda().eval()
    gen = torch.Generator().manual_seed(SEED + 6)
    mix = (torch.randn(ROWS_PER_STEP, CHUNK, generator=gen) * 0.1).cuda()
    enr = (torch.randn(ROWS_PER_STEP, int(ENROLL_SECONDS * 16000),
                       generator=gen) * 0.1).cuda()
    blocks = tcn_blocks(model)
    with torch.inference_mode():
        before = tcn_block_gln.launches
        ests = model(mix, enr)[0]
        per_forward = tcn_block_gln.launches - before
        step_ms = time_ms(lambda: model(mix, enr), warmup=1, runs=5)
        set_plain(blocks, True)
        try:
            ests_plain = model(mix, enr)[0]
            plain_step_ms = time_ms(lambda: model(mix, enr), 1, 3)
        finally:
            set_plain(blocks, False)
    if per_forward != SPEX_BLOCKS or len(blocks) != SPEX_BLOCKS:
        raise AssertionError(f"{per_forward} launches in one forward of "
                             f"{len(blocks)} blocks, expected {SPEX_BLOCKS}")
    if len(ests) != 3 or any(e.shape != mix.shape
                             or not torch.isfinite(e).all() for e in ests):
        raise AssertionError("kernel forward is not finite / wrong shape")
    rel = max(rel_l2(a, b) for a, b in zip(ests, ests_plain))
    log(f"serve SpEx+: forward [2 x 3 s] {step_ms:.3f} ms/step with the "
        f"kernel, {plain_step_ms:.3f} ms/step with the plain blocks; "
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


def spex_param_grads(model, batch, criterion, table):
    """Gradients of the recipe's loss w.r.t. every parameter, by name."""
    from wesep_tpu_torch.train.trainer import weighted_loss

    names, params = zip(*model.named_parameters())
    loss = weighted_loss(
        model(batch["wav_mix"], batch["spk_embeds"]), batch["wav_targets"],
        batch["spk_label"], criterion, table["loss_posi"],
        table["loss_weight"], multi_task=True)
    return dict(zip(names, torch.autograd.grad(loss, params)))


def train_spex(root):
    """Phase 7: SpEx+ through bin/train on the card."""
    from wesep_tpu_torch.bin.infer import infer
    from wesep_tpu_torch.bin.train import train
    from wesep_tpu_torch.models.convtasnet import ConvTasNet
    from wesep_tpu_torch.ops import cuda_tcn as k
    from wesep_tpu_torch.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
        split_state,
    )
    from wesep_tpu_torch.train.losses import parse_loss
    from wesep_tpu_torch.train.schedulers import exponential_decrease
    from wesep_tpu_torch.train.trainer import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    rng = np.random.default_rng(SEED + 7)
    tr, _ = spex_shard(root, rng, "spextrain", [4.0] * (2 * TRAIN_BATCH))
    va, va_lengths = spex_shard(root, rng, "spexdev", [3.5] * TRAIN_BATCH)
    torch.manual_seed(SEED)
    init = ConvTasNet(**SPEX_MODEL_ARGS)
    init_state = {n: v.clone() for n, v in init.state_dict().items()}
    init_path = os.path.join(root, "spex_init.ckpt")
    params, buffers = split_state(init)
    save_checkpoint(init_path, [params], batch_stats=[buffers])
    table = {"loss_posi": [[0, 1, 2], [3]],
             "loss_weight": [[0.8, 0.1, 0.1], [0.5]]}
    # the values of examples/librimix/tse/v2/confs/spexplus.yaml; one epoch
    # of SPEX_TRAIN_STEPS batches on the synthetic shards
    config = {
        "device": "cuda", "exp_dir": os.path.join(root, "exp_spex_train"),
        "data_type": "shard",
        "train_data": tr["data"], "train_utt2spk": tr["utt2spk"],
        "train_spk2utt": tr["spk2enroll"],
        "val_data": va["data"], "val_spk2utt": va["spk2utt"],
        "val_spk1_enroll": va["spk1_enroll"],
        "val_spk2_enroll": va["spk2_enroll"],
        "dataloader_args": {"batch_size": TRAIN_BATCH, "drop_last": True,
                            "prefetch_factor": 6},
        "dataset_args": {"resample_rate": 16000,
                         "sample_num_per_epoch":
                             SPEX_TRAIN_STEPS * TRAIN_BATCH,
                         "shuffle": True,
                         "shuffle_args": {"shuffle_size": 2500},
                         "chunk_len": CHUNK, "speaker_feat": False,
                         "enroll_sec": ENROLL_SECONDS},
        "compute_dtype": "bfloat16", "log_batch_interval": 1,
        "loss": ["SISDR", "CE"], "loss_args": table,
        "model": {"tse_model": "ConvTasNet"},
        "model_args": {"tse_model": dict(SPEX_MODEL_ARGS)},
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
    counters = (k.tcn_block_gln, k.tcn_block_gln_backward)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    state = train(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    val_steps = 1  # 16 validation enrollments / 2 / batch_size 8
    expected = [SPEX_BLOCKS * (SPEX_TRAIN_STEPS + val_steps),
                SPEX_BLOCKS * SPEX_TRAIN_STEPS]
    log(f"train SpEx+: {SPEX_TRAIN_STEPS} steps + {val_steps} validation "
        f"step through bin/train in {wall:.3f} s wall; launches forward / "
        f"backward {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")
    with open(os.path.join(config["exp_dir"], "train.log")) as f:
        text = f.read()
    losses = rows_loss(text)
    epoch = re.findall(r"Epoch 1 train_loss (\S+) val_loss (\S+)", text)
    log(f"train SpEx+: running mean loss per step {losses}, epoch {epoch}")
    if len(losses) != SPEX_TRAIN_STEPS or len(epoch) != 1 or not all(
            math.isfinite(v) for v in losses + [float(e) for e in epoch[0]]):
        raise AssertionError("missing or non-finite training losses")
    if state.step != SPEX_TRAIN_STEPS:
        raise AssertionError(f"{state.step} updates, expected "
                             f"{SPEX_TRAIN_STEPS}")
    moved = {n: (v.detach().cpu().float() - init_state[n]).abs().max().item()
             for n, v in state.model.state_dict().items()}
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(
            "parameters or BatchNorm statistics that did not change: "
            f"{[n for n, v in moved.items() if v == 0]}")
    n_stats = len(dict(state.model.named_buffers()))
    models = os.path.join(config["exp_dir"], "models")
    ckpt = os.path.join(models, "checkpoint_1.ckpt")
    bundle = load_checkpoint(ckpt)
    if not (bundle["step"] == SPEX_TRAIN_STEPS
            and bundle["opt_states"][0]["count"] == SPEX_TRAIN_STEPS
            and len(bundle["batch_stats"][0]) == n_stats == 12):
        raise AssertionError("checkpoint_1.ckpt lacks optimizer state, step "
                             "or BatchNorm statistics")
    del state
    # bin/infer decodes from the checkpoint bin/train wrote
    sisnr, _ = infer({
        "model": config["model"], "model_args": config["model_args"],
        "data_type": "shard", "dataset_args": config["dataset_args"],
        "exp_dir": os.path.join(root, "exp_spex_ckpt"), "checkpoint": ckpt,
        "save_wav": False, "device": "cuda", "length_bucket": BUCKET,
        "test_data": va["data"], "test_spk2utt": va["spk2utt"],
        "test_spk1_enroll": va["spk1_enroll"],
        "test_spk2_enroll": va["spk2_enroll"]})
    if not math.isfinite(sisnr):
        raise AssertionError("bin/infer from the trained checkpoint: "
                             "non-finite SI-SNR")
    log(f"train SpEx+: bin/infer decoded {2 * len(va_lengths)} requests from "
        f"checkpoint_1.ckpt, avg SI-SNR {sisnr:.3f} dB")

    # gradients through the kernels against gradients through the plain
    # blocks: f32, 2 rows x 3 s, relative L2 per parameter (limit 5e-3:
    # the sums run in another order, and a PReLU input within rounding of
    # zero may take the other branch, see tcn_limits; through 32 blocks
    # and over only 2 x 4799 rows one such flip weighs more in a depthwise
    # tap's gradient than in the single block's check). The three decoder
    # biases are left out: they shift an estimate by a constant, which the
    # zero-mean SI-SDR does not see, so their gradient is rounding noise.
    criterion = parse_loss(["SISDR", "CE"])
    gen = torch.Generator().manual_seed(SEED + 8)
    model = ConvTasNet(**SPEX_MODEL_ARGS)
    model.load_state_dict(init_state)
    model = model.cuda().train()
    blocks = tcn_blocks(model)

    def make_batch(rows):
        return {
            "wav_mix": (torch.randn(rows, CHUNK, generator=gen) * 0.1).cuda(),
            "wav_targets":
                (torch.randn(rows, CHUNK, generator=gen) * 0.1).cuda(),
            "spk_embeds": (torch.randn(
                rows, int(ENROLL_SECONDS * 16000), generator=gen) * 0.1)
            .cuda(),
            "spk_label": torch.randint(0, 251, (rows,), generator=gen).cuda(),
        }

    small = make_batch(2)
    got = spex_param_grads(model, small, criterion, table)
    set_plain(blocks, True)
    want = spex_param_grads(model, small, criterion, table)
    set_plain(blocks, False)
    # A PReLU slope's gradient is one number, sum(dw * min(v, 0)) over
    # millions of terms that nearly cancel (the gLN adjoint makes dw
    # orthogonal to 1 and to the normalised w), 1e-5 of the whole
    # gradient's norm here: its own size is no scale for its error, so
    # the slopes are held to 1e-5 of the whole gradient's norm instead.
    skipped = re.compile(r"dec_\d\.ConvTranspose_0\.bias")
    total = torch.cat([g.flatten() for g in want.values()]).norm().item()
    rel = {n: rel_l2(got[n], want[n]) for n in want
           if not skipped.fullmatch(n) and not n.endswith(".alpha")}
    slopes = {n: (got[n] - want[n]).norm().item() / total for n in want
              if n.endswith(".alpha")}
    worst = max(rel, key=rel.get)
    worst_slope = max(slopes, key=slopes.get)
    log(f"train SpEx+: gradients of {len(rel)} parameters, kernels vs plain "
        f"blocks (f32): worst relative L2 {rel[worst]:.3e} at {worst} "
        f"(limit 5e-3); {len(slopes)} PReLU slopes: worst error "
        f"{slopes[worst_slope]:.3e} of the whole gradient's norm at "
        f"{worst_slope} (limit 1e-5)")
    if not (rel[worst] <= 5e-3 and slopes[worst_slope] <= 1e-5):
        raise AssertionError(
            f"gradients differ: {worst} {rel[worst]}, {worst_slope} "
            f"{slopes[worst_slope]}")
    del got, want

    # time and peak memory of one train step at the recipe's size
    rows = 2 * TRAIN_BATCH
    batch = make_batch(rows)
    opt = make_optimizer(model, exponential_decrease(
        num_epochs=1, epoch_iter=100, initial_lr=1e-3, final_lr=2.5e-5,
        warm_up_epoch=0), weight_decay=1e-4, clip_grad=5.0)
    tstate = TrainState(model=model, optimizer=opt)
    step = make_train_step(criterion, table["loss_posi"],
                           table["loss_weight"], multi_task=True,
                           compute_dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(tstate, batch), warmup=1, runs=5)
    peak = torch.cuda.max_memory_allocated()
    set_plain(blocks, True)
    torch.cuda.reset_peak_memory_stats()
    plain_step_ms = time_ms(lambda: step(tstate, batch), warmup=1, runs=2)
    plain_peak = torch.cuda.max_memory_allocated()
    set_plain(blocks, False)
    audio = rows * CHUNK / 16000.0
    log(f"train SpEx+: step [16 rows x 3 s, bf16] {step_ms:.3f} ms with the "
        f"kernels (peak memory {peak / 2 ** 30:.2f} GiB), "
        f"{plain_step_ms:.3f} ms with the plain blocks (peak "
        f"{plain_peak / 2 ** 30:.2f} GiB); "
        f"{audio / (step_ms / 1e3):.1f} audio-s/s")
    return dict(zip(("tcn_block_gln", "tcn_block_gln_backward"), launches)), {
        "steps": SPEX_TRAIN_STEPS, "val_steps": val_steps, "wall_s": wall,
        "running_mean_loss": losses, "step_ms": step_ms,
        "plain_step_ms": plain_step_ms,
        "audio_s_per_s": audio / (step_ms / 1e3),
        "peak_memory_bytes": peak, "plain_peak_memory_bytes": plain_peak,
        "grad_rel_l2_worst": rel[worst],
        "slope_grad_err_worst": slopes[worst_slope],
    }


def grid_weights(d, gen):
    """Seeded f32 weights of one TF-GridNet BiLSTM layer in the kernels'
    order (wx_f, b_f, wh_f, wx_b, b_b, wh_b), torch LSTM-scale."""
    h, scale = GRID_H, 1.0 / math.sqrt(GRID_H)

    def u(*shape):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).cuda()

    return (u(d, 4 * h), u(4 * h), u(h, 4 * h),
            u(d, 4 * h), u(4 * h), u(h, 4 * h))


def cudnn_lstm(weights, dtype):
    """cuDNN's bidirectional LSTM holding the kernels' weights (the time
    yardstick; the port never calls it)."""
    wx = weights[0]
    lstm = torch.nn.LSTM(wx.shape[0], GRID_H, batch_first=True,
                         bidirectional=True).cuda()
    with torch.no_grad():
        for sfx, (w_x, b, w_h) in (("", weights[:3]),
                                   ("_reverse", weights[3:])):
            getattr(lstm, "weight_ih_l0" + sfx).copy_(w_x.t())
            getattr(lstm, "weight_hh_l0" + sfx).copy_(w_h.t())
            getattr(lstm, "bias_ih_l0" + sfx).copy_(b)
            getattr(lstm, "bias_hh_l0" + sfx).zero_()
    lstm = lstm.to(dtype)
    lstm.flatten_parameters()
    return lstm


def check_unfold_kernels(name, rows, length, dtype, ks=GRID_KS, hs=1):
    """The unfold-fused BiLSTM layer (K3 forward, K3b's two backward
    kernels) against its plain versions at one TF-GridNet shape: x [B', L,
    48], H 192, unfold(ks, hs), f32 parameters.

    Limits as for the plain layer: ys within 1e-4 (f32) or 4 bf16 units in
    the last place; dx, dW and db within 1e-4 (f32) or 2e-2 (bf16) of the
    plain version's largest magnitude (dgates and dh are rounded to bf16
    every step and each direction's frame cotangent before the two are
    added and folded, and a sum that differs in its last bit flips such a
    rounding now and then); the weight-gradient kernel within 1e-4 of the
    plain product on the same dgates. The weight and bias gradients must
    repeat bit for bit. The yardstick is cuDNN's LSTM with the same
    weights over the materialised frames (checked against the plain
    version in f32)."""
    from wesep_tpu_torch.ops import cuda_lstm_unfold as k

    h, d = GRID_H, ks * GRID_C
    frames = (length - ks) // hs + 1
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(rows, length, GRID_C, generator=gen).cuda().to(dtype)
    weights = grid_weights(d, gen)
    dys = (torch.randn(rows, frames, 2 * h, generator=gen) * 0.1).cuda() \
        .to(dtype)
    args = (x, *weights)
    limit = 1e-4 if dtype == torch.float32 else 2e-2

    # the serving forward (no cell states), then the training forward
    y = k.bilstm_layer_unfold(*args, ks, hs)
    ys, cs = k._forward_cuda(*args, ks, hs, with_cs=True)
    torch.cuda.synchronize()
    ref_ys, ref_cs = k.bilstm_layer_unfold_reference(*args, ks, hs,
                                                     return_cs=True)
    tol = tolerance(ref_ys)
    err_y = (y.float() - ref_ys.float()).abs().max().item()
    err_y_train = (ys.float() - ref_ys.float()).abs().max().item()
    err_c = rel_err(cs, ref_cs)
    lstm = cudnn_lstm(weights, dtype)
    u = k.unfold_frames(x, ks, hs).contiguous()
    with torch.inference_mode():
        err_lib = rel_err(lstm(u)[0], ref_ys)
    ms = time_ms(lambda: k.bilstm_layer_unfold(*args, ks, hs))
    fwd_cs_ms = time_ms(lambda: k._forward_cuda(*args, ks, hs, with_cs=True),
                        1, 5)
    plain_ms = time_ms(lambda: k.bilstm_layer_unfold_reference(*args, ks, hs),
                       1, 2)
    with torch.inference_mode():
        library_ms = time_ms(lambda: lstm(u), 1, 5)

    # the backward kernels, from the plain forward's saved tensors so that
    # only the adjoint differs
    du, db, dg = k.bilstm_layer_unfold_backward(*args, ref_ys, ref_cs, dys,
                                                ks, hs)
    dw = k.bilstm_layer_unfold_wgrad(x, ref_ys, dg, ks, hs)
    dx = k.fold_frames(du, ks, hs, length)
    torch.cuda.synchronize()
    ref = k.bilstm_layer_unfold_backward_reference(*args, ref_ys, ref_cs, dys,
                                                   ks, hs)
    ref_dw = torch.stack([torch.cat([ref[1], ref[3]]),
                          torch.cat([ref[4], ref[6]])])
    ref_db = torch.stack([ref[2], ref[5]])
    errs = {"dx": rel_err(dx, ref[0]), "db": rel_err(db, ref_db),
            "dwx": rel_err(dw[:, :d], ref_dw[:, :d]),
            "dwh": rel_err(dw[:, d:], ref_dw[:, d:])}
    err_wgrad = rel_err(dw, k.bilstm_layer_unfold_wgrad_reference(
        x, ref_ys, dg, ks, hs))
    du2, db2, dg2 = k.bilstm_layer_unfold_backward(*args, ref_ys, ref_cs,
                                                   dys, ks, hs)
    repeats = (torch.equal(du, du2) and torch.equal(db, db2)
               and torch.equal(dw, k.bilstm_layer_unfold_wgrad(
                   x, ref_ys, dg2, ks, hs)))
    del du2, db2, dg2
    bwd_ms = time_ms(lambda: k.bilstm_layer_unfold_backward(
        *args, ref_ys, ref_cs, dys, ks, hs), 1, 5)
    wgrad_ms = time_ms(lambda: k.bilstm_layer_unfold_wgrad(
        x, ref_ys, dg, ks, hs), 1, 5)
    bwd_plain_ms = time_ms(lambda: k.bilstm_layer_unfold_backward_reference(
        *args, ref_ys, ref_cs, dys, ks, hs), 0, 1)
    wgrad_plain_ms = time_ms(lambda: k.bilstm_layer_unfold_wgrad_reference(
        x, ref_ys, dg, ks, hs), 1, 3)
    # cuDNN's backward over the materialised frames: the backward call, and
    # forward + backward
    ug = u.clone().requires_grad_()
    lib_params = list(lstm.parameters())
    lib_y = lstm(ug)[0]
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        lib_y, [ug] + lib_params, dys, retain_graph=True), 1, 5)
    lib_fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(
        lstm(ug)[0], [ug] + lib_params, dys), 1, 5)
    del lib_y
    # and one cuBLAS product per direction for dW over the materialised
    # frames
    a_mat = torch.cat([u, ref_ys[..., :h]], dim=-1).reshape(-1, d + h)
    dg0 = dg[0].reshape(-1, 4 * h)
    lib_wgrad_ms = time_ms(lambda: torch.matmul(a_mat.t(), dg0), 1, 5) * 2
    del a_mat

    x_elems = rows * length * GRID_C
    bound = bilstm_bound(frames, rows, dtype, d, h, x_elems=x_elems)
    (f_ms, f_by), (s_ms, s_by), (w_ms, w_by) = backward_bounds(
        frames, rows, dtype, d, h, x_elems=x_elems)
    case = {
        "shape": name, "dtype": str(dtype).replace("torch.", ""),
        "B": rows, "L": length, "C": GRID_C, "ks": ks, "hs": hs,
        "T": frames, "H": h, "rel_limit": limit,
        "forward": {"max_abs_err": err_y, "tolerance": tol,
                    "max_abs_err_with_cs": err_y_train, "cs_rel_err": err_c,
                    "rel_err_cudnn_vs_plain": err_lib, "ms": ms,
                    "with_cs_ms": fwd_cs_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "bound_ms": bound[0],
                    "bound_by": bound[1], "with_cs_bound_ms": f_ms},
        "backward": {"rel_err": {n: errs[n] for n in ("dx", "db")},
                     "max_abs_err": (dx.float() - ref[0].float()).abs()
                     .max().item(),
                     "ms": bwd_ms, "plain_ms": bwd_plain_ms,
                     "library_ms": lib_bwd_ms,
                     "library_fwd_bwd_ms": lib_fwd_bwd_ms,
                     "bound_ms": s_ms, "bound_by": s_by,
                     "repeats_bit_for_bit": repeats},
        "wgrad": {"rel_err": {"dwx": errs["dwx"], "dwh": errs["dwh"],
                              "vs_plain_product": err_wgrad},
                  "max_abs_err": (dw - ref_dw).abs().max().item(),
                  "ms": wgrad_ms, "plain_ms": wgrad_plain_ms,
                  "library_ms": lib_wgrad_ms, "bound_ms": w_ms,
                  "bound_by": w_by},
    }
    log("kernels unfold-fused", json.dumps(case))
    cs_limit = limit if dtype == torch.float32 else 5e-2
    ok = (err_y <= tol and err_y_train <= tol and err_c <= cs_limit
          and all(e <= limit for e in errs.values()) and err_wgrad <= 1e-4
          and repeats
          and all(torch.isfinite(t).all() for t in (y, ys, cs, dx, db, dw)))
    if dtype == torch.float32:
        ok = ok and err_lib <= 1e-4
    if not ok:
        raise AssertionError(f"unfold-fused kernels disagree: {case}")
    return case


def grid_lstms(model):
    from wesep_tpu_torch.models.common import LSTM

    return [m for m in model.modules() if isinstance(m, LSTM)]


def set_route(unfold):
    """The JAX package's switch: WESEP_LSTM_UNFOLD=1 takes the unfold-fused
    layer (K3/K3b), anything else unfold + the plain layer (K0/K0b)."""
    if unfold:
        os.environ["WESEP_LSTM_UNFOLD"] = "1"
    else:
        os.environ.pop("WESEP_LSTM_UNFOLD", None)


def lstm_counters():
    """Every BiLSTM wrapper's counter: K0, K0b x2, K3, K3b x2."""
    from wesep_tpu_torch.ops import cuda_lstm as k0
    from wesep_tpu_torch.ops import cuda_lstm_unfold as k3

    return {"bilstm_layer": k0.bilstm_layer,
            "bilstm_layer_backward": k0.bilstm_layer_backward,
            "bilstm_layer_wgrad": k0.bilstm_layer_wgrad,
            "bilstm_layer_unfold": k3.bilstm_layer_unfold,
            "bilstm_layer_unfold_backward": k3.bilstm_layer_unfold_backward,
            "bilstm_layer_unfold_wgrad": k3.bilstm_layer_unfold_wgrad}


def zero_counts():
    for fn in lstm_counters().values():
        fn.launches = 0


def read_counts():
    return {n: fn.launches for n, fn in lstm_counters().items()}


def expect_counts(got, forward, backward, unfold, what):
    """Launch counts of a run: `forward` forward launches and `backward`
    launches of each backward kernel on the route taken, none on the
    other."""
    on, off = ("bilstm_layer_unfold", "bilstm_layer") if unfold \
        else ("bilstm_layer", "bilstm_layer_unfold")
    want = {on: forward, on + "_backward": backward, on + "_wgrad": backward,
            off: 0, off + "_backward": 0, off + "_wgrad": 0}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def serve_tfgridnet(root):
    """Phase 8: TF-GridNet through bin/infer on the card, on both routes."""
    from wesep_tpu_torch.bin.infer import infer
    from wesep_tpu_torch.data.wav_io import read_wav
    from wesep_tpu_torch.models.tfgridnet import TFGridNet
    from wesep_tpu_torch.train.checkpoint import save_checkpoint

    rng = np.random.default_rng(SEED + 9)
    paths, lengths = write_shard(root, rng, "gridtest", SHARD_SECONDS)
    data = {f"test_{k}": v for k, v in paths.items() if k != "utt2spk"}
    torch.manual_seed(SEED)
    model = TFGridNet(**GRID_MODEL_ARGS)
    ckpt = os.path.join(root, "grid_avg_model.pt")
    save_checkpoint(ckpt, [model.state_dict()])
    steps = forward_steps(lengths)
    audio_s = 2 * sum(lengths) / 16000.0
    gen = torch.Generator().manual_seed(SEED + 10)
    mix = (torch.randn(ROWS_PER_STEP, CHUNK, generator=gen) * 0.1).cuda()
    emb = torch.randn(ROWS_PER_STEP, 256, generator=gen).cuda()
    cuda_model = TFGridNet(**GRID_MODEL_ARGS)
    cuda_model.load_state_dict(model.state_dict())
    cuda_model = cuda_model.cuda().eval()
    lstms = grid_lstms(cuda_model)
    routes = {}
    try:
        for unfold in (True, False):
            route = "unfold" if unfold else "default"
            set_route(unfold)
            exp_dir = os.path.join(root, f"exp_grid_{route}")
            config = {
                "model": {"tse_model": "TFGridNet"},
                "model_args": {"tse_model": dict(GRID_MODEL_ARGS)},
                "data_type": "shard",
                "dataset_args": {"resample_rate": 16000},
                "exp_dir": exp_dir, "checkpoint": ckpt,
                "length_bucket": BUCKET, "infer_batch_size": ROWS_PER_STEP,
                "device": "cuda", **data,
            }
            zero_counts()
            t0 = time.perf_counter()
            avg_sisnr, avg_sisnri = infer(config)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
            log(f"serve TF-GridNet ({route} route): {2 * len(lengths)} "
                f"requests in {steps} forward steps, {wall:.3f} s wall, RTF "
                f"{wall / audio_s:.5f}, avg SI-SNR {avg_sisnr:.3f} dB, avg "
                f"SI-SNRi {avg_sisnri:.3f} dB (random weights: shows the "
                f"chain ran, not quality); launches {launches}")
            expect_counts(launches, GRID_RNNS * steps, 0, unfold,
                          f"serve TF-GridNet ({route})")
            if not (math.isfinite(avg_sisnr) and math.isfinite(avg_sisnri)):
                raise AssertionError("non-finite SI-SNR from infer")
            audio = os.path.join(exp_dir, "audio")
            wavs = sorted(n for n in os.listdir(audio) if n.endswith(".wav"))
            if len(wavs) != 2 * len(lengths):
                raise AssertionError(f"{len(wavs)} outputs for "
                                     f"{2 * len(lengths)} requests")
            for name, n in zip(wavs[::2], lengths):
                wav, _ = read_wav(os.path.join(audio, name))
                if wav.shape != (1, n) or not np.isfinite(wav).all():
                    raise AssertionError(f"bad output {name}: {wav.shape}")

            # kernel forward against the plain versions' forward, f32
            with torch.inference_mode():
                zero_counts()
                est = cuda_model(mix, emb)[0]
                per_forward = read_counts()
                step_ms = time_ms(lambda: cuda_model(mix, emb), 1, 5)
                set_plain(lstms, True)
                try:
                    est_plain = cuda_model(mix, emb)[0]
                    plain_step_ms = time_ms(lambda: cuda_model(mix, emb), 0, 1)
                finally:
                    set_plain(lstms, False)
            expect_counts(per_forward, GRID_RNNS, 0, unfold,
                          f"one TF-GridNet forward ({route})")
            if not torch.isfinite(est).all() or est.shape != mix.shape:
                raise AssertionError("kernel forward is not finite / wrong "
                                     "shape")
            rel = rel_l2(est, est_plain)
            log(f"serve TF-GridNet ({route} route): forward [2 x 3 s] "
                f"{step_ms:.3f} ms/step with the kernels, "
                f"{plain_step_ms:.3f} ms/step with the plain versions; "
                f"{2 * 3.0 / (step_ms / 1e3):.1f} audio-s/s, RTF "
                f"{step_ms / 1e3 / 6.0:.5f}; kernels vs plain rel L2 "
                f"{rel:.3e} (limit 1e-3)")
            if not rel <= 1e-3:
                raise AssertionError(f"kernel forward differs from plain: "
                                     f"{rel}")
            routes[route] = {
                "launches": launches, "wall_s": wall,
                "rtf_wall": wall / audio_s, "step_ms": step_ms,
                "plain_step_ms": plain_step_ms,
                "audio_s_per_s": 2 * 3.0 / (step_ms / 1e3),
                "rtf": step_ms / 1e3 / 6.0, "rel_l2_vs_plain": rel,
                "avg_sisnri": avg_sisnri}
    finally:
        set_route(False)
    return {"requests": 2 * len(lengths), "steps": steps, **routes}


def train_tfgridnet(root):
    """Phase 9: TF-GridNet through bin/train on the card, unfold-fused
    route."""
    from wesep_tpu_torch.bin.infer import infer
    from wesep_tpu_torch.bin.train import train
    from wesep_tpu_torch.models.tfgridnet import TFGridNet
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

    rng = np.random.default_rng(SEED + 11)
    tr, _ = write_shard(root, rng, "gridtrain", [2.0] * (2 * GRID_BATCH))
    va, va_lengths = write_shard(root, rng, "griddev", [1.5] * GRID_BATCH)
    torch.manual_seed(SEED)
    init = TFGridNet(**GRID_MODEL_ARGS)
    init_state = {n: v.clone() for n, v in init.state_dict().items()}
    init_path = os.path.join(root, "grid_init.ckpt")
    save_checkpoint(init_path, [init.state_dict()])
    # the values of examples/librimix/tse/v1/confs/tfgridnet.yaml; one
    # epoch of GRID_TRAIN_STEPS batches on the synthetic shards
    config = {
        "device": "cuda", "exp_dir": os.path.join(root, "exp_grid_train"),
        "data_type": "shard",
        "train_data": tr["data"], "train_spk_embeds": tr["spk_embeds"],
        "train_utt2spk": tr["utt2spk"],
        "val_data": va["data"], "val_spk_embeds": va["spk_embeds"],
        "val_spk1_enroll": va["spk1_enroll"],
        "val_spk2_enroll": va["spk2_enroll"],
        "dataloader_args": {"batch_size": GRID_BATCH, "drop_last": True,
                            "prefetch_factor": 4},
        "dataset_args": {"resample_rate": 16000,
                         "sample_num_per_epoch":
                             GRID_TRAIN_STEPS * GRID_BATCH,
                         "shuffle": True,
                         "shuffle_args": {"shuffle_size": 2500},
                         "chunk_len": GRID_CHUNK, "speaker_feat": False},
        "compute_dtype": "bfloat16", "log_batch_interval": 1,
        "loss": "SISDR", "loss_args": {},
        "model": {"tse_model": "TFGridNet"},
        "model_args": {"tse_model": dict(GRID_MODEL_ARGS)},
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
    val_steps = 1  # 8 validation enrollments / 2 / batch_size 4
    try:
        set_route(True)
        zero_counts()
        t0 = time.perf_counter()
        state = train(config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        log(f"train TF-GridNet: {GRID_TRAIN_STEPS} steps + {val_steps} "
            f"validation step through bin/train in {wall:.3f} s wall; "
            f"launches {launches}")
        expect_counts(launches, GRID_RNNS * (GRID_TRAIN_STEPS + val_steps),
                      GRID_RNNS * GRID_TRAIN_STEPS, True, "train TF-GridNet")
        with open(os.path.join(config["exp_dir"], "train.log")) as f:
            text = f.read()
        losses = rows_loss(text)
        epoch = re.findall(r"Epoch 1 train_loss (\S+) val_loss (\S+)", text)
        log(f"train TF-GridNet: running mean loss per step {losses}, epoch "
            f"{epoch}")
        if len(losses) != GRID_TRAIN_STEPS or len(epoch) != 1 or not all(
                math.isfinite(v)
                for v in losses + [float(e) for e in epoch[0]]):
            raise AssertionError("missing or non-finite training losses")
        if state.step != GRID_TRAIN_STEPS:
            raise AssertionError(f"{state.step} updates, expected "
                                 f"{GRID_TRAIN_STEPS}")
        moved = {n: (p.detach().cpu() - init_state[n]).abs().max().item()
                 for n, p in state.model.named_parameters()}
        still = [n for n, v in moved.items()
                 if v == 0 and not n.endswith(GRID_NOISE_ONLY)]
        if still:
            raise AssertionError(f"parameters that did not change: {still}")
        models = os.path.join(config["exp_dir"], "models")
        ckpt = os.path.join(models, "checkpoint_1.ckpt")
        bundle = load_checkpoint(ckpt)
        if not (bundle["step"] == GRID_TRAIN_STEPS
                and bundle["opt_states"][0]["count"] == GRID_TRAIN_STEPS
                and set(bundle["opt_states"][0]["mu"]) == set(moved)):
            raise AssertionError("checkpoint_1.ckpt lacks optimizer state or "
                                 "step")
        del state
        # bin/infer decodes from the checkpoint bin/train wrote
        sisnr, _ = infer({
            "model": config["model"], "model_args": config["model_args"],
            "data_type": "shard", "dataset_args": {"resample_rate": 16000},
            "exp_dir": os.path.join(root, "exp_grid_ckpt"),
            "checkpoint": ckpt, "save_wav": False, "device": "cuda",
            "length_bucket": BUCKET,
            "test_data": va["data"], "test_spk_embeds": va["spk_embeds"],
            "test_spk1_enroll": va["spk1_enroll"],
            "test_spk2_enroll": va["spk2_enroll"]})
        if not math.isfinite(sisnr):
            raise AssertionError("bin/infer from the trained checkpoint: "
                                 "non-finite SI-SNR")
        log(f"train TF-GridNet: bin/infer decoded {2 * len(va_lengths)} "
            f"requests from checkpoint_1.ckpt, avg SI-SNR {sisnr:.3f} dB")

        # gradients through the kernels against gradients through the
        # plain versions: f32, 2 rows x 1 s, relative L2 per parameter
        # (limit 5e-3, as for SpEx+: the sums run in another order, and an
        # attention PReLU input within rounding of zero may take the other
        # branch; the biases just before those PReLUs read 5e-4 to 1e-3
        # from one machine to another); the GRID_NOISE_ONLY leaves, whose
        # true gradient is zero, are held to 1e-5 of the whole gradient's
        # norm instead
        gen = torch.Generator().manual_seed(SEED + 12)
        model = TFGridNet(**GRID_MODEL_ARGS)
        model.load_state_dict(init_state)
        model = model.cuda().train()
        lstms = grid_lstms(model)
        mix = (torch.randn(2, GRID_CHUNK, generator=gen) * 0.1).cuda()
        target = (torch.randn(2, GRID_CHUNK, generator=gen) * 0.1).cuda()
        emb = torch.randn(2, 256, generator=gen).cuda()
        got = param_grads(model, mix, emb, target)
        set_plain(lstms, True)
        want = param_grads(model, mix, emb, target)
        set_plain(lstms, False)
        total = torch.cat([g.flatten() for g in want.values()]).norm().item()
        rel = {n: rel_l2(got[n], want[n]) for n in want
               if not n.endswith(GRID_NOISE_ONLY)}
        noise = {n: (got[n] - want[n]).norm().item() / total for n in want
                 if n.endswith(GRID_NOISE_ONLY)}
        worst = max(rel, key=rel.get)
        worst_noise = max(noise, key=noise.get)
        log(f"train TF-GridNet: gradients of {len(rel)} parameters, kernels "
            f"vs plain (f32): worst relative L2 {rel[worst]:.3e} at {worst} "
            f"(limit 5e-3); {len(noise)} noise-only leaves: worst error "
            f"{noise[worst_noise]:.3e} of the whole gradient's norm at "
            f"{worst_noise} (limit 1e-5)")
        if not (rel[worst] <= 5e-3 and noise[worst_noise] <= 1e-5):
            raise AssertionError(f"gradients differ: {worst} {rel[worst]}, "
                                 f"{worst_noise} {noise[worst_noise]}")
        del got, want

        # time and peak memory of one train step at the recipe's size, on
        # each route, and with the plain versions
        rows = 2 * GRID_BATCH
        batch = {
            "wav_mix": (torch.randn(rows, GRID_CHUNK, generator=gen) * 0.1)
            .cuda(),
            "wav_targets": (torch.randn(rows, GRID_CHUNK, generator=gen)
                            * 0.1).cuda(),
            "spk_embeds": torch.randn(rows, 256, generator=gen).cuda(),
        }
        opt = make_optimizer(model, exponential_decrease(
            num_epochs=1, epoch_iter=100, initial_lr=1e-3, final_lr=2.5e-5,
            warm_up_epoch=0), weight_decay=1e-4, clip_grad=5.0)
        tstate = TrainState(model=model, optimizer=opt)
        step = make_train_step(parse_loss("SISDR"),
                               compute_dtype=torch.bfloat16)
        timed = {}
        for unfold in (True, False):
            route = "unfold" if unfold else "default"
            set_route(unfold)
            zero_counts()
            step(tstate, batch)
            torch.cuda.synchronize()
            expect_counts(read_counts(), GRID_RNNS, GRID_RNNS, unfold,
                          f"one TF-GridNet train step ({route})")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step_ms = time_ms(lambda: step(tstate, batch), 1, 5)
            timed[route] = {"step_ms": step_ms,
                            "peak_memory_bytes":
                                torch.cuda.max_memory_allocated()}
        set_route(True)
        set_plain(lstms, True)
        plain_step_ms = time_ms(lambda: step(tstate, batch), 0, 1)
        set_plain(lstms, False)
    finally:
        set_route(False)
    audio = rows * GRID_CHUNK / 16000.0
    for route, t in timed.items():
        t["audio_s_per_s"] = audio / (t["step_ms"] / 1e3)
        log(f"train TF-GridNet ({route} route): step [8 rows x 1 s, bf16] "
            f"{t['step_ms']:.3f} ms, {t['audio_s_per_s']:.1f} audio-s/s, "
            f"peak memory {t['peak_memory_bytes'] / 2 ** 30:.2f} GiB")
    log(f"train TF-GridNet: step with the plain versions (unfold route) "
        f"{plain_step_ms:.3f} ms")
    return launches, {
        "steps": GRID_TRAIN_STEPS, "val_steps": val_steps, "wall_s": wall,
        "running_mean_loss": losses, "plain_step_ms": plain_step_ms,
        "grad_rel_l2_worst": rel[worst],
        "noise_only_grad_err_worst": noise[worst_noise], **timed,
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
    tcn_cases = [check_tcn(name, batch, dtype, dilation)
                 for name, batch in (("spex_serve", ROWS_PER_STEP),
                                     ("spex_train", 2 * TRAIN_BATCH))
                 for dtype in (torch.float32, torch.bfloat16)
                 for dilation in (1, 128)]
    fused_cases = [check_fused_tcn_block(dtype)
                   for dtype in (torch.float32, torch.bfloat16)]
    # the unfold-fused layer at TF-GridNet's four shapes, and once at hs 2
    unfold_cases = [check_unfold_kernels(name, rows, length, dtype)
                    for name, (rows, length) in UNFOLD_SHAPES.items()
                    for dtype in (torch.float32, torch.bfloat16)]
    unfold_cases.append(check_unfold_kernels(
        "train_intra_hs2", *UNFOLD_SHAPES["train_intra"], torch.float32,
        hs=2))
    # the plain layer at TF-GridNet's materialised shapes (D = H = 192),
    # where the default route runs it: serving in f32, training in bf16
    grid_d = GRID_KS * GRID_C
    for name, (rows, length) in UNFOLD_SHAPES.items():
        frames = length - GRID_KS + 1
        if name.startswith("serve"):
            cases.append(check_kernel("grid_" + name, frames, rows,
                                      torch.float32, grid_d, GRID_H))
        else:
            train_cases.append(check_training_kernels(
                "grid_" + name[len("train_"):], frames, rows,
                torch.bfloat16, grid_d, GRID_H))

    # 4. serve
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        serve_launches, served = serve(root)
    log("serve summary", json.dumps(served))

    # 5. train
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        train_launches, trained = train_phase(root)
    log("train summary", json.dumps(trained))

    # 6. serve SpEx+
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        spex_serve_launches, spex_served = serve_spex(root)
    log("serve SpEx+ summary", json.dumps(spex_served))

    # 7. train SpEx+
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        spex_launches, spex_trained = train_spex(root)
    log("train SpEx+ summary", json.dumps(spex_trained))

    # 8. serve TF-GridNet, on both routes
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        grid_served = serve_tfgridnet(root)
    log("serve TF-GridNet summary", json.dumps(grid_served))

    # 9. train TF-GridNet, on the unfold-fused route
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        grid_launches, grid_trained = train_tfgridnet(root)
    log("train TF-GridNet summary", json.dumps(grid_trained))

    # the headline case of each kernel: the band RNN, the shape that takes
    # most of its path's time, in the dtype that path runs (serving f32,
    # training bf16)
    band = cases[0]
    train_band = train_cases[1]
    # and of the fused TCN block: SpEx+'s training shape (16 rows, bf16)
    # at dilation 1
    tcn_head = next(c for c in tcn_cases if c["shape"] == "spex_train"
                    and c["dtype"] == "bfloat16" and c["dilation"] == 1)
    # and of the unfold-fused layer: the TF-GridNet training shape (bf16)
    # whose kernels take longest
    unfold_head = max(
        (c for c in unfold_cases
         if c["shape"].startswith("train") and c["dtype"] == "bfloat16"),
        key=lambda c: c["forward"]["ms"] + c["backward"]["ms"]
        + c["wgrad"]["ms"])
    sources = {"bilstm_layer": "wesep_tpu_torch/csrc/bilstm_layer.cu",
               "bilstm_layer_backward":
                   "wesep_tpu_torch/csrc/bilstm_layer_bwd.cu",
               "bilstm_layer_wgrad":
                   "wesep_tpu_torch/csrc/bilstm_layer_bwd.cu",
               "bilstm_layer_unfold": "wesep_tpu_torch/csrc/bilstm_unfold.cu",
               "bilstm_layer_unfold_backward":
                   "wesep_tpu_torch/csrc/bilstm_unfold_bwd.cu",
               "bilstm_layer_unfold_wgrad":
                   "wesep_tpu_torch/csrc/bilstm_unfold_bwd.cu",
               "tcn_block_gln": "wesep_tpu_torch/csrc/tcn_block.cu",
               "tcn_block_gln_backward":
                   "wesep_tpu_torch/csrc/tcn_block_bwd.cu"}
    replaces = {"bilstm_layer": "wesep_tpu/ops/pallas_lstm.py:834",
                "bilstm_layer_backward": "wesep_tpu/ops/pallas_lstm.py:932",
                "bilstm_layer_wgrad": "wesep_tpu/ops/pallas_lstm.py:932",
                "bilstm_layer_unfold": "wesep_tpu/ops/pallas_lstm.py:1236",
                "bilstm_layer_unfold_backward":
                    "wesep_tpu/ops/pallas_lstm.py:1353",
                "bilstm_layer_unfold_wgrad":
                    "wesep_tpu/ops/pallas_lstm.py:1353",
                "tcn_block_gln": "wesep_tpu/ops/pallas_tcn.py:230",
                "tcn_block_gln_backward": "wesep_tpu/ops/pallas_tcn.py:527"}
    headline = {"bilstm_layer": band,
                "bilstm_layer_backward": train_band["backward"],
                "bilstm_layer_wgrad": train_band["wgrad"],
                "bilstm_layer_unfold": unfold_head["forward"],
                "bilstm_layer_unfold_backward": unfold_head["backward"],
                "bilstm_layer_unfold_wgrad": unfold_head["wgrad"],
                "tcn_block_gln": tcn_head["forward"],
                "tcn_block_gln_backward": tcn_head["backward"]}
    # launches of each wrapper on each path that ran it: the main-path
    # count of an entry is its training path's
    by_path = {name: {} for name in headline}
    by_path["bilstm_layer"].update(serve=serve_launches)
    for name in ("bilstm_layer", "bilstm_layer_backward",
                 "bilstm_layer_wgrad"):
        by_path[name]["train"] = train_launches[name]
    by_path["tcn_block_gln"].update(serve=spex_serve_launches)
    for name in ("tcn_block_gln", "tcn_block_gln_backward"):
        by_path[name]["train"] = spex_launches[name]
    for route in ("unfold", "default"):
        for name, n in grid_served[route]["launches"].items():
            if n:
                by_path[name][f"tfgridnet_serve_{route}"] = n
    for name, n in grid_launches.items():
        if n:
            by_path[name]["tfgridnet_train"] = n
    kernels = []
    for name, head in headline.items():
        entry = {"name": name, "route": "cuda", "source": sources[name],
                 "replaces": replaces[name],
                 "launches": by_path[name]["train"
                                           if "train" in by_path[name]
                                           else "tfgridnet_train"],
                 "launches_by_path": by_path[name]}
        entry.update({key: head[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")})
        if name == "bilstm_layer":
            entry["cases"] = cases + [
                dict(c["forward"], shape=c["shape"], dtype=c["dtype"],
                     T=c["T"], B=c["B"], D=c["D"], H=c["H"])
                for c in train_cases]
        elif name.startswith("bilstm_layer_unfold"):
            part = {"bilstm_layer_unfold": "forward",
                    "bilstm_layer_unfold_backward": "backward",
                    "bilstm_layer_unfold_wgrad": "wgrad"}[name]
            entry["cases"] = [
                dict(c[part], shape=c["shape"], dtype=c["dtype"], B=c["B"],
                     L=c["L"], T=c["T"], ks=c["ks"], hs=c["hs"],
                     rel_limit=c["rel_limit"]) for c in unfold_cases]
        elif name.startswith("tcn_block_gln"):
            part = "backward" if name.endswith("backward") else "forward"
            if part == "forward":
                entry["fused_block_cases"] = fused_cases
            entry["cases"] = [
                dict(c[part], shape=c["shape"], dtype=c["dtype"], T=c["T"],
                     B=c["B"], dilation=c["dilation"]) for c in tcn_cases]
        else:
            part = "backward" if name == "bilstm_layer_backward" else "wgrad"
            entry["cases"] = [
                dict(c[part], shape=c["shape"], dtype=c["dtype"], T=c["T"],
                     B=c["B"], D=c["D"], H=c["H"], rel_limit=c["rel_limit"])
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
