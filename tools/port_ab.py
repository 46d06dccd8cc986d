#!/usr/bin/env python3
"""Time the PyTorch port's BiLSTM, fused TCN and fused Conv2dBlock kernels
of two checkouts on one GPU, in turns.

    python3 tools/port_ab.py PARENT_DIR CHANGE_DIR [--rounds N]

Each run is a fresh process started in one checkout: it builds that
checkout's kernels from its own `wesep_tpu_torch/csrc/` and times, with
CUDA events (median of 10 after 2 warm-ups), the plain layer's forward
kernel (K0) without cell states at pBSRNN's serving shapes, and its forward
with cell states and its two backward kernels (K0b: serial adjoint, weight
gradients) at pBSRNN's training shapes, in f32 and bf16 (the shapes of
chip_smoke.py: band T 376, comm T 32; B' 64 / 752 serving, 512 / 6016
training; D 128, H 256); then (median of 5 after 1 warm-up) the f32
serving forward of the full-width v1 pBSRNN (2 rows x 3 s, what bin/infer
runs) on its default LSTM route and on WESEP_LSTM_LAYER=0, in turns within
the process (default, two-kernel, two-kernel, default), and of TF-GridNet
on its default and unfold-fused (WESEP_LSTM_UNFOLD=1) routes likewise;
then a bf16 train step of the pBSRNN on its default LSTM route (16 rows x
3 s) and of TF-GridNet on the unfold-fused route (8 rows x 1 s), with the
optimizer chain, as chip_smoke.py times them; then the fused gLN TCN block
(K4 `_forward_cuda`, K4b `tcn_block_gln_backward`) at SpEx+'s serving (2
rows) and training (16 rows) shapes in f32 and bf16 (C 256, H 512, k 3, T
4799, dilation 1, chip_smoke.py's `tcn_args`), the f32 serving forward of
the full-width SpEx+ (2 rows x 3 s, 6 s enrollments) and its bf16 train
step (16 rows, multi-task loss), as chip_smoke.py times them; then the fused
Conv2dBlock (K5 `cuda_conv2d._forward_cuda`, K5b
`cuda_conv2d.conv2d_block_in_backward`) at DPCCN's six shapes (T 376,
chip_smoke.py's CONV_SHAPES) in f32 at 2 rows and bf16 at 8, with the sum
over a step's 7 blocks (enc0.conv2 counted twice) and the 7 calls timed
back to back as one (the host's work overlapping the card's), DPCCN's f32
serving
forward (2 rows x 3 s) on conv_impl "pallas" and "xla" in turns within the
process (TF32 off for cuDNN), and its bf16 train step (8 rows x 3 s) on
both. The wrappers time whatever route each checkout's wrappers take for
the stream's dtype. Runs go parent,
change, change, parent, N times, so that a drift of the card's clock falls
on both sides. Each run prints a JSON line; the last line holds the median
per checkout and case. Only the API common to every slice of the port
since DPCCN was ported is used (`cuda_lstm.bilstm_layer`,
`_forward_cuda`, `bilstm_layer_backward`, `bilstm_layer_wgrad`,
`cuda_tcn._forward_cuda`, `cuda_tcn.tcn_block_gln_backward`,
`cuda_conv2d._forward_cuda`, `cuda_conv2d.conv2d_block_in_backward`, the
models, `train.trainer` and chip_smoke.py's model arguments, `tcn_args`,
`CONV_SHAPES` and `CONV_T`). Needs one GPU; exits non-zero without one.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = r'''
import json, statistics, torch
from wesep_tpu_torch.ops import _build, cuda_lstm as k

_build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False


def time_ms(fn, warmup=2, runs=10):
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


def inputs(t_len, batch, dtype, d=128, h=256):
    gen = torch.Generator().manual_seed(0)
    r = lambda *s: (torch.randn(*s, generator=gen) * 0.05).cuda()
    x = (torch.randn(batch, t_len, d, generator=gen) * 0.2).cuda().to(dtype)
    dys = (torch.randn(batch, t_len, 2 * h, generator=gen) * 0.1).cuda() \
        .to(dtype)
    return (x, r(d, 4 * h), r(4 * h), r(h, 4 * h), r(d, 4 * h), r(4 * h),
            r(h, 4 * h)), dys


out = {}
for dtype in (torch.float32, torch.bfloat16):
    tag = str(dtype).replace("torch.", "")
    for name, (t_len, batch) in (("band", (376, 64)), ("comm", (32, 752))):
        args, _ = inputs(t_len, batch, dtype)
        out[f"K0 serve_{name} {tag}"] = time_ms(
            lambda: k.bilstm_layer(*args))
    for name, (t_len, batch) in (("band", (376, 512)), ("comm", (32, 6016))):
        args, dys = inputs(t_len, batch, dtype)
        ys, cs = k._forward_cuda(*args, with_cs=True)
        _, _, dg = k.bilstm_layer_backward(*args, ys, cs, dys)
        out[f"K0 train_{name} {tag}"] = time_ms(
            lambda: k._forward_cuda(*args, with_cs=True))
        out[f"K0b adjoint train_{name} {tag}"] = time_ms(
            lambda: k.bilstm_layer_backward(*args, ys, cs, dys))
        out[f"K0b wgrad train_{name} {tag}"] = time_ms(
            lambda: k.bilstm_layer_wgrad(args[0], ys, dg))
        del ys, cs, dg
        torch.cuda.empty_cache()

# f32 serving forwards (2 rows x 3 s, as bin/infer runs them), the routes
# of a model in turns in this process; then bf16 train steps at the
# recipes' sizes, as chip_smoke.py times them
import os
from chip_smoke import GRID_MODEL_ARGS, V1_MODEL_ARGS
from wesep_tpu_torch.models.bsrnn import BSRNN
from wesep_tpu_torch.models.tfgridnet import TFGridNet
from wesep_tpu_torch.train.losses import parse_loss
from wesep_tpu_torch.train.schedulers import exponential_decrease
from wesep_tpu_torch.train.trainer import (TrainState, make_optimizer,
                                           make_train_step)


def serve_ms(model, routes):
    gen = torch.Generator().manual_seed(0)
    mix = (torch.randn(2, 48000, generator=gen) * 0.1).cuda()
    emb = torch.randn(2, 256, generator=gen).cuda()
    times = {}
    with torch.inference_mode():
        for name, env in routes + routes[::-1]:
            old = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            times.setdefault(name, []).append(
                time_ms(lambda: model(mix, emb), 1, 5))
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return {name: statistics.median(t) for name, t in times.items()}


def step_ms(model, rows, samples):
    gen = torch.Generator().manual_seed(0)
    batch = {"wav_mix": (torch.randn(rows, samples, generator=gen) * 0.1)
             .cuda(),
             "wav_targets": (torch.randn(rows, samples, generator=gen) * 0.1)
             .cuda(),
             "spk_embeds": torch.randn(rows, 256, generator=gen).cuda()}
    opt = make_optimizer(model, exponential_decrease(
        num_epochs=1, epoch_iter=100, initial_lr=1e-3, final_lr=2.5e-5,
        warm_up_epoch=0), weight_decay=1e-4, clip_grad=5.0)
    state = TrainState(model=model, optimizer=opt)
    step = make_train_step(parse_loss("SISDR"), compute_dtype=torch.bfloat16)
    return time_ms(lambda: step(state, batch), 1, 5)


torch.manual_seed(0)
for route, ms in serve_ms(BSRNN(**V1_MODEL_ARGS).cuda().eval(), [
        ("default", {}), ("WESEP_LSTM_LAYER=0", {"WESEP_LSTM_LAYER": "0"})
]).items():
    out[f"pBSRNN serve 2x3s f32 {route}"] = ms
torch.cuda.empty_cache()
torch.manual_seed(0)
for route, ms in serve_ms(TFGridNet(**GRID_MODEL_ARGS).cuda().eval(), [
        ("default", {}), ("WESEP_LSTM_UNFOLD=1", {"WESEP_LSTM_UNFOLD": "1"})
]).items():
    out[f"TF-GridNet serve 2x3s f32 {route}"] = ms
torch.cuda.empty_cache()
torch.manual_seed(0)
out["pBSRNN train step 16x3s bf16"] = step_ms(
    BSRNN(**V1_MODEL_ARGS).cuda().train(), 16, 48000)
torch.cuda.empty_cache()
os.environ["WESEP_LSTM_UNFOLD"] = "1"
torch.manual_seed(0)
out["TF-GridNet train step 8x1s bf16"] = step_ms(
    TFGridNet(**GRID_MODEL_ARGS).cuda().train(), 8, 16000)
del os.environ["WESEP_LSTM_UNFOLD"]
torch.cuda.empty_cache()

# the fused gLN TCN block (K4, K4b) at SpEx+'s shapes, then SpEx+ itself
from chip_smoke import SPEX_MODEL_ARGS, tcn_args
from wesep_tpu_torch.models.convtasnet import ConvTasNet
from wesep_tpu_torch.ops import cuda_tcn

for name, batch in (("serve", 2), ("train", 16)):
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        args, dy = tcn_args(batch, dtype)
        conf = (1, 3, False, 1e-5)
        _, stats = cuda_tcn._forward_cuda(*args, *conf)
        out[f"K4 spex_{name} B{batch} {tag}"] = time_ms(
            lambda: cuda_tcn._forward_cuda(*args, *conf))
        out[f"K4b spex_{name} B{batch} {tag}"] = time_ms(
            lambda: cuda_tcn.tcn_block_gln_backward(*args, stats, dy, *conf))
        del args, dy, stats
        torch.cuda.empty_cache()

gen = torch.Generator().manual_seed(0)
torch.manual_seed(0)
spex = ConvTasNet(**SPEX_MODEL_ARGS).cuda().eval()
mix = (torch.randn(2, 48000, generator=gen) * 0.1).cuda()
enr = (torch.randn(2, 96000, generator=gen) * 0.1).cuda()
with torch.inference_mode():
    out["SpEx+ serve 2x3s f32"] = time_ms(lambda: spex(mix, enr), 1, 5)
del spex
torch.cuda.empty_cache()
torch.manual_seed(0)
spex = ConvTasNet(**SPEX_MODEL_ARGS).cuda().train()
criterion = parse_loss(["SISDR", "CE"])
table = {"loss_posi": [[0, 1, 2], [3]], "loss_weight": [[0.8, 0.1, 0.1], [0.5]]}
batch = {"wav_mix": (torch.randn(16, 48000, generator=gen) * 0.1).cuda(),
         "wav_targets": (torch.randn(16, 48000, generator=gen) * 0.1).cuda(),
         "spk_embeds": (torch.randn(16, 96000, generator=gen) * 0.1).cuda(),
         "spk_label": torch.randint(0, 251, (16,), generator=gen).cuda()}
opt = make_optimizer(spex, exponential_decrease(
    num_epochs=1, epoch_iter=100, initial_lr=1e-3, final_lr=2.5e-5,
    warm_up_epoch=0), weight_decay=1e-4, clip_grad=5.0)
state = TrainState(model=spex, optimizer=opt)
step = make_train_step(criterion, table["loss_posi"], table["loss_weight"],
                       multi_task=True, compute_dtype=torch.bfloat16)
out["SpEx+ train step 16x3s bf16"] = time_ms(lambda: step(state, batch), 1, 5)
del spex, opt, state, step, batch
torch.cuda.empty_cache()

# the fused Conv2dBlock (K5, K5b) at DPCCN's six shapes, then DPCCN itself
from chip_smoke import CONV_SHAPES, CONV_T, DPCCN_MODEL_ARGS
from wesep_tpu_torch.models.dpccn import DPCCN
from wesep_tpu_torch.ops import cuda_conv2d

torch.backends.cudnn.allow_tf32 = False
for batch, dtype in ((2, torch.float32), (8, torch.bfloat16)):
    tag = str(dtype).replace("torch.", "")
    steps = {"K5": 0.0, "K5b": 0.0}
    blocks = []
    for name, f, ci, co in CONV_SHAPES:
        gen = torch.Generator().manual_seed(0)
        r = lambda *s: torch.randn(*s, generator=gen)
        x = (r(batch, CONV_T, f, ci) * 0.5).cuda().to(dtype)
        w, b = (r(3, 3, ci, co) * 0.1).cuda(), (r(co) * 0.1).cuda()
        dy = (r(batch, CONV_T, f, co) * 0.1).cuda().to(dtype)
        _, stats = cuda_conv2d._forward_cuda(x, w, b, 1e-5)
        fwd = time_ms(lambda: cuda_conv2d._forward_cuda(x, w, b, 1e-5))
        bwd = time_ms(lambda: cuda_conv2d.conv2d_block_in_backward(
            x, w, b, stats, dy))
        out[f"K5 {name} B{batch} {tag}"] = fwd
        out[f"K5b {name} B{batch} {tag}"] = bwd
        # a step's 7 blocks: enc0.conv2 runs twice (dec7.conv1 too)
        times = 2 if name == "enc0.conv2" else 1
        steps["K5"] += times * fwd
        steps["K5b"] += times * bwd
        blocks += [(x, w, b, dy, stats)] * times
    for kernel, ms in steps.items():
        out[f"{kernel} a step's 7 blocks B{batch} {tag}"] = ms
    # the same 7 calls enqueued back to back in one timed call, as a step
    # enqueues them: the host's work for one block overlaps the card's
    # work for the one before
    out[f"K5 a step's 7 blocks back to back B{batch} {tag}"] = time_ms(
        lambda: [cuda_conv2d._forward_cuda(x, w, b, 1e-5)
                 for x, w, b, _, _ in blocks])
    out[f"K5b a step's 7 blocks back to back B{batch} {tag}"] = time_ms(
        lambda: [cuda_conv2d.conv2d_block_in_backward(x, w, b, stats, dy)
                 for x, w, b, dy, stats in blocks])
    del blocks, x, w, b, dy, stats
torch.cuda.empty_cache()
state = DPCCN(**DPCCN_MODEL_ARGS).state_dict()


def dpccn(route):
    model = DPCCN(**DPCCN_MODEL_ARGS, conv_impl=route)
    model.load_state_dict(state)
    return model.cuda()


gen = torch.Generator().manual_seed(0)
mix = (torch.randn(2, 48000, generator=gen) * 0.1).cuda()
emb = torch.randn(2, 256, generator=gen).cuda()
models = {route: dpccn(route).eval() for route in ("pallas", "xla")}
times = {}
with torch.inference_mode():
    for route in ("pallas", "xla", "xla", "pallas"):
        times.setdefault(route, []).append(
            time_ms(lambda: models[route](mix, emb), 1, 5))
for route, t in times.items():
    out[f"DPCCN serve 2x3s f32 {route}"] = statistics.median(t)
del models
torch.cuda.empty_cache()
for route in ("pallas", "xla"):
    torch.manual_seed(0)
    out[f"DPCCN train step 8x3s bf16 {route}"] = step_ms(
        dpccn(route).train(), 8, 48000)
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
'''


def run(tree):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"run in {tree} failed:\n{proc.stderr[-4000:]}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("parent")
    parser.add_argument("change")
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("port_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    runs = {"parent": [], "change": []}
    order = ["parent", "change", "change", "parent"] * args.rounds
    for side in order:
        times = run(getattr(args, side))
        runs[side].append(times)
        print(json.dumps({"side": side, "ms": times}), flush=True)
    summary = {
        side: {case: statistics.median(r[case] for r in results)
               for case in results[0]}
        for side, results in runs.items()}
    summary["change_over_parent"] = {
        case: summary["change"][case] / summary["parent"][case]
        for case in summary["parent"]}
    print(json.dumps({"card": card, "runs_per_side": len(runs["parent"]),
                      "median_ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
