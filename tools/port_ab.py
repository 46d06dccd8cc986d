#!/usr/bin/env python3
"""Time the PyTorch port's BiLSTM kernels of two checkouts on one GPU, in
turns.

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
optimizer chain, as chip_smoke.py times them. The wrappers time whatever
route each checkout's wrappers take for the stream's dtype. Runs go parent,
change, change, parent, N times, so that a drift of the card's clock falls
on both sides. Each run prints a JSON line; the last line holds the median
per checkout and case. Only the API common to every slice of the port
since TF-GridNet was ported is used (`cuda_lstm.bilstm_layer`,
`_forward_cuda`, `bilstm_layer_backward`, `bilstm_layer_wgrad`, the models,
`train.trainer` and chip_smoke.py's model arguments). Needs one GPU; exits
non-zero without one.
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
print("RESULT " + json.dumps(out))
'''


def run(tree):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=900)
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
