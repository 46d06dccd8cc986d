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
training; D 128, H 256). Runs go parent, change, change, parent, N times,
so that a drift of the card's clock falls on both sides. Each run prints a
JSON line; the last line holds the median per checkout and case. Only the
wrappers' API common to every slice of the port since training was ported
is used (`cuda_lstm.bilstm_layer`, `_forward_cuda`, `bilstm_layer_backward`,
`bilstm_layer_wgrad`). Needs one GPU; exits non-zero without one.
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
