#!/usr/bin/env python3
"""Find what makes TF-GridNet's first f32 gradient land in more than one
state in one process on one GPU.

    python3 tools/grid_repeat.py [--repeats 4] [--out build/grid_repeat]

The step is chip_smoke.py's one-process grid step (phase 18 (d),
`grid_card_steps` without a mesh): tfgridnet.yaml's TF-GridNet at full
width, f32 with TF32 off, 4 rows x 1 s, through make_train_step. Each
setting below runs in a fresh process (CUBLAS_WORKSPACE_CONFIG must be set
before CUDA starts) that takes the first gradient `--repeats` times, each
time from a new model built from the same seed, and writes every distinct
state (the gradient's bytes hashed) with its loss:

- none: no determinism setting, as the check runs today;
- cudnn_det: cudnn.deterministic True, benchmark False;
- cublas_ws: CUBLAS_WORKSPACE_CONFIG=:4096:8;
- torch_det_strict: torch.use_deterministic_algorithms(True), raising on
  the first op that has no deterministic CUDA version (its message names
  it), with and without the cuBLAS setting;
- torch_det_warn: the same with warn_only, every op it warns of listed;
- combinations of these;
- pressure: a repeat with the card's free memory cut to the step's peak
  plus 512 MiB, so that workspaces larger than that cannot be had.

Then one process takes the same step in f64 on the card with every LSTM on
its plain version (the kernels are f32 / bf16), and each state is held
against it: the whole gradient's rel. L2 and that of
`spk_fuse.Dense_0.kernel`, with the parameter furthest from it.

    python3 tools/grid_repeat.py --bisect

runs instead the plain setting and, for each group of the model's cuDNN
convolutions (GROUPS: the input conv, the blocks' 1-D ConvTransposes, the
output deconv), cuDNN deterministic everywhere but in that group's
backward (`only_<group>`) or its forward (`fwd_only_<group>`), and lists
the parameters whose gradient moves between runs.
Prints one JSON line a setting and a summary; exits non-zero without a GPU.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LEAF = "spk_fuse.Dense_0.kernel"
CUBLAS = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
# name -> (environment, cudnn deterministic, torch deterministic mode:
# None, "strict" or "warn", pressure repeat)
SETTINGS = {
    "none": ({}, False, None, True),
    "cudnn_det": ({}, True, None, True),
    "cublas_ws": (CUBLAS, False, None, True),
    "torch_det_strict": ({}, False, "strict", False),
    "torch_det_strict+cublas_ws": (CUBLAS, False, "strict", False),
    "torch_det_warn+cublas_ws": (CUBLAS, False, "warn", True),
    "cudnn_det+cublas_ws": (CUBLAS, True, None, True),
    "all": (CUBLAS, True, "warn", True),
}
# --bisect: cuDNN deterministic but for the backward of one group of the
# model's cuDNN convolutions (the attention's 1x1 projections are Dense,
# cuBLAS): the input 3x3 conv, each block's 1-D ConvTranspose (intra and
# inter), the 3x3 output ConvTranspose
GROUPS = {
    "conv": lambda m: [m.conv],
    "block_linears": lambda m: [getattr(b, f"{n}_linear")
                                for b in m.children()
                                if hasattr(b, "intra_linear")
                                for n in ("intra", "inter")],
    "deconv": lambda m: [m.deconv],
}


def nondeterministic_backward(modules):
    """cuDNN's deterministic mode off while the backward of `modules` runs:
    a hook on each output's gradient turns it off, one on its input's
    gradient (or the end of the step, for the input conv) back on."""
    import torch

    cudnn = torch.backends.cudnn

    def hook(module, inputs, out):
        def off(g):
            cudnn.deterministic = False

        def on(g):
            cudnn.deterministic = True

        out.register_hook(off)
        if inputs[0].requires_grad:
            inputs[0].register_hook(on)

    for m in modules:
        m.register_forward_hook(hook)


def nondeterministic_forward(modules):
    """cuDNN's deterministic mode off while the forward of `modules` runs
    (a transposed convolution's forward is cuDNN's backward-data)."""
    import torch

    cudnn = torch.backends.cudnn

    def off(module, inputs):
        cudnn.deterministic = False

    def on(module, inputs, out):
        cudnn.deterministic = True

    for m in modules:
        m.register_forward_pre_hook(off)
        m.register_forward_hook(on)


def first_gradient(dtype, plain=False, group=None):
    """chip_smoke.grid_card_steps' model, batch and first step in `dtype`,
    with `group` nondeterministic: "only_<g>" the backward of GROUPS[g],
    "fwd_only_<g>" its forward -> (loss, {name: gradient on the host})."""
    import torch

    import chip_smoke as cs
    from wesep_tpu_torch.models.tfgridnet import TFGridNet
    from wesep_tpu_torch.train.losses import parse_loss
    from wesep_tpu_torch.train.schedulers import exponential_decrease
    from wesep_tpu_torch.train.trainer import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    gen = torch.Generator().manual_seed(cs.SEED + 85)
    batch = cs.card_batch(cs.GRID_CARD_ROWS, cs.GRID_CHUNK, 256, gen)
    batch = {k: v.to("cuda", dtype) for k, v in batch.items()}
    torch.manual_seed(cs.SEED)
    model = TFGridNet(**cs.GRID_MODEL_ARGS, shard_model_axis=True)
    model = model.to("cuda", dtype)
    for m in cs.grid_lstms(model):
        m.plain = plain
    if group is not None:
        torch.backends.cudnn.deterministic = True
        forward = group.startswith("fwd_only_")
        modules = GROUPS[group.split("only_", 1)[1]](model)
        (nondeterministic_forward if forward
         else nondeterministic_backward)(modules)
    opt = make_optimizer(model, exponential_decrease(
        num_epochs=1, epoch_iter=100, initial_lr=cs.DDP_CARD_LR,
        final_lr=2.5e-5, warm_up_epoch=0), weight_decay=1e-4, clip_grad=5.0)
    grads = []
    cs.recorded(opt, grads)
    state = TrainState(model=model, optimizer=opt)
    _, metrics = make_train_step(parse_loss("SISDR"))(state, batch)
    return float(metrics["loss"]), grads[-1]


def digest(grads) -> str:
    h = hashlib.sha256()
    for name in sorted(grads):
        h.update(grads[name].contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def child(name, repeats, out_dir):
    """One setting in this process -> its record; each distinct state's
    gradient is saved to out_dir/<name>-<digest>.pt."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if name == "f64":
        loss, grads = first_gradient(torch.float64, plain=True)
        torch.save(grads, os.path.join(out_dir, "f64.pt"))
        return {"setting": name, "loss": loss}
    group = name if "only_" in name else None
    _, cudnn_det, mode, pressure = SETTINGS.get(name, ({}, True, None,
                                                       False))
    torch.backends.cudnn.deterministic = cudnn_det
    torch.backends.cudnn.benchmark = False
    rec = {"setting": name, "runs": [], "error": None, "warned": []}
    if mode is not None:
        torch.use_deterministic_algorithms(True, warn_only=mode == "warn")
    runs = [False] * repeats + ([True] if pressure else [])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for squeezed in runs:
            blocker = None
            try:
                if squeezed:
                    peak = torch.cuda.max_memory_reserved()
                    torch.cuda.empty_cache()
                    free, _ = torch.cuda.mem_get_info()
                    spare = free - peak - 512 * 2 ** 20
                    blocker = torch.empty(max(spare, 0), dtype=torch.uint8,
                                          device="cuda")
                t0 = time.perf_counter()
                loss, grads = first_gradient(torch.float32, group=group)
                key = digest(grads)
                path = os.path.join(out_dir, f"{name}-{key}.pt")
                if not os.path.exists(path):
                    torch.save(grads, path)
                rec["runs"].append({"state": key, "loss": loss,
                                    "squeezed": squeezed,
                                    "s": time.perf_counter() - t0})
            except RuntimeError as e:
                rec["error"] = str(e).split("\n")[0][:400]
                break
            finally:
                del blocker
    rec["warned"] = sorted({str(w.message).split("\n")[0][:200]
                            for w in caught
                            if "deterministic" in str(w.message)})
    return rec


def worst_leaf(got, ref):
    """The parameter whose gradient is furthest from ref's, relative to its
    own norm, leaving out those whose true gradient is zero."""
    import chip_smoke as cs

    rel = {n: rel_l2({n: got[n]}, {n: ref[n]}) for n in ref
           if not n.endswith(cs.GRID_NOISE_ONLY)}
    name = max(rel, key=rel.get)
    return name, rel[name]


def rel_l2(a, b) -> float:
    num = sum(float((a[n].double() - b[n]).square().sum()) for n in b)
    den = sum(float(v.square().sum()) for v in b.values())
    return (num / den) ** 0.5


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "grid_repeat"))
    ap.add_argument("--bisect", action="store_true",
                    help="only the plain setting and, for each of GROUPS, "
                    "its backward or its forward alone nondeterministic")
    ap.add_argument("--child", default=None)
    ap.add_argument("--states", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("grid_repeat: no CUDA device", file=sys.stderr)
        return 1
    if args.child:
        print(json.dumps(child(args.child, args.repeats, args.states)),
              flush=True)
        return 0
    from wesep_tpu_torch.ops import _build

    _build.build_all()
    os.makedirs(args.out, exist_ok=True)
    records = []
    with tempfile.TemporaryDirectory(prefix="grid_repeat_") as states:
        names = ["none"] + [f"{way}only_{g}" for way in ("", "fwd_")
                            for g in GROUPS] if args.bisect \
            else list(SETTINGS) + ["f64"]
        for name in names:
            env = dict(os.environ, **(SETTINGS[name][0] if name in SETTINGS
                                      else {}))
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", name,
                 "--repeats", str(args.repeats), "--states", states],
                env=env, capture_output=True, text=True, timeout=600)
            lines = proc.stdout.strip().splitlines()
            try:
                rec = json.loads(lines[-1])
            except (IndexError, json.JSONDecodeError):
                rec = {"setting": name, "exit": proc.returncode,
                       "stderr": proc.stderr[-2000:]}
            records.append(rec)
            print(json.dumps(rec), flush=True)
        against = {}
        f64 = os.path.join(states, "f64.pt")
        for fname in sorted(os.listdir(states)):
            if fname == "f64.pt" or not os.path.exists(f64):
                continue
            ref = torch.load(f64)
            g = torch.load(os.path.join(states, fname))
            against[fname[:-3]] = {
                "whole_rel_l2": rel_l2(g, ref),
                "leaf_rel_l2": rel_l2({LEAF: g[LEAF]}, {LEAF: ref[LEAF]}),
                "worst_leaf": worst_leaf(g, ref)}
        # the distinct states of one setting against each other, and the
        # parameters whose gradient is not the same in all of them
        pairs, varying = {}, {}
        files = sorted(f[:-3] for f in os.listdir(states) if f != "f64.pt")
        for setting in sorted({f.rsplit("-", 1)[0] for f in files}):
            mine = [f for f in files if f.rsplit("-", 1)[0] == setting]
            grads = [torch.load(os.path.join(states, f + ".pt"))
                     for f in mine]
            varying[setting] = sorted(
                n for n in grads[0]
                if not all(torch.equal(grads[0][n], g[n]) for g in grads))
            for i, a in enumerate(mine):
                for j in range(i + 1, len(mine)):
                    ga = grads[i]
                    gb = {n: v.double() for n, v in grads[j].items()}
                    pairs[f"{a} vs {mine[j]}"] = {
                        "whole_rel_l2": rel_l2(ga, gb),
                        "leaf_rel_l2": rel_l2({LEAF: ga[LEAF]},
                                              {LEAF: gb[LEAF]}),
                        "worst_leaf": worst_leaf(ga, gb)}
    summary = {"states_against_f64": against, "states_against_each_other":
               pairs, "varying_parameters_by_setting": {
                   k: {"count": len(v), "names": v}
                   for k, v in varying.items()},
               "distinct_states_by_setting": {
                   r["setting"]: sorted({x["state"] for x in r.get("runs", [])
                                         if not x["squeezed"]})
                   for r in records if "runs" in r}}
    print(json.dumps(summary), flush=True)
    with open(os.path.join(args.out, "grid_repeat.json"), "w") as f:
        json.dump({"records": records, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
