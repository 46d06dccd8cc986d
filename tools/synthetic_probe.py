#!/usr/bin/env python3
"""Run one row of the synthetic battery (wesep_tpu_torch.tools.
validate_synthetic.FLOORS at SMALL) under variations, to tell what moves
its SI-SNRi: the compute dtype, the config's seed (the model's init and
the data order), cuDNN (default, deterministic algorithms, or off: torch's
own convolutions), cuBLAS's bf16 reductions, bf16 convolutions in cuDNN's
own bf16 algorithms (the port sums them in f32: models/common.convolve),
the kernels' plain versions, and the device. TF32 is off, as in
chip_smoke.py.

    python3 tools/synthetic_probe.py --row dpccn [--dtype bfloat16 float32]
        [--seeds 17 18] [--cudnn default deterministic off]
        [--reduction reduced f32] [--cudnn_bf16] [--plain]
        [--repeats 1] [--device cuda]

Runs every combination of the given values in turn, in this process; one
JSON line a run with its SI-SNRi, the row's floor and the wall time, and a
last line with all of them. The config is the tool's own but for the keys
varied (compute_dtype, seed).
"""

import argparse
import itertools
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def set_plain():
    """Every module with a `plain` switch (the LSTMs, the fused TCN and
    Conv2d blocks) runs its kernels' plain versions, from its first call."""
    from torch.nn.modules.module import register_module_forward_pre_hook

    def hook(module, args):
        if hasattr(module, "plain"):
            module.plain = True

    register_module_forward_pre_hook(hook)


def cudnn_bf16_convolutions():
    """Every bf16 convolution of the port's models in cuDNN's own bf16
    algorithms, as before models/common.convolve summed them in f32."""
    from torch.nn import functional as F

    from wesep_tpu_torch.models import common

    def native(conv, x, weight, bias, stride=1, padding=0, dilation=1,
               groups=1):
        if conv in (F.conv_transpose1d, F.conv_transpose2d):
            return conv(x, weight, bias, stride, padding, 0, groups,
                        dilation)
        return conv(x, weight, bias, stride, padding, dilation, groups)

    common.convolve = native


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--row", required=True)
    ap.add_argument("--dtype", nargs="+", default=["bfloat16"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[17])
    ap.add_argument("--cudnn", nargs="+", default=["default"],
                    choices=("default", "deterministic", "off"))
    ap.add_argument("--reduction", nargs="+", default=["reduced"],
                    choices=("reduced", "f32"),
                    help="bf16 products of cuBLAS: torch's default "
                    "(reduced-precision split-K reductions allowed) or "
                    "f32 reductions only")
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--cudnn_bf16", action="store_true",
                    help="bf16 convolutions in cuDNN's own bf16 algorithms "
                    "(cudnn_bf16_convolutions), not summed in f32")
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    import torch

    from wesep_tpu_torch.tools import validate_synthetic as vs

    (kwargs, floor), = [(k, f) for n, k, f in vs.FLOORS if n == args.row]
    if args.plain:
        set_plain()
    if args.cudnn_bf16:
        cudnn_bf16_convolutions()
    write = vs._write_config
    results = []
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    # full f32 where f32 is asked for, as chip_smoke.py runs
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    for dtype, seed, mode, reduction, rep in itertools.product(
            args.dtype, args.seeds, args.cudnn, args.reduction,
            range(args.repeats)):
        def varied(root, config, dtype=dtype, seed=seed):
            config["compute_dtype"] = None if dtype == "float32" else dtype
            config["seed"] = seed
            return write(root, config)

        vs._write_config = varied
        saved = (cudnn.enabled, cudnn.deterministic, cudnn.benchmark,
                 matmul.allow_bf16_reduced_precision_reduction)
        matmul.allow_bf16_reduced_precision_reduction = \
            reduction == "reduced"
        cudnn.enabled = mode != "off"
        cudnn.deterministic = mode == "deterministic"
        cudnn.benchmark = False
        t0 = time.perf_counter()
        try:
            with tempfile.TemporaryDirectory(prefix="synthetic_probe_") as d:
                sisnri = vs.run(d, device=args.device, **vs.SMALL, **kwargs)
        finally:
            (cudnn.enabled, cudnn.deterministic, cudnn.benchmark,
             matmul.allow_bf16_reduced_precision_reduction) = saved
        rec = {"row": args.row, "dtype": dtype, "seed": seed, "cudnn": mode,
               "reduction": reduction,
               "plain": args.plain, "cudnn_bf16": args.cudnn_bf16,
               "repeat": rep, "si_snri": sisnri,
               "floor": floor, "wall_s": time.perf_counter() - t0}
        results.append(rec)
        print("probe", json.dumps(rec), flush=True)
    print(json.dumps({"probe_results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
