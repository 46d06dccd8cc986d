#!/usr/bin/env python3
"""Hold the fused Conv2dBlock kernels built under a register cap against
their normal build, bit for bit, on one GPU.

    python3 tools/conv2d_regcap.py [--cap 64]

Builds csrc/conv2d_block.cu and csrc/conv2d_block_bwd.cu as the port builds
them and again with `-maxrregcount=CAP`, prints each kernel's registers and
spills from ptxas for both builds, then runs K5 (`_forward_cuda`) and K5b
(`conv2d_block_in_backward`) of both builds at DPCCN's six shapes (T 376,
chip_smoke.py's CONV_SHAPES; f32 at 2 rows, bf16 at 8) on the same inputs
and the same dK blocks, and reports whether y, the statistics, dx, dK and db
agree bit for bit. A result that moves with register allocation (a spill, a
race the allocation hides) shows as a difference; the kernels' sums do not
depend on the grid, so the two builds must agree exactly. Exits non-zero on
a difference or without a GPU.
"""

import argparse
import ctypes
import json
import os
import re
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import CONV_SHAPES, CONV_T  # noqa: E402
from wesep_tpu_torch.ops import _build  # noqa: E402
from wesep_tpu_torch.ops import cuda_conv2d as k  # noqa: E402

LIBRARIES = ("conv2d_block", "conv2d_block_bwd")


def ptxas_summary(path):
    """{kernel: (registers, spill bytes)} from a build's ptxas log."""
    found, name, spill = {}, None, 0
    with open(path + ".log") as f:
        for line in f:
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                name, spill = m.group(1), 0
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and name:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                found[name] = (int(m.group(1)), spill)
                name = None
    return found


def libraries(extra):
    """The two libraries of one build, loaded, with their declarations."""
    libs = {}
    for name in LIBRARIES:
        lib = ctypes.CDLL(_build.build(name, extra))
        for entry in (("conv2d_block_forward",) if name == "conv2d_block"
                      else ("conv2d_block_backward",
                            "conv2d_block_backward_slots")):
            getattr(lib, entry).argtypes = k._argtypes(entry)
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def run(libs, slots, x, w, b, dy):
    """K5 and K5b of one build -> (y, stats, dx, dK, db)."""
    k._library = lambda name: libs[name]
    k._slots = lambda ci, co, dtype, device: slots
    y, stats = k._forward_cuda(x, w, b, 1e-5)
    grads = k.conv2d_block_in_backward(x, w, b, stats, dy)
    torch.cuda.synchronize()
    return (y, stats, *grads)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cap", type=int, default=64)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("conv2d_regcap: no CUDA device", file=sys.stderr)
        return 1
    builds = {"normal": (), "capped": (f"-maxrregcount={args.cap}",)}
    libs = {tag: libraries(extra) for tag, extra in builds.items()}
    for tag, extra in builds.items():
        for name in LIBRARIES:
            summary = ptxas_summary(_build.build(name, extra))
            print(json.dumps({"build": tag, "library": name,
                              "registers_spill_bytes": summary}))
    ok = True
    for batch, dtype in ((2, torch.float32), (8, torch.bfloat16)):
        for name, f, ci, co in CONV_SHAPES:
            gen = torch.Generator().manual_seed(0)
            x = (torch.randn(batch, CONV_T, f, ci, generator=gen) * 0.5) \
                .cuda().to(dtype)
            w = (torch.randn(3, 3, ci, co, generator=gen) * 0.1).cuda()
            b = (torch.randn(co, generator=gen) * 0.1).cuda()
            dy = (torch.randn(batch, CONV_T, f, co, generator=gen) * 0.1) \
                .cuda().to(dtype)
            slots = libs["normal"]["conv2d_block_bwd"] \
                .conv2d_block_backward_slots(ci, co, k._DTYPE_CODES[dtype])
            got = {tag: run(lib, slots, x, w, b, dy)
                   for tag, lib in libs.items()}
            same = {out: torch.equal(n, c) for out, n, c in zip(
                ("y", "stats", "dx", "dK", "db"), got["normal"],
                got["capped"])}
            ok = ok and all(same.values())
            print(json.dumps({"shape": name, "dtype": str(dtype)[6:],
                              "B": batch, "cap": args.cap,
                              "same_bits": same}))
    print(json.dumps({"cap": args.cap, "all_same_bits": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
