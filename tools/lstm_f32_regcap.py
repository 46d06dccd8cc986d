#!/usr/bin/env python3
"""Hold the f32 LSTM backward kernels built under a register cap against
their normal build, bit for bit, on one GPU.

    python3 tools/lstm_f32_regcap.py [--cap 168]

Builds csrc/lstm_backward_f32.cu as the port builds it and again with
`-maxrregcount=CAP -DLSTM_F32_MAXNREG=CAP` (the chain's launch bounds
override -maxrregcount, so the source caps it by __maxnreg__ under that
macro), prints each kernel's registers and spills from ptxas
for both builds, then runs the f32 split backward (`cuda_lstm_f32.
split_backward_f32`: gates, adjoint chain, dx, dW) of both builds at the
training shapes chip_smoke.py holds it to (the pBSRNN's band and comm on
K0, K2 and K1 walked backwards, the v2 TF-GridNet's intra RNN on K3 and
inter RNN on K0), on the same inputs and at the same rows a cluster, and
reports whether G (the rows it writes), dg, db, dx and dW agree bit for
bit. The adjoint chain
holds its rows of Wh and its items' carries in registers: a result that
moves with register allocation (a spill, a race the allocation hides)
shows as a difference. Exits non-zero on a difference or without a GPU.
"""

import argparse
import ctypes
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.conv2d_regcap import ptxas_summary  # noqa: E402
from wesep_tpu_torch.ops import _build  # noqa: E402
from wesep_tpu_torch.ops import cuda_lstm  # noqa: E402
from wesep_tpu_torch.ops import cuda_lstm_f32 as f  # noqa: E402
from wesep_tpu_torch.ops import cuda_lstm_tc as tc  # noqa: E402

LIBRARY = "lstm_backward_f32"
# (name, route, B, T, D, H, ks): chip_smoke.py's TRAIN_SHAPES and the v2
# TF-GridNet's (4 rows x 3 s: T' 754 over 284, T' 68 over 3028)
SHAPES = [("train_band", "layer", 512, 376, 128, 256, 1),
          ("train_comm", "layer", 6016, 32, 128, 256, 1),
          ("train_band", "two_kernel", 512, 376, 0, 256, 1),
          ("train_comm", "unidirectional", 6016, 32, 0, 256, 1),
          ("v2_train_intra", "unfold", 3028, 68, 192, 192, 4),
          ("v2_train_inter", "layer", 284, 754, 192, 192, 1)]


def entry_of(lib):
    """A stand-in for cuda_lstm._entry that takes the f32 backward's entry
    points from `lib`."""
    def entry(library, name, n_pointers, n_ints, n_floats=0):
        if library != LIBRARY:
            return cuda_lstm._entry(library, name, n_pointers, n_ints,
                                    n_floats)
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_pointers \
            + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn
    return entry


def inputs(route, b, t, d, h, ks, gen):
    """(x, spec, wxs, biases, whs, ys, cs, dys, xw, reverse) on the card."""
    def r(*s, k=0.3):
        return (torch.randn(*s, generator=gen) * k).cuda()

    dirs = 1 if route == "unidirectional" else 2
    whs = [r(h, 4 * h, k=h ** -0.5) for _ in range(dirs)]
    x = xw = wxs = biases = None
    if route in ("two_kernel", "unidirectional"):
        spec = tc.RowSpec(tc.ROW_H, 0)
        xw = r(dirs, b, t, 4 * h)
    else:
        if route == "unfold":
            c = d // ks
            x = r(b, t + ks - 1, c)
            spec = tc.RowSpec(tc.ROW_UNFOLD, d, t + ks - 1, c, 1)
        else:
            x = r(b, t, d)
            spec = tc.RowSpec(tc.ROW_X, d)
        wxs = [r(d, 4 * h, k=d ** -0.5) for _ in range(dirs)]
        biases = [r(4 * h, k=0.1) for _ in range(dirs)]
    ys = torch.tanh(r(b, t, dirs * h, k=1.0))
    cs, dys = r(b, t, dirs * h, k=1.0), r(b, t, dirs * h, k=0.1)
    return (x, spec, wxs, biases, whs, ys, cs, dys, xw,
            route == "unidirectional")


def run(lib, args, rows):
    """The four kernels of one build -> (G in the layers' order, dg, db,
    dx2 or None, dW)."""
    f._entry = entry_of(lib)
    x, spec, wxs, biases, whs, ys, cs, dys, xw, rev = args
    batch, hidden = ys.shape[0], whs[0].shape[0]
    g = f.lstm_f32_gates(x, ys, wxs, whs, spec, rows, biases, xw, rev)
    dg, db = f.lstm_f32_adjoint_chain(g, whs, cs, dys, batch, rev)
    dx2 = f.lstm_f32_dx(dg, wxs) if wxs is not None else None
    dw = f.lstm_f32_wgrad(x, ys, dg, spec, rev)
    torch.cuda.synchronize()
    # the rows of G's last tile past B are never written
    return f.from_f32_chain_order(g, batch, hidden), dg, db, dx2, dw


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cap", type=int, default=168)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("lstm_f32_regcap: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    builds = {"normal": (), "capped": (f"-maxrregcount={args.cap}",
                                       f"-DLSTM_F32_MAXNREG={args.cap}")}
    libs = {}
    for tag, extra in builds.items():
        path = _build.build(LIBRARY, extra)
        libs[tag] = ctypes.CDLL(path)
        print(json.dumps({"build": tag, "library": LIBRARY,
                          "registers_spill_bytes": ptxas_summary(path)}))
    ok = True
    for name, route, b, t, d, h, ks in SHAPES:
        gen = torch.Generator().manual_seed(0)
        case = inputs(route, b, t, d, h, ks, gen)
        dirs = len(case[4])
        for rows in (f.adjoint_rows_per_cluster(b, dirs, h), f.F32_ROWS[0]):
            got = {tag: run(lib, case, rows) for tag, lib in libs.items()}
            same = {out: (n is None and c is None) or torch.equal(n, c)
                    for out, n, c in zip(("G", "dg", "db", "dx", "dW"),
                                         got["normal"], got["capped"])}
            ok = ok and all(same.values())
            print(json.dumps({"shape": name, "route": route, "B": b, "T": t,
                              "D": d, "H": h, "rows_per_cluster": rows,
                              "cap": args.cap, "same_bits": same}))
            del got
    print(json.dumps({"cap": args.cap, "all_same_bits": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
