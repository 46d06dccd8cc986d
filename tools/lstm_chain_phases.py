#!/usr/bin/env python3
"""Where a step of the LSTM chain kernels spends its time, on a GPU.

    python3 tools/lstm_chain_phases.py [--chain adjoint|forward|f32|both|all]

Builds csrc/lstm_backward_tc.cu and csrc/lstm_forward_tc.cu (and, for the
f32 chain, csrc/lstm_forward_f32.cu) with -DLSTM_CHAIN_PHASES, under which
each chain kernel (`lstm_chain_kernel`, the adjoint, and
`lstm_forward_chain_kernel`, the bf16 forward, of csrc/lstm_tc.cuh;
`f32_chain_kernel`, the f32 forward) reads clock64() at the borders of
each phase of a step. The adjoint's
phases: the elementwise dgates, the block barrier, the dh product, the
scatter of the partial sums to the cluster, the barrier's arrive, the next
step's loads, its wait and the sum of the partials. The forward's: the h
product, the cell update, the block barrier, the exchange of h_t's slice
(asynchronous stores into the peers, counted on their mbarriers), the
stores of y and cs, the next step's xw loads and the wait for the peers'
slices. Threads 0 and the last of the first blocks of direction 0 keep the
cycles of each phase summed over the steps; the script launches each kernel
at the pBSRNN's band and comm shapes (bf16, H 256, random inputs; the
forward from an f32 xw) and prints each phase's cycles per step beside the
kernel's time (CUDA events) and the card's highest SM clock. The f32
chain's phases: the wait for the peers' slices, the h product (FMAs), the
block barrier, the cell update with the stores of y and cs, the exchange,
the next step's xw loads and the step's last block barrier; it runs at the
pBSRNN's serving band and comm shapes (H 256) and TF-GridNet's inter shape
(H 192), f32, at each of 8, 16 and 32 rows a cluster. The libraries go to
wesep_tpu_torch/build/chain_phases/ (listed in .gitignore); the libraries
the port loads are not touched.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from wesep_tpu_torch.ops import _build  # noqa: E402

PHASES = ("elementwise", "block barrier", "dh product", "scatter",
          "arrive", "next loads", "wait", "partial sums", "loop top")
FORWARD_PHASES = ("h product", "cell update", "block barrier", "exchange",
                  "y and cs stores", "next loads", "wait")
SHAPES = ((376, 512, 256), (32, 6016, 256))  # (T, B', H): band, comm
F32_PHASES = ("wait", "h product", "block barrier", "cell update",
              "exchange", "next loads", "step barrier")
# (T, B', H): pBSRNN serve band, serve comm; TF-GridNet serve inter
F32_SHAPES = ((376, 64, 256), (32, 752, 256), (754, 142, 192))


def build(source: str) -> ctypes.CDLL:
    out = os.path.join(_build.BUILD_DIR, "chain_phases")
    os.makedirs(out, exist_ok=True)
    lib_path = os.path.join(out, f"lib{source}_phases.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-DLSTM_CHAIN_PHASES", "-o",
                    lib_path, os.path.join(_build.CSRC_DIR, source + ".cu")],
                   check=True)
    return ctypes.CDLL(lib_path)


def report(lib, t_len, run, phases, last_thread):
    """Time one launch of `run` after a first one, then print the phase
    cycles a step of blocks 0 and 3 (thread 0) and block 0's last
    thread."""
    run()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    cycles = (ctypes.c_longlong * 256)()
    if lib.lstm_tc_read_phase_cycles(cycles):
        raise RuntimeError("reading the phase cycles failed")
    print(f"  {start.elapsed_time(end):.3f} ms")
    for slot, who in ((0, "block 0 thread 0"), (3, "block 3 thread 0"),
                      (8, f"block 0 thread {last_thread}")):
        per = [cycles[slot * 16 + k] / max(t_len - 1, 1)
               for k in range(len(phases))]
        print(f"  {who}: cycles a step " + ", ".join(
            f"{n} {v:.0f}" for n, v in zip(phases, per))
            + f"; total {sum(per):.0f}")


def _launcher(fn):
    def run(*args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return run


def adjoint(gen):
    lib = build("lstm_backward_tc")
    chain = lib.lstm_tc_chain
    chain.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    chain.restype = ctypes.c_int
    launch = _launcher(chain)
    bf16 = torch.bfloat16
    for t_len, batch, hidden in SHAPES:
        dirs = 2

        def r(*shape):
            return torch.randn(*shape, generator=gen).cuda()

        g = torch.sigmoid(r(dirs, batch, t_len, 4 * hidden))
        whs = [(r(hidden, 4 * hidden) / 16).to(bf16) for _ in range(dirs)]
        cs = r(batch, t_len, dirs * hidden) * 0.5
        dys = (r(batch, t_len, dirs * hidden) * 0.1).to(bf16)
        dg = torch.empty(dirs, batch, t_len, 4 * hidden, dtype=bf16,
                         device="cuda")
        db = torch.empty(-(-batch // 32), dirs, 4 * hidden, device="cuda")
        ptrs = [t.data_ptr() for t in (g, whs[0], whs[1], cs, dys, dg, db)]
        print(f"adjoint chain, T {t_len} B' {batch} H {hidden}:")
        report(lib, t_len, lambda: launch(*ptrs, batch, t_len, hidden, dirs,
                                          0), PHASES, 255)


def forward(gen):
    lib = build("lstm_forward_tc")
    chain = lib.lstm_tc_forward
    chain.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    chain.restype = ctypes.c_int
    launch = _launcher(chain)
    for t_len, batch, hidden in SHAPES:
        dirs = 2
        # f32 xw is read in the chain's order, the same size here (B' a
        # multiple of 64)
        xw = torch.randn(dirs, batch, t_len, 4 * hidden, generator=gen) \
            .cuda()
        whs = [(torch.randn(hidden, 4 * hidden, generator=gen) / 16).cuda()
               .to(torch.bfloat16) for _ in range(dirs)]
        y = torch.empty(batch, t_len, dirs * hidden, dtype=torch.bfloat16,
                        device="cuda")
        cs = torch.empty(batch, t_len, dirs * hidden, device="cuda")
        ptrs = [t.data_ptr() for t in (xw, whs[0], whs[1], y, cs)]
        print(f"forward chain, T {t_len} B' {batch} H {hidden}:")
        report(lib, t_len, lambda: launch(*ptrs, batch, t_len, hidden, dirs,
                                          0, 0), FORWARD_PHASES, 255)
        del xw, y, cs


def f32_forward(gen):
    lib = build("lstm_forward_f32")
    chain = lib.lstm_f32_forward
    chain.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    chain.restype = ctypes.c_int
    launch = _launcher(chain)
    for t_len, batch, hidden in F32_SHAPES:
        dirs = 2
        whs = [(torch.randn(hidden, 4 * hidden, generator=gen) / 16).cuda()
               for _ in range(dirs)]
        y = torch.empty(batch, t_len, dirs * hidden, device="cuda")
        cs = torch.empty_like(y)
        for rows in (8, 12, 16, 20, 32):
            # xw in the chain's order for these rows a cluster
            xw = torch.randn(dirs, -(-batch // rows), t_len,
                             rows * 4 * hidden, generator=gen).cuda()
            ptrs = [t.data_ptr() for t in (xw, whs[0], whs[1], y, cs)]
            print(f"f32 forward chain, T {t_len} B' {batch} H {hidden}, "
                  f"{rows} rows a cluster:")
            report(lib, t_len, lambda: launch(*ptrs, batch, t_len, hidden,
                                              dirs, 0, 1, rows),
                   F32_PHASES, hidden - 1)
            del xw
        del y, cs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chain",
                        choices=("adjoint", "forward", "f32", "both", "all"),
                        default="both")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("lstm_chain_phases: needs a GPU", file=sys.stderr)
        return 1
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(clock.strip())
    gen = torch.Generator().manual_seed(0)
    if args.chain in ("adjoint", "both", "all"):
        adjoint(gen)
    if args.chain in ("forward", "both", "all"):
        forward(gen)
    if args.chain in ("f32", "all"):
        f32_forward(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
