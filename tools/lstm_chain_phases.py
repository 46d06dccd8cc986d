#!/usr/bin/env python3
"""Where a step of the LSTM adjoint chain kernel spends its time, on a GPU.

    python3 tools/lstm_chain_phases.py

Builds csrc/lstm_backward_tc.cu with -DLSTM_CHAIN_PHASES, under which the
chain kernel (`lstm_chain_kernel`, csrc/lstm_tc.cuh) reads clock64() at the
borders of each phase of a step: the elementwise dgates, the block barrier,
the dh product, the scatter of the partial sums to the cluster, the
barrier's arrive, the next step's loads, its wait and the sum of the
partials. Threads 0 and 255 of the first blocks of direction 0 keep the
cycles of each phase summed over the steps; the script launches the kernel
at the pBSRNN's band and comm shapes (bf16, H 256, random inputs) and
prints each phase's cycles per step beside the kernel's time (CUDA events)
and the card's highest SM clock. The library goes to
wesep_tpu_torch/build/chain_phases/ (listed in .gitignore); the library the
port loads is not touched.
"""

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


def build() -> ctypes.CDLL:
    out = os.path.join(_build.BUILD_DIR, "chain_phases")
    os.makedirs(out, exist_ok=True)
    lib_path = os.path.join(out, "libchain_phases.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-DLSTM_CHAIN_PHASES", "-o",
                    lib_path,
                    os.path.join(_build.CSRC_DIR, "lstm_backward_tc.cu")],
                   check=True)
    return ctypes.CDLL(lib_path)


def main() -> int:
    if not torch.cuda.is_available():
        print("lstm_chain_phases: needs a GPU", file=sys.stderr)
        return 1
    lib = build()
    chain = lib.lstm_tc_chain
    chain.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    chain.restype = ctypes.c_int
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(clock.strip())
    gen = torch.Generator().manual_seed(0)
    bf16 = torch.bfloat16
    for t_len, batch, hidden in ((376, 512, 256), (32, 6016, 256)):
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

        def run():
            err = chain(*ptrs, batch, t_len, hidden, dirs, 0,
                        torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        run()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        cycles = (ctypes.c_longlong * 256)()
        if lib.lstm_tc_read_phase_cycles(cycles):
            raise RuntimeError("reading the phase cycles failed")
        print(f"T {t_len} B' {batch} H {hidden}: "
              f"{start.elapsed_time(end):.3f} ms")
        for slot, who in ((0, "block 0 thread 0"), (3, "block 3 thread 0"),
                          (8, "block 0 thread 255")):
            per = [cycles[slot * 16 + k] / max(t_len - 1, 1)
                   for k in range(9)]
            print(f"  {who}: cycles a step " + ", ".join(
                f"{n} {v:.0f}" for n, v in zip(PHASES, per))
                + f"; total {sum(per):.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
