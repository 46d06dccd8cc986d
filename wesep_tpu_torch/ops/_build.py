"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source in `wesep_tpu_torch/csrc/` has a plain C interface and no
PyTorch headers, so nvcc compiles it in seconds. The shared library goes
into `wesep_tpu_torch/build/` (listed in .gitignore) at first use, under a
name keyed by a hash of the source, the shared headers (`csrc/*.cuh`) and
the flags, so an edited source is rebuilt and never mixed up with a stale
library. `build_all` starts one nvcc per source, all together. The compiler's log
(`-Xptxas -v`: registers, shared memory and spills of every kernel) is kept
beside the library.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "SOURCES", "build",
           "build_all", "load_library"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
SOURCES = ("bilstm_layer", "bilstm_layer_bwd", "bilstm_unfold",
           "bilstm_unfold_bwd", "lstm_fused", "lstm_fused_bwd",
           "lstm_forward_tc", "lstm_backward_tc", "lstm_forward_f32",
           "lstm_backward_f32", "tcn_block",
           "tcn_block_bwd", "conv2d_block",
           "conv2d_block_bwd")  # every csrc/<name>.cu


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "of wesep_tpu_torch build only where the CUDA toolkit is installed"
        )
    return path


def _target(name: str, extra=()):
    """(source path, library path) of csrc/<name>.cu built with NVCC_FLAGS
    and the flags `extra`."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(extra)).encode())
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, n) for n in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    return src, out


def _start(src: str, extra=()):
    """Start nvcc on `src` -> (process, temporary output path)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, *extra, "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return proc, tmp


def _finish(proc, tmp: str, src: str, out: str) -> str:
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n{stderr}"
        )
    with open(out + ".log", "w") as f:
        f.write(stdout + stderr)
    # atomic: a concurrent build of the same source loses nothing
    os.replace(tmp, out)
    return out


def build(name: str, extra=()) -> str:
    """Compile csrc/<name>.cu into a shared library (with the nvcc flags
    `extra` beside NVCC_FLAGS, e.g. a register cap); return its path."""
    src, out = _target(name, extra)
    if os.path.exists(out):
        return out
    return _finish(*_start(src, extra), src, out)


def build_all(names=SOURCES) -> dict:
    """Compile several sources at once, one nvcc each, all started
    together; return {name: library path}."""
    targets = {name: _target(name) for name in names}
    running = {name: _start(src) for name, (src, out) in targets.items()
               if not os.path.exists(out)}
    return {name: _finish(*running[name], src, out) if name in running
            else out for name, (src, out) in targets.items()}


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu once per process."""
    return ctypes.CDLL(build(name))
