"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source in `wesep_tpu_torch/csrc/` has a plain C interface and no
PyTorch headers, so nvcc compiles it in seconds. The shared library goes
into `wesep_tpu_torch/build/` (listed in .gitignore) at first use, under a
name keyed by a hash of the source and the flags, so an edited source is
rebuilt and never mixed up with a stale library. The compiler's log
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

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build", "load_library"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


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


def build(name: str) -> str:
    """Compile csrc/<name>.cu into a shared library; return its path."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n{proc.stderr}"
        )
    with open(out + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    # atomic: a concurrent build of the same source loses nothing
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu once per process."""
    return ctypes.CDLL(build(name))
