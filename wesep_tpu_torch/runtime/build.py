"""Build the port's C++ serving runtime with g++ (no cmake).

    python -m wesep_tpu_torch.runtime.build [--test]

Three programs, each from the sources beside this file: `separate_main`
(bin/, separate/, frontend/, utils/; it embeds CPython), `runtime_test` (the
frontend's unit tests) and `fbank_dump` (a test helper that writes the
engine's fbank of a wav). Each goes into `wesep_tpu_torch/build/runtime/`
(listed in .gitignore) at first use, under a name keyed by a hash of every
source here, the flags and the interpreter's paths, so an edit or another
interpreter rebuilds it; `build_all` starts one g++ a program, all
together, and keeps each compiler's log beside its program.

Python's include dir and link flags come from sysconfig of the interpreter
that runs this module, whose path is compiled into separate_main (so that
the embedded interpreter finds the same prefix and site-packages, a venv's
included); a static libpython is linked with LINKFORSHARED
(`-Xlinker -export-dynamic`), which torch's extension modules need to find
its symbols. No CUDA is linked: the engine reaches the kernels through
runtime_host inside the embedded interpreter.
"""

import argparse
import functools
import hashlib
import json
import os
import shlex
import shutil
import subprocess
import sys
import sysconfig
import tempfile

__all__ = ["RUNTIME_DIR", "BUILD_DIR", "CXX_FLAGS", "PROGRAMS",
           "python_config", "build", "build_all", "run_tests"]

RUNTIME_DIR = os.path.dirname(os.path.abspath(__file__))
_PKG_DIR = os.path.dirname(RUNTIME_DIR)
REPO_ROOT = os.path.dirname(_PKG_DIR)
BUILD_DIR = os.path.join(_PKG_DIR, "build", "runtime")
CXX_FLAGS = ("-std=c++17", "-O2", "-pthread", "-Wall")
_COMMON = ("frontend/fft.cc", "frontend/feature_pipeline.cc",
           "utils/utils.cc")
PROGRAMS = {
    "separate_main": ("bin/separate_main.cc",
                      "separate/separate_engine.cc") + _COMMON,
    "runtime_test": ("test/runtime_test.cc",) + _COMMON,
    "fbank_dump": ("test/fbank_dump.cc",) + _COMMON,
}


def python_config() -> dict:
    """What the build reads of this interpreter's sysconfig."""
    var = sysconfig.get_config_var
    include = sysconfig.get_paths()["include"]
    return {
        "executable": sys.executable,
        "version": sysconfig.get_python_version(),
        "include": include,
        "has_python_h": os.path.exists(os.path.join(include, "Python.h")),
        "Py_ENABLE_SHARED": var("Py_ENABLE_SHARED"),
        "LIBDIR": var("LIBDIR"),
        "LIBPL": var("LIBPL"),
        "LDLIBRARY": var("LDLIBRARY"),
        "LIBRARY": var("LIBRARY"),
        "LDVERSION": var("LDVERSION"),
        "LIBS": var("LIBS"),
        "SYSLIBS": var("SYSLIBS"),
        "LINKFORSHARED": var("LINKFORSHARED"),
    }


def _python_flags():
    """(compile flags, link flags) that embed this interpreter."""
    cfg = python_config()
    if not cfg["has_python_h"]:
        raise RuntimeError(
            f"Python.h is not under {cfg['include']}: separate_main embeds "
            "CPython and needs the interpreter's development headers")
    compile_flags = [
        f"-I{cfg['include']}",
        f"-DWESEP_PYTHON_EXECUTABLE={json.dumps(cfg['executable'])}",
        f"-DWESEP_REPO_ROOT={json.dumps(REPO_ROOT)}",
    ]
    libdir = cfg["LIBDIR"] or ""
    if cfg["Py_ENABLE_SHARED"]:
        link = [f"-L{libdir}", f"-lpython{cfg['LDVERSION']}",
                f"-Wl,-rpath,{libdir}"]
    else:
        archive = next(
            (os.path.join(d, cfg["LIBRARY"]) for d in (cfg["LIBPL"], libdir)
             if d and cfg["LIBRARY"]
             and os.path.exists(os.path.join(d, cfg["LIBRARY"]))), None)
        if archive is None:
            raise RuntimeError(
                f"no static libpython ({cfg['LIBRARY']}) under "
                f"{cfg['LIBPL']} or {libdir}")
        link = [archive]
    for key in ("LIBS", "SYSLIBS", "LINKFORSHARED"):
        link += shlex.split(cfg[key] or "")
    return compile_flags, link


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise RuntimeError("g++ not found: the runtime builds with a C++17 "
                           "compiler")
    return found


def _command(name: str, out: str):
    """The g++ command line of program `name` into `out`."""
    compile_flags, link = _python_flags() if name == "separate_main" \
        else ([], [])
    sources = [os.path.join(RUNTIME_DIR, s) for s in PROGRAMS[name]]
    return [_cxx(), *CXX_FLAGS, f"-I{RUNTIME_DIR}", *compile_flags,
            *sources, "-o", out, *link]


@functools.lru_cache(maxsize=None)
def _sources_digest() -> str:
    digest = hashlib.sha256()
    for dirpath, dirnames, names in sorted(os.walk(RUNTIME_DIR)):
        dirnames.sort()
        for n in sorted(names):
            if n.endswith((".h", ".cc")):
                path = os.path.join(dirpath, n)
                digest.update(os.path.relpath(path, RUNTIME_DIR).encode())
                with open(path, "rb") as f:
                    digest.update(f.read())
    return digest.hexdigest()


def _target(name: str) -> str:
    """The path of program `name` built from today's sources and flags."""
    digest = hashlib.sha256(_sources_digest().encode())
    digest.update(" ".join(_command(name, "OUT")).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}")


def _start(name: str):
    """Start g++ on program `name` -> (process, temporary output path)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{name}-", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(proc, tmp: str, name: str, out: str) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"g++ failed on {name} (exit {proc.returncode}):\n{log}")
    with open(out + ".log", "w") as f:
        f.write(" ".join(proc.args) + "\n" + log)
    # atomic: a concurrent build of the same program loses nothing
    os.replace(tmp, out)
    return out


def build(name: str) -> str:
    """Compile program `name` (a key of PROGRAMS) if needed; its path."""
    return build_all((name,))[name]


def build_all(names=tuple(PROGRAMS)) -> dict:
    """Compile several programs at once, one g++ each, all started
    together; -> {name: path}."""
    targets = {name: _target(name) for name in names}
    running = {name: _start(name) for name, out in targets.items()
               if not os.path.exists(out)}
    return {name: _finish(*running[name], name, out) if name in running
            else out for name, out in targets.items()}


def run_tests(path: str = None) -> str:
    """Run runtime_test -> its output; raise unless every test passed."""
    path = path or build("runtime_test")
    proc = subprocess.run([path], capture_output=True, text=True,
                          timeout=120)
    if proc.returncode != 0 or "ALL RUNTIME TESTS PASSED" not in proc.stdout:
        raise RuntimeError(f"runtime_test failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--test", action="store_true",
                        help="run runtime_test after the build")
    args = parser.parse_args(argv)
    paths = build_all()
    if args.test:
        print(run_tests(paths["runtime_test"]), end="")
    for name, path in paths.items():
        print(f"{name}: {path}")


if __name__ == "__main__":
    main()
