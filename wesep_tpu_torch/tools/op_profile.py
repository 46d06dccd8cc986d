"""Summarize a torch.profiler Chrome trace: the device's busy time by class.

Counterpart of wesep_tpu/tools/op_profile.py, which reads a jax.profiler
xplane; this reads the Chrome trace that `utils/profiling.trace` writes
(the newest `*.json` under `logdir`, or `logdir` itself if it is a file):

  python -m wesep_tpu_torch.tools.op_profile /tmp/trace_dir [--top 20]

It prints the device's busy ms (the union of its kernel, memcpy and memset
events) beside the traced window's ms (from the first event of the trace to
the end of the last), then rows of ms, % (of the device events' summed ms)
and label, by class:

  * the port's own kernels: the `__global__` functions of
    wesep_tpu_torch/csrc/, each by name (with its template arguments) and
    its launch count;
  * cuBLAS / CUTLASS products; cuDNN; cuFFT; torch's elementwise and
    reduction kernels (`at::`); copies and sets; other kernels.

A trace with no device events (a CPU run) gets one line saying so, as the
JAX tool prints one for a missing xplane.
"""

import argparse
import collections
import functools
import glob
import json
import os
import re

__all__ = ["PORT", "COPIES", "port_kernel_names", "kernel_label",
           "classify", "load_trace", "profile", "rows"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
PORT = "the port's kernels"
COPIES = "copies and sets"
# (class, lower-case substrings of a kernel's name), tried in this order
# after the port's own kernels
_LIBRARY = (
    ("torch elementwise and reductions", ("at::",)),
    ("cuDNN", ("cudnn", "fprop", "dgrad", "wgrad", "winograd",
               "implicit_convolve", "nchwtonhwc", "nhwctonchw")),
    ("cuFFT", ("fft",)),
    ("cuBLAS / CUTLASS products", ("gemm", "gemv", "cutlass", "cublas",
                                   "nvjet", "splitkreduce", "dot_kernel")),
)
OTHER = "other kernels"


@functools.lru_cache(maxsize=None)
def port_kernel_names(csrc: str = _CSRC) -> frozenset:
    """The names of the `__global__` functions in csrc/*.cu and *.cuh."""
    names = set()
    for path in sorted(glob.glob(os.path.join(csrc, "*.cu*"))):
        with open(path) as f:
            text = f.read()
        for m in re.finditer(r"__global__\b([^{;]*)", text):
            calls = re.findall(r"([A-Za-z_]\w*)\s*(?:<[^()]*>)?\s*\(",
                               m.group(1))
            # past __launch_bounds__(...), __cluster_dims__(...), macros
            # in capitals and the sizeof in their arguments
            name = next((c for c in calls if not c.startswith("__")
                         and not c.isupper() and c != "sizeof"), None)
            if name:
                names.add(name)
    return frozenset(names)


def kernel_label(name: str) -> str:
    """A kernel event's name without its return type, namespaces and
    argument list: "void (anonymous namespace)::k<3, 0>(Rows, Ops)" ->
    "k<3, 0>"."""
    label = name.replace("(anonymous namespace)::", "").strip()
    if label.startswith("void "):
        label = label[5:]
    depth = 0
    for i, ch in enumerate(label):  # the first "(" outside <...>
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            label = label[:i]
            break
    head, angle, tail = label.partition("<")
    return head.rsplit("::", 1)[-1] + angle + tail


def classify(event: dict) -> str:
    """The class of a device event."""
    if event.get("cat") in ("gpu_memcpy", "gpu_memset"):
        return COPIES
    name = event.get("name", "")
    if re.split(r"[<(]", kernel_label(name))[0] in port_kernel_names():
        return PORT
    low = name.lower()
    for cls, keys in _LIBRARY:
        if any(k in low for k in keys):
            return cls
    return OTHER


def load_trace(logdir: str):
    """The parsed Chrome trace (the newest *.json under logdir, or logdir
    itself), or None."""
    if os.path.isfile(logdir):
        path = logdir
    else:
        paths = glob.glob(os.path.join(logdir, "**", "*.json"),
                          recursive=True)
        if not paths:
            return None
        path = max(paths, key=os.path.getmtime)
    with open(path) as f:
        return json.load(f)


def _device_event(e: dict) -> bool:
    return e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")


def _union_us(spans):
    total, end = 0.0, None
    for start, stop in sorted(spans):
        if end is None or start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def profile(trace: dict) -> dict:
    """{"device", "busy_ms", "window_ms", "event_ms", "classes": {class:
    ms}, "kernels": {label: [ms, launches]} of the port's kernels} of a
    trace; busy_ms None when it holds no device event."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"
              and "ts" in e]
    timed = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in events]
    window = (max(t[1] for t in timed) - min(t[0] for t in timed)) / 1e3 \
        if timed else 0.0
    device = [e for e in events if _device_event(e)]
    props = trace.get("deviceProperties") or [{}]
    out = {"device": props[0].get("name", "cuda"), "window_ms": window,
           "busy_ms": None, "event_ms": 0.0, "classes": {}, "kernels": {}}
    if not device:
        return out
    classes = collections.Counter()
    kernels = {}
    for e in device:
        ms = float(e.get("dur", 0.0)) / 1e3
        cls = classify(e)
        classes[cls] += ms
        if cls == PORT:
            entry = kernels.setdefault(kernel_label(e["name"]), [0.0, 0])
            entry[0] += ms
            entry[1] += 1
    out.update(busy_ms=_union_us(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        for e in device) / 1e3, event_ms=sum(classes.values()),
        classes=dict(classes), kernels=kernels)
    return out


def rows(prof: dict, top: int = 20):
    """[(ms, pct, label)]: every class, then the port's kernels (the `top`
    longest) with their launch counts."""
    total = max(prof["event_ms"], 1e-9)
    out = [(ms, 100.0 * ms / total, cls) for cls, ms in sorted(
        prof["classes"].items(), key=lambda kv: -kv[1])]
    kernels = sorted(prof["kernels"].items(), key=lambda kv: -kv[1][0])
    out += [(ms, 100.0 * ms / total, f"  {label} x{n}")
            for label, (ms, n) in kernels[:top]]
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="Chrome trace op profile")
    parser.add_argument("logdir", help="dir passed to utils.profiling.trace "
                        "(or a trace file)")
    parser.add_argument("--top", type=int, default=20)
    args = parser.parse_args(argv)
    trace = load_trace(args.logdir)
    if trace is None:
        print(f"no Chrome trace found under {args.logdir}")
        return
    prof = profile(trace)
    if prof["busy_ms"] is None:
        print(f"no device events in the trace ({prof['window_ms']:.1f} ms "
              "window): a CPU run")
        return
    print(f"{prof['device']}: device busy {prof['busy_ms']:.1f} ms, window "
          f"{prof['window_ms']:.1f} ms "
          f"({100.0 * prof['busy_ms'] / max(prof['window_ms'], 1e-9):.1f} % "
          "busy)")
    for ms, pct, label in rows(prof, args.top):
        print(f"  {ms:9.2f} ms {pct:5.1f}%  {label}")


if __name__ == "__main__":
    main()
