"""In-process model host for a serving runtime that embeds CPython.

Counterpart of wesep_tpu/runtime_host.py with its interface: `load`,
`expects_fbank` and `separate`, and `unload`, which drops the model before
an embedding interpreter is finalized; `launches` reads the kernel
wrappers' launch counters, which `load` sets to 0. The port's C++
`separate_main` (wesep_tpu_torch/runtime/) imports this module by name, as
the JAX package's imports its own, and prints `launches()` last. The
model runs on the card unless `load` is given device "cpu".

`load` takes either
  * an export dir of bin/export.py (model.pt2 + export.json): the program
    at its static shapes, with the weights it holds (the dir's model.ckpt
    is the same weights as a bundle, for bin/infer and model_init); or
  * a model dir (config.yaml + avg_model.ckpt): the model in eval mode,
    called at each request's own length.
"""

import json
import os

import numpy as np

_STATE = {}
# the modules of the port's kernel wrappers; each wrapper counts its
# launches in its `launches` attribute
_KERNEL_MODULES = ("cuda_lstm", "cuda_lstm_unfold", "cuda_lstm_fused",
                   "cuda_lstm_tc", "cuda_lstm_f32", "cuda_tcn", "cuda_conv2d")


def _kernel_wrappers():
    import importlib

    return {name: fn for module in _KERNEL_MODULES
            for name, fn in vars(importlib.import_module(
                f"wesep_tpu_torch.ops.{module}")).items()
            if not name.startswith("_") and hasattr(fn, "launches")}


def launches() -> dict:
    """{wrapper name: launches} of each kernel wrapper launched since
    `load`."""
    return {name: fn.launches for name, fn in _kernel_wrappers().items()
            if fn.launches}


def load(model_path: str, device=None):
    """Initialise the model host -> the sample rate."""
    import torch

    from wesep_tpu_torch.bin.export import build_served, load_program
    from wesep_tpu_torch.device import resolve_device

    _STATE.clear()
    for fn in _kernel_wrappers().values():
        fn.launches = 0
    manifest_path = os.path.join(model_path, "export.json")
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
        exported_on = torch.device(manifest["platforms"][0])
        asked = exported_on if device is None else torch.device(device)
        if asked.type != exported_on.type:
            raise ValueError(f"{model_path} was exported for "
                             f"{exported_on.type}, not {asked.type}")
        device = resolve_device(asked)
        _STATE.update(mode="export", forward=load_program(model_path),
                      manifest=manifest, device=device)
        return int(manifest.get("sample_rate", 16000))

    import yaml

    with open(os.path.join(model_path, "config.yaml")) as f:
        configs = yaml.safe_load(f)
    device = resolve_device(device)
    served = build_served(configs, os.path.join(model_path,
                                                "avg_model.ckpt"), device)
    model_args = configs["model_args"]["tse_model"]
    _STATE.update(mode="eager", forward=served, device=device, manifest={
        "speaker_feat": model_args.get("spk_feat", False),
        "joint_training": model_args.get("joint_training", False),
        "sample_rate": configs["dataset_args"].get("resample_rate", 16000),
    })
    return int(_STATE["manifest"]["sample_rate"])


def expects_fbank() -> bool:
    """Whether `separate` takes fbank cues (a joint model with speaker
    features) rather than waveforms or embeddings."""
    m = _STATE["manifest"]
    return bool(m.get("joint_training")) and bool(m.get("speaker_feat"))


def unload():
    """Drop the model and its tensors; on the card wait for its work and
    return the cached memory (the embedding engine calls this before
    Py_FinalizeEx)."""
    import gc

    import torch

    device = _STATE.get("device")
    _STATE.clear()
    gc.collect()
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _call(mix: np.ndarray, enroll: np.ndarray) -> np.ndarray:
    import torch

    device = _STATE["device"]
    with torch.inference_mode():
        out = _STATE["forward"](torch.from_numpy(mix).to(device),
                                torch.from_numpy(enroll).to(device))
    return out.float().cpu().numpy()


def separate(mix: np.ndarray, enroll1: np.ndarray, enroll2: np.ndarray):
    """mix [T] float32; enroll{1,2} fbank [T', F] or wav [T'] (or an
    embedding) -> est [2, T] float32: the mixture batched twice against
    the two cues, the cues cut to the shorter one's length. An export dir
    fits both to the program's shapes (wrapping what is short, zero rows
    beyond the two)."""
    mix = np.ascontiguousarray(mix, np.float32).reshape(-1)
    t_len = mix.shape[0]
    e1 = np.ascontiguousarray(enroll1, np.float32)
    e2 = np.ascontiguousarray(enroll2, np.float32)
    s = min(e1.shape[0], e2.shape[0])
    enroll = np.stack([e1[:s], e2[:s]])

    if _STATE["mode"] == "export":
        manifest = _STATE["manifest"]
        want_t = manifest["mix_shape"][1]
        want_e = manifest["enroll_shape"]
        mix_b = np.zeros((manifest["mix_shape"][0], want_t), np.float32)
        mix_b[:2] = _fit(mix[None], want_t)
        enroll_b = np.zeros(want_e, np.float32)
        enroll_b[:2] = _fit(enroll, want_e[1])
        return _call(mix_b, enroll_b)[:2, :t_len]
    return _call(np.stack([mix, mix]), enroll)[:, :t_len]


def _fit(x: np.ndarray, length: int):
    """Trim or wrap-pad axis 1 to `length`."""
    if x.shape[1] >= length:
        return x[:, :length]
    reps = length // x.shape[1] + 1
    tiled = np.tile(x, (1, reps) + (1,) * (x.ndim - 2))
    return tiled[:, :length]
