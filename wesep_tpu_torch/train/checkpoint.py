"""Checkpoint bundles: one `torch.save` file per checkpoint.

Counterpart of wesep_tpu/train/checkpoint.py with the same bundle layout,
{"models": [...], "opt_states": [...], "batch_stats": [...], "step": n,
"extra": {...}}: the generator first, a discriminator second where there
is one. A model's entry in "models" holds its parameters and its entry in
"batch_stats" its buffers (the BatchNorm running statistics), both by
state_dict name, as the JAX bundle keeps `params` and `batch_stats` apart:
averaging takes the mean of the parameters and the newest checkpoint's
statistics. An optimizer state is what `trainer.Optimizer.state_dict()`
gives. Bundles that hold only "models" and "step" load as well. Reading the JAX package's msgpack bundles is a
later item of ROADMAP.md.
"""

import os
import re
from typing import Dict, List, Optional

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "split_state",
           "model_state", "load_pretrained_model", "restore_train_state",
           "find_epoch_checkpoints", "average_checkpoints"]


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def save_checkpoint(path: str, models: List[Dict[str, torch.Tensor]],
                    opt_states: Optional[List[dict]] = None,
                    batch_stats: Optional[List[dict]] = None,
                    step: int = 0, extra: Optional[dict] = None):
    """Write the bundle atomically to `path`."""
    bundle = {
        "models": [_to_host(m) for m in models],
        "opt_states": [_to_host(o) for o in (opt_states or [])],
        "batch_stats": [_to_host(b) for b in (batch_stats or [])],
        "step": int(step),
        "extra": extra or {},
    }
    tmp = path + ".tmp"
    torch.save(bundle, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    """Load a bundle written by save_checkpoint (tensors on the CPU)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def split_state(model: torch.nn.Module):
    """(parameters, buffers) of a model's state_dict, by name."""
    state = model.state_dict()
    params = {name for name, _ in model.named_parameters()}
    return ({k: v for k, v in state.items() if k in params},
            {k: v for k, v in state.items() if k not in params})


def model_state(bundle: dict, model_index: int = 0) -> dict:
    """The state_dict of bundle model i: its parameters and, where the
    bundle has them, its buffers."""
    state = dict(bundle["models"][model_index])
    stats = bundle.get("batch_stats") or []
    if len(stats) > model_index:
        state.update(stats[model_index])
    return state


def load_pretrained_model(model: torch.nn.Module, path: str,
                          model_index: int = 0) -> torch.nn.Module:
    """Load bundle model i into `model` in place, by name; names the
    bundle lacks keep their values."""
    model.load_state_dict(model_state(load_checkpoint(path), model_index),
                          strict=False)
    return model


def restore_train_state(state, path: str, model_index: int = 0):
    """Fill a trainer.TrainState from a bundle (resume training): the
    parameters and buffers, the optimizer state where the bundle has one,
    the step."""
    bundle = load_checkpoint(path)
    state.model.load_state_dict(model_state(bundle, model_index))
    if bundle.get("opt_states"):
        state.optimizer.load_state_dict(bundle["opt_states"][model_index])
    state.step = int(bundle.get("step", 0))
    return state


def find_epoch_checkpoints(model_dir: str):
    """[(epoch, path)] for checkpoint_<N>.ckpt files, sorted by epoch."""
    out = []
    for name in os.listdir(model_dir):
        m = re.match(r"checkpoint_(\d+)\.ckpt$", name)
        if m:
            out.append((int(m.group(1)), os.path.join(model_dir, name)))
    return sorted(out)


def average_checkpoints(paths: List[str], model_index: int = 0):
    """Uniform average of the parameters over checkpoints: summed in f64,
    returned in f32."""
    if not paths:
        raise ValueError("no checkpoints to average")
    acc = None
    for p in paths:
        params = load_checkpoint(p)["models"][model_index]
        flat = {k: v.double() for k, v in params.items()}
        acc = flat if acc is None else {k: acc[k] + flat[k] for k in acc}
    return {k: (v / float(len(paths))).float() for k, v in acc.items()}
