"""Checkpoint bundles: one `torch.save` file per checkpoint.

Counterpart of wesep_tpu/train/checkpoint.py with the same bundle layout,
{"models": [state_dict, ...], "step": n}: the generator first, a
discriminator second where there is one. Optimizer state joins the bundle
with the training slice; reading the JAX package's msgpack bundles is a
later item of ROADMAP.md.
"""

import os
from typing import Dict, List

import torch

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(path: str, models: List[Dict[str, torch.Tensor]],
                    step: int = 0):
    """Write {"models": [...], "step": step} atomically to `path`."""
    bundle = {
        "models": [{k: v.detach().cpu() for k, v in m.items()}
                   for m in models],
        "step": int(step),
    }
    tmp = path + ".tmp"
    torch.save(bundle, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    """Load a bundle written by save_checkpoint (tensors on the CPU)."""
    return torch.load(path, map_location="cpu", weights_only=True)
