"""Device resolution for the port's entry points.

The port runs on the card: an entry point given no device uses `cuda`, and
raises when no GPU is present. Only an explicit `cpu` runs on the host (the
tests do so, with every kernel's plain version). Nothing falls back quietly.
"""

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """None -> cuda; raise if cuda is asked for and no GPU is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "wesep_tpu_torch runs on an NVIDIA GPU and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
