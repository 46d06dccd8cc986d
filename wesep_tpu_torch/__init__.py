"""PyTorch/CUDA port of wesep_tpu for NVIDIA Hopper (H100).

The JAX package `wesep_tpu` is the reference; this package imports nothing
of it and nothing of JAX. Entry points run on `cuda` unless the caller asks
for `cpu` (see `device.resolve_device`). Kernels written by hand for
sm_90a live in `csrc/` and are built with nvcc at first use.
"""

from wesep_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
