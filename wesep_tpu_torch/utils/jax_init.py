"""The JAX package's initial weights, drawn without JAX.

The JAX package initialises a model with `model.init(PRNGKey(seed), ...)`
(wesep_tpu/train/trainer.py `init_train_state`, seed = the config's
`seed`). flax gives each parameter its own key: the root key folded, by
`jax.random.fold_in`, with the first 32 bits of the SHA-1 of its scope's
path and of the count of parameters its scope has created before it and
with it (flax.core.scope.LazyRng); the initialiser then draws from that
key with threefry-2x32 (`jax.random.uniform`). This module does the same
in numpy, so a port model built from a config starts from the weights the
JAX package builds from it, bit for bit: the same seed gives the same
first step in both packages.

The port names every parameter by its JAX path (utils/jax_params.py), so
a parameter's scope is its dotted name without the last part, and the
count is its place among its module's parameters in the order the module
registers them, which is the order the flax module creates them. A
parameter made by common.uniform_param carries `jax_init = ("uniform",
bound)` and draws U(-bound, bound) as the JAX package's torch-default
initialisers do; one without it holds a constant (ones, zeros, PReLU's
0.25) and draws nothing, though it still counts. The speaker encoders'
layers that keep flax's default lecun_normal in the JAX package draw the
uniform of torch's default here, so those weights are not the JAX
package's (ROADMAP.md C.5 (d)).
"""

import hashlib

import numpy as np
import torch

__all__ = ["seed_key", "fold_in", "fold_in_static", "uniform",
           "init_like_jax", "jax_scope_names"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_M32 = 0xFFFFFFFF


def _threefry2x32(key, x0, x1):
    """threefry-2x32 (20 rounds) of the counter pairs (x0, x1), int64
    tensors holding uint32 values, under `key`, as jax.random computes it."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def seed_key(seed: int):
    """jax.random.PRNGKey(seed)'s two words."""
    return (seed >> 32) & _M32, seed & _M32


def fold_in(key, data: int):
    """jax.random.fold_in(key, data)."""
    a, b = _threefry2x32(key, torch.zeros(1, dtype=torch.int64),
                         torch.tensor([data], dtype=torch.int64))
    return int(a), int(b)


def fold_in_static(key, suffix):
    """flax's LazyRng: `key` folded with the SHA-1 of the path parts
    (strings as UTF-8, ints big-endian in their fewest bytes)."""
    if not suffix:
        return key
    m = hashlib.sha1()
    for part in suffix:
        if isinstance(part, str):
            m.update(part.encode("utf-8"))
        else:
            m.update(part.to_bytes((part.bit_length() + 7) // 8, "big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], "big"))


def uniform(key, shape, low: float, high: float,
            device="cpu") -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, low, high) on `device` (on
    the card ~100x faster than on the host for a model of tens of millions
    of parameters): the partitionable 32-bit draw of each flat index, its
    23 high bits as a float in [1, 2), then scale and shift rounded once,
    as XLA's fused multiply-add does."""
    idx = torch.arange(int(np.prod(shape, dtype=np.int64)),
                       dtype=torch.int64, device=device)
    b0, b1 = _threefry2x32(key, idx >> 32, idx & _M32)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    unit = bits.to(torch.int32).view(torch.float32) - 1.0
    low32, high32 = np.float32(low), np.float32(high)
    out = (unit.double() * float(high32 - low32) + float(low32)).float()
    return out.clamp_min(float(low32)).reshape(shape)


def init_like_jax(model: torch.nn.Module, seed: int, scope_names=None,
                  device=None) -> torch.nn.Module:
    """Fill `model`'s parameters in place with the JAX package's initial
    weights of the same model at `seed`, drawn on `device` (default: the
    host); `scope_names` maps a port scope name to the JAX one where they
    differ (a rematerialised block's `Checkpoint` prefix)."""
    root = seed_key(seed)
    counts = {}
    scope_names = scope_names or {}
    for name, param in model.named_parameters():
        *scope, _ = name.split(".")
        scope = tuple(scope_names.get(s, s) for s in scope)
        counts[scope] = counts.get(scope, 0) + 1
        kind = getattr(param, "jax_init", None)
        if kind is None:
            continue
        _, bound = kind
        key = fold_in_static(root, scope + (counts[scope],))
        with torch.no_grad():
            param.copy_(uniform(key, tuple(param.shape), -bound, bound,
                                device or "cpu"))
    return model


def jax_scope_names(model: torch.nn.Module) -> dict:
    """Port scope names that the JAX model calls otherwise: under `remat`
    flax names ConvTasNet's TCN blocks `CheckpointTCNBlock_{i}` (the port,
    `TCNBlock_{i}`; utils/jax_params.py)."""
    if not getattr(model, "remat", False):
        return {}
    return {part: "Checkpoint" + part
            for name, _ in model.named_parameters()
            for part in name.split(".") if part.startswith("TCNBlock_")}
