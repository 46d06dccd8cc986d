"""The JAX package's initial weights, drawn without JAX.

The JAX package initialises a model with `model.init(PRNGKey(seed), ...)`
(wesep_tpu/train/trainer.py `init_train_state`, seed = the config's
`seed`). flax gives each parameter its own key: the root key folded, by
`jax.random.fold_in`, with the first 32 bits of the SHA-1 of its scope's
path and of the count of parameters its scope has created before it and
with it (flax.core.scope.LazyRng); the initialiser then draws from that
key with threefry-2x32. This module does the same in torch, on the host or
on the card, so a port model built from a config starts from the weights
the JAX package builds from it: the same seed gives the same first step in
both packages.

The port names every parameter by its JAX path (utils/jax_params.py), so
a parameter's scope is its dotted name without the last part, and the
count is its place among its module's parameters in the order the module
registers them, which is the order the flax module creates them. A
parameter made by common.uniform_param carries `jax_init = ("uniform",
bound)` and draws U(-bound, bound) as the JAX package's torch-default
initialisers do (`jax.random.uniform`, bit for bit); one of a layer that
keeps flax's default carries `("lecun_normal",)` and draws flax's
`lecun_normal` (`jax.random.truncated_normal` scaled by 1 / fan_in); its
flax bias is zeros, `("zeros",)`. One without `jax_init` holds a constant
(ones, zeros, PReLU's 0.25) and draws nothing, though it still counts. A
parameter whose port layout is not flax's names the flax shape and the map
to its own layout (`jax_shape`, `jax_to_port`).

jax draws the normal and truncated normal through XLA's single-precision
erfinv, whose log and log1p are polynomials of XLA's own: `_erf_inv`
writes them out in f32 torch ops with each fused multiply-add taken in
f64, so the host and the card draw the same values. On the CPU it differs
from jax's in the last bits of a few values in 10^4: by at most 2 units
in the last place for `normal`, 3 for `lecun_normal`
(tests/test_torch_jax_init.py holds that).
"""

import hashlib

import numpy as np
import torch

__all__ = ["seed_key", "fold_in", "fold_in_static", "uniform", "normal",
           "lecun_normal", "init_like_jax", "jax_scope_names"]

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


def _fma(a, b, c):
    """a * b + c rounded once to f32, as XLA's fused multiply-add: the
    product of two f32 values is exact in f64."""
    return (a.double() * b + c).float()


def _poly(x, coeffs):
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


def _f32(*values):
    return [float(np.float32(v)) for v in values]


# XLA's f32 log (a Cephes polynomial as Eigen orders it) and log1p (a
# rational approximation below |x| 0.4142, log(1 + x) above), and its f32
# erfinv (Giles' polynomials in w = -log1p(-x^2), below and above 5)
_LOG_P = _f32(7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
              -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
              2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2, _SQRTHF = _f32(-2.12194440e-4, 0.693359375,
                                 0.707106781186547524)
_LOG1P_NUM = _f32(4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
                  6.5787325942061044846969e0, 2.9911919328553073277375e1,
                  6.0949667980987787057556e1, 5.7112963590585538103336e1,
                  2.0039553499201281259648e1)
_LOG1P_DEN = _f32(1.0, 1.5062909083469192043167e1,
                  8.3047565967967209469434e1, 2.2176239823732856465394e2,
                  3.0909872225312059774938e2, 2.1642788614495947685003e2,
                  6.0118660497603843919306e1)
_ERFINV_LT5 = _f32(2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = _f32(-0.000200214257, 0.000100950558, 0.00134934322,
                   -0.00367342844, 0.00573950773, -0.0076224613,
                   0.00943887047, 1.00167406, 2.83297682)
_SQRT2 = float(np.float32(np.sqrt(2)))
# erf(+-2 / sqrt(2)) in f32 as XLA computes it: the truncated normal's
# uniform bounds for flax's (-2, 2)
_ERF_2 = float(np.float32(0.9544997215270996))
_TRUNC_STD = float(np.float32(0.87962566103423978))


def _log(x):
    """XLA's f32 log of x > 0."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 126).float()
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    low = m < _SQRTHF
    m = m - 1.0 + torch.where(low, m, torch.zeros_like(m))
    e = e - low.float()
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2) * x3
    y = y + e * _LOG_Q1
    m = m - x2 * 0.5
    return (m + y) + e * _LOG_Q2


def _log1p(x):
    """XLA's f32 log1p of x > -1."""
    x2 = x * x
    small = _poly(x, _LOG1P_NUM) / _poly(x, _LOG1P_DEN)
    small = x + _fma(x2, -0.5, (x * x2) * small)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       _log(x + 1.0))


def _erf_inv(x):
    """XLA's f32 erfinv of x in [-1, 1]."""
    w = -_log1p(-(x * x))
    low = w < 5.0
    w = torch.where(low, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(low, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for lt, ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(low, lt, ge))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key, shape, device="cpu") -> torch.Tensor:
    """jax.random.normal(key, shape, float32): sqrt(2) erfinv(u), u the
    uniform draw in [nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return _SQRT2 * _erf_inv(uniform(key, shape, lo, 1.0, device))


def lecun_normal(key, shape, device="cpu") -> torch.Tensor:
    """flax's default kernel init, variance_scaling(1, "fan_in",
    "truncated_normal") of a flax-layout `shape` (fan_in: every axis but
    the last): jax.random.truncated_normal(key, -2, 2) (sqrt(2) erfinv of
    the uniform draw between erf(-+sqrt 2), clipped inside (-2, 2)) times
    sqrt(1 / fan_in) / 0.8796..., each product rounded to f32."""
    fan_in = int(np.prod(shape[:-1], dtype=np.int64))
    std = np.float32(np.sqrt(np.float32(1.0 / fan_in))) / np.float32(
        _TRUNC_STD)
    u = uniform(key, shape, -_ERF_2, _ERF_2, device)
    edge = float(np.nextafter(np.float32(2.0), np.float32(0.0)))
    return (_SQRT2 * _erf_inv(u)).clamp(-edge, edge) * float(std)


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
        key = fold_in_static(root, scope + (counts[scope],))
        shape = getattr(param, "jax_shape", tuple(param.shape))
        if kind[0] == "uniform":
            value = uniform(key, shape, -kind[1], kind[1], device or "cpu")
        elif kind[0] == "lecun_normal":
            value = lecun_normal(key, shape, device or "cpu")
        else:
            value = torch.zeros(shape)
        to_port = getattr(param, "jax_to_port", None)
        with torch.no_grad():
            param.copy_(value if to_port is None else to_port(value))
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
