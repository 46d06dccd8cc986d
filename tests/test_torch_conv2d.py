"""Port parity: the fused DPCCN Conv2dBlock (conv3x3 -> ELU -> IN), forward
and its three gradients.

The port's `conv2d_block_in` is an autograd Function whose forward and
backward on the CPU are the plain versions of the CUDA kernels K5/K5b. On
the same numpy-seeded inputs they must agree with
wesep_tpu.ops.pallas_conv2d.conv2d_block_in (Pallas interpret mode on the
CPU, custom VJP) at the shapes of tests/test_pallas_conv2d.py (T cut where
it does not change the case): odd F, several T chunks, the full-resolution
DPCCN shape class, a wide concat input over a tiny F, and 64 output
channels. Losses use a random target (that file's note: the block's output
is normalised, so a sum of its squares barely depends on the parameters).
"""

import ctypes
import math
import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wesep_tpu.ops.pallas_conv2d import conv2d_block_in as jax_block
from wesep_tpu_torch.models.dpccn import Conv2dBlock
from wesep_tpu_torch.ops import cuda_conv2d as k

torch.set_num_threads(1)  # one intra-op thread per test worker

SHAPES = [
    (50, 37, 8, 16),    # odd F, small Ci
    (130, 65, 48, 32),  # several T chunks of the Pallas kernel
    (40, 257, 16, 16),  # full-resolution DPCCN shape class
    (33, 17, 96, 32),   # wide concat input, tiny F
    (40, 33, 16, 64),   # P = 2 packing of the Pallas kernel
]


def _inputs(t, f, ci, co, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, t, f, ci)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((3, 3, ci, co)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(co) * 0.1).astype(np.float32)
    tgt = rng.standard_normal((2, t, f, co)).astype(np.float32)
    return x, w, b, tgt


def _jax(x, w, b, tgt, bf16=False):
    """y and (dx, dK, db) of sum((y - tgt)^2) through the Pallas kernel,
    f32 numpy. The kernel takes K in the stream's dtype, as the model
    passes it."""
    def loss(x_, w_, b_):
        y = jax_block(x_, w_.astype(x_.dtype), b_).astype(jnp.float32)
        return jnp.sum((y - tgt) ** 2), y

    jx = jnp.asarray(x).astype(jnp.bfloat16 if bf16 else jnp.float32)
    (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jx, jnp.asarray(w), jnp.asarray(b))
    return np.asarray(y), [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port(x, w, b, tgt, bf16=False):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    tx = leaves[0].bfloat16() if bf16 else leaves[0]
    y = k.conv2d_block_in(tx, leaves[1], leaves[2])
    assert y.dtype == tx.dtype and y.shape == (*x.shape[:3], w.shape[-1])
    ((y.float() - torch.from_numpy(tgt)) ** 2).sum().backward()
    return y.detach().float().numpy(), [t.grad.numpy() for t in leaves]


def _bf16_ulps(n, want):
    """n bf16 units in the last place at want's largest magnitude."""
    return n * 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)


@pytest.mark.parametrize("t,f,ci,co", SHAPES)
def test_forward_and_gradients_match_pallas_f32(t, f, ci, co):
    """y within 2e-4 and dx, dK, db within 3e-4 of the reference's largest
    magnitude, the limits tests/test_pallas_conv2d.py holds the Pallas
    kernel to against plain JAX: the same f32 arithmetic, summed in
    another order (measured <= 1.1e-6 for y, dx, dK; db, a near-cancelling
    sum over (T, F), <= 1.7e-5)."""
    x, w, b, tgt = _inputs(t, f, ci, co, seed=t * 7 + ci)
    want_y, want = _jax(x, w, b, tgt)
    got_y, got = _port(x, w, b, tgt)
    np.testing.assert_allclose(got_y, want_y,
                               atol=2e-4 * np.abs(want_y).max(), rtol=0)
    for name, g, j in zip(("dx", "dK", "db"), got, want):
        assert g.dtype == np.float32 and g.shape == j.shape, name
        np.testing.assert_allclose(g, j, atol=3e-4 * np.abs(j).max(), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("t,f,ci,co", [SHAPES[0], SHAPES[3]])
def test_forward_and_gradients_match_pallas_bf16(t, f, ci, co):
    """A bf16 stream with f32 parameters. Both sides round at the same
    points (the statistics over round(e), round(e^2); y once; S_b over
    round(dy * e_hat); dout before db and both products), but the Pallas
    kernel's dK leaves it in P banded copies, each rounded to bf16 and
    added back in bf16 outside the kernel, where the port sums once in
    f32; and a sum that differs in its last f32 bit flips a bf16 rounding
    now and then. Limits: y and dx (bf16 themselves) 2 bf16 units in the
    last place at the largest magnitude (measured <= 1); dK and db 1e-2
    of their largest magnitude (measured <= 5.7e-3: a few units in the
    last place of the banded copies)."""
    x, w, b, tgt = _inputs(t, f, ci, co, seed=3)
    want_y, want = _jax(x, w, b, tgt, bf16=True)
    got_y, got = _port(x, w, b, tgt, bf16=True)
    np.testing.assert_allclose(got_y, want_y, atol=_bf16_ulps(2, want_y),
                               rtol=0)
    for name, g, j in zip(("dx", "dK", "db"), got, want):
        assert g.dtype == np.float32, name  # the leaves are f32
        tol = _bf16_ulps(2, j) if name == "dx" else 1e-2 * np.abs(j).max()
        np.testing.assert_allclose(g, j, atol=tol, rtol=0, err_msg=name)


def test_backward_reference_is_the_adjoint_of_the_forward_reference():
    """The hand-written backward against torch.autograd through the plain
    forward, written with differentiable ops, f32: 1e-4 of each gradient's
    largest magnitude (sum order only)."""
    x, w, b, tgt = _inputs(29, 23, 16, 16, seed=5)
    _, got = _port(x, w, b, tgt)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    y = k.conv2d_block_in_reference(*leaves)
    ((y - torch.from_numpy(tgt)) ** 2).sum().backward()
    for name, g, leaf in zip(("dx", "dK", "db"), got, leaves):
        j = leaf.grad.numpy()
        np.testing.assert_allclose(g, j, atol=1e-4 * np.abs(j).max(),
                                   rtol=0, err_msg=name)


def test_no_gradient_saves_nothing_and_counts_no_launch_on_the_cpu():
    x, w, b, _ = _inputs(9, 11, 8, 16, seed=1)
    before = (k.conv2d_block_in.launches, k.conv2d_block_in_backward.launches)
    args = [torch.from_numpy(a) for a in (x, w, b)]
    with torch.no_grad():
        y = k.conv2d_block_in(*args)
    assert y.grad_fn is None
    y2 = k.conv2d_block_in(*args)  # no input asks for a gradient
    assert y2.grad_fn is None and torch.equal(y, y2)
    assert before == (k.conv2d_block_in.launches,
                      k.conv2d_block_in_backward.launches)
    with pytest.raises(ValueError, match="cuda or cpu"):
        k.conv2d_block_in(args[0].to("meta"), *args[1:])


def test_block_routes_by_the_gates(monkeypatch):
    """Conv2dBlock(conv_impl="pallas") takes the fused block for a plain
    3x3 conv with at most WESEP_CONV2D_CI_GATE input channels unless
    WESEP_CONV2D_PALLAS is "0"; a strided conv never does. On the CPU the
    fused route and conv -> ELU -> instance_norm agree in f32."""
    calls = []
    real = k.conv2d_block_in
    monkeypatch.setattr("wesep_tpu_torch.models.dpccn.conv2d_block_in",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 12, 17, 32))
                         .astype(np.float32))
    torch.manual_seed(0)
    block = Conv2dBlock(32, 16, conv_impl="pallas")
    fused = block(x)
    assert calls == [1]
    monkeypatch.setenv("WESEP_CONV2D_PALLAS", "0")
    off = block(x)
    monkeypatch.setenv("WESEP_CONV2D_PALLAS", "1")
    monkeypatch.setenv("WESEP_CONV2D_CI_GATE", "16")
    gated = block(x)
    assert calls == [1] and torch.equal(off, gated)
    torch.testing.assert_close(fused, off, atol=1e-5, rtol=1e-5)
    monkeypatch.delenv("WESEP_CONV2D_CI_GATE")
    strided = Conv2dBlock(32, 16, stride=(1, 2), conv_impl="pallas")
    assert strided(x).shape == (2, 12, 9, 16) and calls == [1]
    with pytest.raises(ValueError, match="multiples of 8"):
        k._kernel_args(x[..., :12], torch.zeros(3, 3, 12, 16),
                       torch.zeros(16))


def _c_signature(library, name, ret="int"):
    """(pointers, ints, long longs, floats) of a C entry point in
    csrc/<library>.cu, before a trailing stream argument."""
    path = os.path.join(os.path.dirname(k.__file__), os.pardir, "csrc",
                        library + ".cu")
    with open(path) as f:
        src = f.read()
    found = re.search(r'extern "C" ' + ret + " " + name + r"\((.*?)\)\s*\{",
                      src, re.S)
    params = [p.strip() for p in found.group(1).split(",")]
    if params[-1] == "void* stream":
        params = params[:-1]
    kinds = ["ptr" if "*" in p else " ".join(p.split()[:-1]) for p in params]
    assert set(kinds) <= {"ptr", "int", "long long", "float"}, name
    return (kinds.count("ptr"), kinds.count("int"), kinds.count("long long"),
            kinds.count("float"))


def test_ctypes_declarations_match_the_c_entry_points(monkeypatch):
    """Both wrappers declare, and pass, as many pointers, ints, long longs
    and floats as their C entry points take, and size the scratch as the
    plans of the C `_scratch` queries do (ctypes would refuse another count
    only on the card)."""
    calls = []

    class Lib:
        conv2d_block_forward = ("conv2d_block", "conv2d_block_forward")
        conv2d_block_backward = ("conv2d_block_bwd", "conv2d_block_backward")

    def launch(counter, fn, tensors, ints, device):
        n_floats = sum(isinstance(v, float) for v in ints)
        calls.append((fn, len(tensors), len(ints) - n_floats, n_floats))

    monkeypatch.setattr(k, "_library", lambda name: Lib)
    monkeypatch.setattr(k, "_launch", launch)
    monkeypatch.setattr(k, "_slots", lambda ci, co, dtype, device: 132)
    monkeypatch.setattr(k, "_on_kernel_path", lambda plain, x: True)
    x, w, b, _ = _inputs(9, 11, 8, 16, seed=1)
    args = [torch.from_numpy(a) for a in (x, w, b)]
    y, stats = k._forward_cuda(*args, 1e-5)
    k.conv2d_block_in_backward(*args, stats, y)
    assert len(calls) == 2
    for (library, name), n_tensors, n_ints, n_floats in calls:
        ptrs, ints, longs, floats = _c_signature(library, name)
        assert (n_tensors, n_ints, n_floats) == (ptrs, ints + longs, floats)
        kinds = k._argtypes(name)[:-1]
        assert tuple(kinds.count(t) for t in (
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_float)) == (ptrs, ints, longs, floats), name
    for library, name in (("conv2d_block", "conv2d_block_forward_scratch"),
                          ("conv2d_block_bwd",
                           "conv2d_block_backward_scratch")):
        # the queries take the shapes and the dtype (and the dK blocks)
        # and write the two sizes (stream's dtype, f32)
        ptrs, ints, longs, floats = _c_signature(library, name, ret="void")
        assert (ptrs, longs, floats) == (2, 0, 0) and ints in (6, 7), name
