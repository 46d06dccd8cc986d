"""Port parity: the unfold-fused BiLSTM layer (TF-GridNet's unfold + BiLSTM).

The port's `bilstm_layer_unfold` is an autograd Function whose forward and
backward on the CPU are the plain versions of its CUDA kernels. Its output
and all seven gradients must agree with wesep_tpu.ops.pallas_lstm
.bilstm_layer_unfold (custom VJP, Pallas interpret mode on the CPU) on the
same numpy-seeded inputs, at the sizes and (ks, hs) cases of
tests/test_pallas_lstm.py::test_bilstm_layer_unfold_parity.
"""

import math
import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wesep_tpu.ops.pallas_lstm import (
    bilstm_layer_unfold as jax_bilstm_layer_unfold,
)
from wesep_tpu.ops.rnn import unfold_frames as jax_unfold_frames
from wesep_tpu_torch.models.common import LSTM
from wesep_tpu_torch.ops import cuda_lstm, cuda_lstm_unfold as k
from wesep_tpu_torch.ops.rnn import bilstm_unfold

torch.set_num_threads(1)  # one intra-op thread per test worker

NAMES = ("x", "wx_f", "b_f", "wh_f", "wx_b", "b_b", "wh_b")
CASES = [(4, 1), (2, 1), (4, 2), (3, 3)]


def _inputs(ks, b=8, length=18, c=16, h=32):
    """(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b) in the kernel's order, torch
    LSTM-scale weights (away from saturated gates), and a cotangent
    weight w for the loss sum(y * w)."""
    rng = np.random.default_rng(ks * 10 + length)
    scale = 1.0 / np.sqrt(h)

    def u(*shape):
        return rng.uniform(-scale, scale, shape).astype(np.float32)

    x = rng.standard_normal((b, length, c)).astype(np.float32)
    args = (x, u(ks * c, 4 * h), u(4 * h), u(h, 4 * h),
            u(ks * c, 4 * h), u(4 * h), u(h, 4 * h))
    most = length - ks + 1  # frames at hs 1; a run uses the first T'
    return args, rng.standard_normal((b, most, 2 * h)).astype(np.float32)


def _jax_run(args, w, ks, hs, bf16=False):
    jargs = [jnp.asarray(a) for a in args]
    if bf16:
        jargs[0] = jargs[0].astype(jnp.bfloat16)

    def loss(*a):
        y = jax_bilstm_layer_unfold(*a, ks, hs).astype(jnp.float32)
        return jnp.sum(y * w[:, :y.shape[1]]), y

    (_, y), grads = jax.value_and_grad(loss, argnums=tuple(range(7)),
                                       has_aux=True)(*jargs)
    return y, grads


def _port_run(args, w, ks, hs, bf16=False, fn=k.bilstm_layer_unfold):
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    x = targs[0].bfloat16() if bf16 else targs[0]
    y = fn(x, *targs[1:], ks, hs)
    (y.float() * torch.from_numpy(w)[:, :y.shape[1]]).sum().backward()
    return y.detach().float(), [t.grad for t in targs]


@pytest.mark.parametrize("ks,hs", CASES)
def test_function_matches_pallas_f32(ks, hs):
    """Forward atol 1e-5 and gradients atol 2e-4 (rtol 1e-3), the limits
    tests/test_pallas_lstm.py holds the Pallas kernel itself to against
    unfold + the layer kernel: the same f32 arithmetic, sums in another
    order. Covers hs > 1, where rows of x lie in no frame (dx 0 there)."""
    args, w = _inputs(ks)
    want_y, want = _jax_run(args, w, ks, hs)
    got_y, got = _port_run(args, w, ks, hs)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5,
                               rtol=1e-5)
    for name, g, j in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == j.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=2e-4,
                                   rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("ks,hs", [(4, 1), (4, 2)])
def test_function_matches_pallas_bf16(ks, hs):
    """A bf16 stream with f32 parameters. Taps, h, dgates and each
    direction's frame cotangent are rounded to bf16 at the same points on
    both sides, and the fold adds taps in bf16 in the same order. Where an
    f32 sum differs in its last bit a rounding can flip. Limit (the rule
    of the plain layer's tests): y within 4 bf16 units in the last place
    at its largest magnitude; each gradient within 4 such units at its own
    largest magnitude."""
    args, w = _inputs(ks)
    want_y, want = _jax_run(args, w, ks, hs, bf16=True)
    got_y, got = _port_run(args, w, ks, hs, bf16=True)
    assert want[0].dtype == jnp.bfloat16

    def ulp4(a):
        return 4 * 2.0 ** (math.floor(math.log2(np.abs(a).max())) - 7)

    want_y = np.asarray(want_y)
    assert np.abs(got_y.numpy() - want_y).max() <= ulp4(want_y)
    for name, g, j in zip(NAMES, got, want):
        j = np.asarray(j.astype(jnp.float32))
        assert g.dtype == torch.float32, name  # leaves are f32 parameters
        assert np.abs(g.numpy() - j).max() <= ulp4(j), name


@pytest.mark.parametrize("ks,hs,length", [(4, 1, 18), (4, 2, 19), (3, 3, 17)])
def test_unfold_matches_jax_and_fold_is_its_adjoint(ks, hs, length):
    """unfold_frames is the JAX package's channel-major unfold exactly;
    fold_frames is its adjoint (<unfold(x), u> == <x, fold(u)>), and rows
    in no frame (hs > 1, the tail past (T' - 1) * hs + ks) get zero."""
    rng = np.random.default_rng(length)
    x = rng.standard_normal((3, length, 5)).astype(np.float32)
    frames = k.unfold_frames(torch.from_numpy(x), ks, hs)
    np.testing.assert_array_equal(
        frames.numpy(), np.asarray(jax_unfold_frames(jnp.asarray(x), ks, hs)))
    u = torch.from_numpy(
        rng.standard_normal(tuple(frames.shape)).astype(np.float32))
    folded = k.fold_frames(u, ks, hs, length)
    assert folded.shape == (3, length, 5)
    lhs = (frames.double() * u.double()).sum()
    rhs = (torch.from_numpy(x).double() * folded.double()).sum()
    torch.testing.assert_close(lhs, rhs, rtol=1e-6, atol=1e-6)
    covered = np.zeros(length, bool)
    for t in range(frames.shape[1]):
        covered[t * hs:t * hs + ks] = True
    assert not covered.all() or hs == 1
    assert (folded[:, ~covered] == 0).all()


@pytest.mark.parametrize("ks,hs", [(4, 1), (4, 2)])
def test_backward_matches_autograd_of_plain_forward(ks, hs):
    """The hand-written backward against torch.autograd through the plain
    forward (unfold + plain layer), f32: the same mathematics by another
    route, atol 1e-5."""
    args, w = _inputs(ks, b=5, length=13, c=8, h=16)
    got_y, got = _port_run(args, w, ks, hs)
    want_y, want = _port_run(args, w, ks, hs,
                             fn=k.bilstm_layer_unfold_reference)
    torch.testing.assert_close(got_y, want_y, atol=0, rtol=0)
    for name, g, a in zip(NAMES, got, want):
        torch.testing.assert_close(g, a, atol=1e-5, rtol=1e-5, msg=name)


def test_wgrad_reference_is_the_layers_on_the_frames():
    """The weight-gradient plain version reads the frames of x: it equals
    the plain layer's on unfold_frames(x)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 11, 4)).astype(np.float32))
    ys = torch.from_numpy(rng.standard_normal((3, 4, 16)).astype(np.float32))
    dg = torch.from_numpy(
        rng.standard_normal((2, 3, 4, 32)).astype(np.float32))
    got = k.bilstm_layer_unfold_wgrad_reference(x, ys, dg, 4, 2)
    want = cuda_lstm.bilstm_layer_wgrad_reference(
        k.unfold_frames(x, 4, 2), ys, dg)
    assert got.shape == (2, 16 + 8, 32)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_switch_routes_and_saves_nothing_without_grad(monkeypatch):
    """WESEP_LSTM_UNFOLD=1 takes the unfold-fused layer, anything else the
    unfold + plain layer; on the CPU both run plain versions of the same
    arithmetic, so outputs are identical and gradients agree. Serving (no
    gradient asked) keeps no graph."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 9, 8)).astype(np.float32))
    torch.manual_seed(0)
    module = LSTM(8, 16, unfold_ks=4, unfold_hs=1)
    assert module.wx_f.shape == (32, 64)

    def run():
        for p in module.parameters():
            p.grad = None
        y = module(x)
        y.square().sum().backward()
        return y.detach(), [p.grad.clone() for p in module.parameters()]

    monkeypatch.setenv("WESEP_LSTM_UNFOLD", "1")
    y1, g1 = run()
    with torch.no_grad():
        assert module(x).grad_fn is None
    monkeypatch.setenv("WESEP_LSTM_UNFOLD", "0")
    y0, g0 = run()
    assert y1.shape == (2, 6, 32) and torch.equal(y0, y1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    with pytest.raises(NotImplementedError, match="bidirectional"):
        LSTM(8, 16, bidirectional=False, unfold_ks=4)
    weights = [module.wx_f, module.wh_f, module.b_f,
               module.wx_b, module.wh_b, module.b_b]
    plain = bilstm_unfold(x, *weights, 4, 1, plain=True)
    torch.testing.assert_close(plain.detach(), y0, atol=0, rtol=0)


def _c_signature(library, name):
    """(pointers, ints) of a C entry point in csrc/<library>.cu, before its
    trailing stream argument."""
    path = os.path.join(os.path.dirname(cuda_lstm.__file__), os.pardir,
                        "csrc", library + ".cu")
    with open(path) as f:
        src = f.read()
    found = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src,
                      re.S)
    params = [p.strip() for p in found.group(1).split(",")]
    assert params[-1] == "void* stream", name
    pointers = sum("*" in p for p in params[:-1])
    assert all("*" in p for p in params[:pointers]), name
    return pointers, len(params) - 1 - pointers


def test_ctypes_declarations_match_the_c_entry_points(monkeypatch):
    """Every wrapper of the BiLSTM kernels declares, and passes, as many
    pointers and ints as its C entry point takes (ctypes would refuse a
    call with another count only on the card)."""
    calls = []

    def entry(library, name, n_pointers, n_ints):
        return (library, name, n_pointers, n_ints)

    def launch(counter, fn, tensors, ints, device):
        calls.append((fn, len(tensors), len(ints)))

    for module in (cuda_lstm, k):
        monkeypatch.setattr(module, "_entry", entry)
        monkeypatch.setattr(module, "_launch", launch)
    args, _ = _inputs(4, b=2, length=9, c=8, h=16)
    x, *weights = [torch.from_numpy(a) for a in args]
    ys = torch.zeros(2, 6, 32)
    cs = torch.zeros(2, 6, 32)
    k._forward_cuda(x, *weights, 4, 1, with_cs=True)
    _, _, dg = k.bilstm_layer_unfold_backward(x, *weights, ys, cs, ys, 4, 1)
    k.bilstm_layer_unfold_wgrad(x, ys, dg, 4, 1)
    u = k.unfold_frames(x, 4, 1).contiguous()
    cuda_lstm._forward_cuda(u, *weights, with_cs=True)
    cuda_lstm.bilstm_layer_backward(u, *weights, ys, cs, ys)
    cuda_lstm.bilstm_layer_wgrad(u, ys, dg)
    assert len(calls) == 6
    for (library, name, n_pointers, n_ints), passed_p, passed_i in calls:
        assert (n_pointers, n_ints) == (passed_p, passed_i) \
            == _c_signature(library, name), name
