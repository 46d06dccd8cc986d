"""Port parity: gradients of the fused BiLSTM layer.

The port's `bilstm_layer` is an autograd Function whose backward on the CPU
is the plain version of the backward kernel. Its gradients must agree with
`jax.grad` of wesep_tpu.ops.pallas_lstm.bilstm_layer (custom VJP, Pallas
interpret mode on the CPU) for the loss sum(y * w) with a seeded w, on the
same numpy-seeded inputs, and with torch.autograd through the plain forward.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wesep_tpu.ops.pallas_lstm import bilstm_layer as jax_bilstm_layer
from wesep_tpu_torch.models.common import LSTM
from wesep_tpu_torch.ops import cuda_lstm

torch.set_num_threads(1)  # one intra-op thread per test worker

NAMES = ("x", "wx_f", "b_f", "wh_f", "wx_b", "b_b", "wh_b")


def _inputs(seed, b, t, d=64, h=128):
    """((x, wx_f, b_f, wh_f, wx_b, b_b, wh_b), w) in the kernel's order."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.2  # noqa
    args = (r(b, t, d), r(d, 4 * h), r(4 * h), r(h, 4 * h),
            r(d, 4 * h), r(4 * h), r(h, 4 * h))
    return args, r(b, t, 2 * h)


def _jax_grads(args, w, bf16=False):
    jargs = [jnp.asarray(a) for a in args]
    if bf16:
        jargs[0] = jargs[0].astype(jnp.bfloat16)
    grads = jax.grad(
        lambda *a: jnp.sum(jax_bilstm_layer(*a).astype(jnp.float32) * w),
        argnums=tuple(range(7)))(*jargs)
    return grads


def _port_grads(args, w, bf16=False, fn=cuda_lstm.bilstm_layer):
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    x = targs[0].bfloat16() if bf16 else targs[0]
    y = fn(x, *targs[1:])
    (y.float() * torch.from_numpy(w)).sum().backward()
    return [t.grad for t in targs]


@pytest.mark.parametrize("b,t", [(8, 10), (5, 7)])  # (5, 7): ragged batch
def test_function_gradients_match_jax_grad_f32(b, t):
    """atol 1e-5 at gradients of magnitude 0.4 to 4: both sides do the same
    f32 arithmetic step by step and differ only in the order of sums."""
    args, w = _inputs(seed=b, b=b, t=t)
    want = _jax_grads(args, w)
    got = _port_grads(args, w)
    for name, g, j in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == j.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_function_gradients_match_jax_grad_bf16():
    """A bf16 stream with f32 parameters. dgates, dh and dx are rounded to
    bf16 at the same points on both sides, so most elements agree exactly;
    where an f32 sum differs in its last bit a rounding can flip, and the
    flip moves one term by a bf16 unit. Limit: 4 bf16 units in the last
    place at each gradient's largest magnitude (dx is itself bf16; the f32
    weight gradients sum up to 80 such terms)."""
    args, w = _inputs(seed=8, b=8, t=10)
    want = _jax_grads(args, w, bf16=True)
    got = _port_grads(args, w, bf16=True)
    assert want[0].dtype == jnp.bfloat16
    for name, g, j in zip(NAMES, got, want):
        j = np.asarray(j.astype(jnp.float32))
        assert g.dtype == torch.float32, name  # leaves are f32 parameters
        tol = 4 * 2.0 ** (math.floor(math.log2(np.abs(j).max())) - 7)
        assert np.abs(g.numpy() - j).max() <= tol, name


@pytest.mark.parametrize("b,t", [(8, 10), (5, 7)])
def test_function_gradients_match_autograd_of_plain_forward(b, t):
    """The hand-written backward against torch.autograd through the plain
    forward, f32: the same mathematics by another route, atol 1e-5."""
    args, w = _inputs(seed=20 + b, b=b, t=t)
    got = _port_grads(args, w)
    want = _port_grads(args, w, fn=cuda_lstm.bilstm_layer_reference)
    for name, g, a in zip(NAMES, got, want):
        torch.testing.assert_close(g, a, atol=1e-5, rtol=1e-5, msg=name)


def test_forward_reference_returns_cell_states():
    args, _ = _inputs(seed=1, b=3, t=6)
    targs = [torch.from_numpy(a) for a in args]
    ys, cs = cuda_lstm.bilstm_layer_reference(*targs, return_cs=True)
    assert cs.shape == ys.shape == (3, 6, 256) and cs.dtype == torch.float32
    torch.testing.assert_close(ys, cuda_lstm.bilstm_layer_reference(*targs))
    # h = o * tanh(c): |h| <= |tanh(c)| everywhere
    assert (ys.abs() <= cs.tanh().abs() + 1e-6).all()


def test_function_saves_nothing_without_grad():
    """Serving: no gradient asked, so no cell states are kept and the
    output carries no graph; a weight that needs a gradient brings both."""
    args, _ = _inputs(seed=2, b=2, t=3)
    targs = [torch.from_numpy(a) for a in args]
    assert cuda_lstm.bilstm_layer(*targs).grad_fn is None
    targs[3].requires_grad_()
    assert cuda_lstm.bilstm_layer(*targs).grad_fn is not None
    with torch.no_grad():
        assert cuda_lstm.bilstm_layer(*targs).grad_fn is None


def test_lstm_module_plain_flag_and_train_mode_change_nothing_on_cpu():
    """LSTM.plain picks the plain versions, which the CPU runs anyway, and
    train() changes nothing: outputs and gradients are identical."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 5, 16)).astype(np.float32))
    torch.manual_seed(0)
    module = LSTM(16, 32)

    def run():
        for p in module.parameters():
            p.grad = None
        y = module(x)
        y.square().sum().backward()
        return y.detach(), [p.grad.clone() for p in module.parameters()]

    y0, g0 = run()
    module.plain = True
    module.eval()
    y1, g1 = run()
    assert torch.equal(y0, y1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
