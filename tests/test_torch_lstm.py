"""Port parity: the fused BiLSTM layer against the JAX package's kernel.

wesep_tpu.ops.pallas_lstm.bilstm_layer runs in Pallas interpret mode on
the CPU (as tests/test_pallas_lstm.py runs it); the port's plain version
bilstm_layer_reference, and rnn.bilstm that dispatches to it for CPU
tensors, must agree with it on the same numpy-seeded inputs.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from wesep_tpu.ops.pallas_lstm import bilstm_layer as jax_bilstm_layer
from wesep_tpu_torch.models.common import LSTM
from wesep_tpu_torch.ops import cuda_lstm, rnn

torch.set_num_threads(1)  # one intra-op thread per test worker


def _inputs(seed, b, t, d=64, h=128):
    """(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b) in the kernel's order."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.2  # noqa
    return (r(b, t, d), r(d, 4 * h), r(4 * h), r(h, 4 * h),
            r(d, 4 * h), r(4 * h), r(h, 4 * h))


@pytest.mark.parametrize("b,t", [(8, 10), (5, 7)])  # (5, 7): ragged batch
def test_bilstm_layer_matches_pallas_interpret(b, t):
    args = _inputs(seed=b, b=b, t=t)
    want = np.asarray(jax_bilstm_layer(*map(jnp.asarray, args)))
    targs = [torch.from_numpy(a) for a in args]
    ref = cuda_lstm.bilstm_layer_reference(*targs)
    x, wx_f, b_f, wh_f, wx_b, b_b, wh_b = targs
    via_rnn = rnn.bilstm(x, wx_f, wh_f, b_f, wx_b, wh_b, b_b)
    assert tuple(ref.shape) == (b, t, 256)
    np.testing.assert_allclose(ref.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(via_rnn.numpy(), want, atol=1e-5, rtol=1e-5)


def test_backward_direction_reads_time_reversed():
    """The backward half on x equals the forward half, with the backward
    weights, on x reversed in time, reversed back."""
    x, wx_f, b_f, wh_f, wx_b, b_b, wh_b = map(
        torch.from_numpy, _inputs(seed=3, b=4, t=9))
    h = wh_f.shape[0]
    y = cuda_lstm.bilstm_layer_reference(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b)
    flipped = cuda_lstm.bilstm_layer_reference(
        x.flip(1), wx_b, b_b, wh_b, wx_f, b_f, wh_f)
    torch.testing.assert_close(y[..., h:], flipped[..., :h].flip(1))
    torch.testing.assert_close(y[..., :h], flipped[..., h:].flip(1))


def test_bf16_keeps_stream_dtype():
    """f32 weights must not promote a bf16 stream. Held to the rule of the
    card checks: 4 units in the last place at the output's largest
    magnitude (h is rounded to bf16 every step)."""
    args = [torch.from_numpy(a) for a in _inputs(seed=4, b=3, t=5)]
    args[0] = args[0].bfloat16()
    y = cuda_lstm.bilstm_layer(*args)
    assert y.dtype == torch.bfloat16
    want = cuda_lstm.bilstm_layer_reference(
        args[0].float(), *[a.bfloat16().float() for a in args[1:]])
    amax = want.abs().max().item()
    tol = 4 * 2.0 ** (math.floor(math.log2(amax)) - 7)  # 8-bit significand
    assert (y.float() - want).abs().max().item() <= tol


def test_wrapper_uses_plain_version_on_cpu_and_raises_elsewhere():
    args = [torch.from_numpy(a) for a in _inputs(seed=5, b=2, t=3)]
    before = cuda_lstm.bilstm_layer.launches
    cuda_lstm.bilstm_layer(*args)
    assert cuda_lstm.bilstm_layer.launches == before  # no kernel on CPU
    with pytest.raises(ValueError):
        cuda_lstm.bilstm_layer(*[a.to("meta") for a in args])


def test_unidirectional_lstm_cpu_only():
    x, wx, b, wh = map(torch.from_numpy, _inputs(seed=6, b=2, t=4)[:4])
    module = LSTM(64, 128, bidirectional=False)
    assert module(x).shape == (2, 4, 128)
    ys = rnn.lstm(x, wx, wh, b)
    bi = cuda_lstm.bilstm_layer_reference(x, wx, b, wh, wx, b, wh)
    torch.testing.assert_close(ys, bi[..., :128])
    with pytest.raises(NotImplementedError):
        rnn.lstm(x.to("meta"), wx, wh, b)
