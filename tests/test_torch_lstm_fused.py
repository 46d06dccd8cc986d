"""Port parity: the two-kernel LSTM layers against the JAX package's.

wesep_tpu.ops.pallas_lstm.bilstm_fused (the `_bi_forward`/`_bi_backward`
kernels) and lstm_fused (`_forward`/`_bwd_impl`) run in Pallas interpret
mode on the CPU, as tests/test_pallas_lstm.py runs them. The port's
`cuda_lstm_fused.bilstm_fused` and `lstm_fused` are autograd Functions
whose forward and backward on CPU tensors are the kernels' plain versions;
forward and gradients of sum(y * w) must agree on the same numpy-seeded
inputs. Also: the ctypes declarations against the C entry points, and the
route gates of ops/rnn.py, which send a layer that its kernels do not take
to the scan.
"""

import math
import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wesep_tpu.ops import pallas_lstm
from wesep_tpu_torch.ops import cuda_lstm, rnn
from wesep_tpu_torch.ops import cuda_lstm_fused as k

torch.set_num_threads(1)  # one intra-op thread per test worker

BI_NAMES = ("x", "wx_f", "b_f", "wh_f", "wx_b", "b_b", "wh_b")
UNI_NAMES = ("x", "wx", "b", "wh")


def _inputs(seed, b, t, dirs, d=32, h=64):
    """((x, then wx, b, wh per direction), w) in the layers' order."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.2  # noqa
    args = [r(b, t, d)]
    for _ in range(dirs):
        args += [r(d, 4 * h), r(4 * h), r(h, 4 * h)]
    return args, r(b, t, dirs * h)


def _jax_fn(dirs, reverse):
    if dirs == 2:
        return pallas_lstm.bilstm_fused
    return lambda x, wx, b, wh: pallas_lstm.lstm_fused(x, wx, b, wh, reverse)


def _port_fn(dirs, reverse):
    if dirs == 2:
        return k.bilstm_fused
    return lambda x, wx, b, wh: k.lstm_fused(x, wx, b, wh, reverse)


def _jax_run(args, w, dirs, reverse, bf16=False):
    """(y, gradients of sum(y * w)) through the Pallas kernels."""
    fn = _jax_fn(dirs, reverse)
    jargs = [jnp.asarray(a) for a in args]
    if bf16:
        jargs[0] = jargs[0].astype(jnp.bfloat16)
    y = fn(*jargs)
    grads = jax.grad(
        lambda *a: jnp.sum(fn(*a).astype(jnp.float32) * w),
        argnums=tuple(range(len(args))))(*jargs)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return f32(y), [f32(g) for g in grads], [g.dtype for g in grads]


def _port_run(args, w, dirs, reverse, bf16=False, fn=None):
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    x = targs[0].bfloat16() if bf16 else targs[0]
    y = (fn or _port_fn(dirs, reverse))(x, *targs[1:])
    (y.float() * torch.from_numpy(w)).sum().backward()
    return y, [t.grad for t in targs]


CASES = [(2, False, 8, 10), (2, False, 5, 7),  # (5, 7): ragged batch
         (1, False, 8, 10), (1, True, 8, 10), (1, True, 5, 7)]


@pytest.mark.parametrize("dirs,reverse,b,t", CASES)
def test_layer_matches_pallas_f32(dirs, reverse, b, t):
    """Forward and every gradient, atol 1e-5 (the K0 tests' bound): both
    sides do the same f32 arithmetic step by step and differ only in the
    order of sums."""
    args, w = _inputs(seed=10 * b + dirs + reverse, b=b, t=t, dirs=dirs)
    want_y, want, _ = _jax_run(args, w, dirs, reverse)
    y, got = _port_run(args, w, dirs, reverse)
    assert tuple(y.shape) == want_y.shape == (b, t, dirs * 64)
    np.testing.assert_allclose(y.detach().numpy(), want_y, atol=1e-5,
                               rtol=1e-5)
    names = BI_NAMES if dirs == 2 else UNI_NAMES
    assert len(got) == len(want) == len(names)
    for name, g, j in zip(names, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == j.shape, name
        np.testing.assert_allclose(g.numpy(), j, atol=1e-5, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("dirs,reverse", [(2, False), (1, False), (1, True)])
def test_layer_matches_pallas_bf16(dirs, reverse):
    """A bf16 stream with f32 parameters: y, dx and the rounded dgates are
    bf16 on both sides and rounded at the same points, so an f32 sum that
    differs in its last bit flips a rounding now and then. Limit: 4 bf16
    units in the last place at the largest magnitude of y and of each
    gradient. The unidirectional layer rounds dWh to bf16 (as
    pallas_lstm._bwd_impl returns it), the bidirectional one does not."""
    args, w = _inputs(seed=30 + dirs + reverse, b=8, t=10, dirs=dirs)
    want_y, want, dtypes = _jax_run(args, w, dirs, reverse, bf16=True)
    y, got = _port_run(args, w, dirs, reverse, bf16=True)
    assert y.dtype == torch.bfloat16 and dtypes[0] == jnp.bfloat16
    names = BI_NAMES if dirs == 2 else UNI_NAMES
    for name, g, j in zip(("y",) + names, [y.detach()] + got,
                          [want_y] + want):
        tol = 4 * 2.0 ** (math.floor(math.log2(np.abs(j).max())) - 7)
        assert np.abs(g.float().numpy() - j).max() <= tol, name
    dwh = got[-1]
    assert dwh.dtype == torch.float32
    assert torch.equal(dwh, dwh.bfloat16().float()) == (dirs == 1)


@pytest.mark.parametrize("dirs,reverse", [(2, False), (1, True)])
def test_backward_matches_autograd_of_plain_forward(dirs, reverse):
    """The hand-written plain backward against torch.autograd through the
    plain forward (project, then the step-by-step recurrence), f32."""
    args, w = _inputs(seed=50 + dirs, b=5, t=6, dirs=dirs, d=12, h=16)

    def plain(x, *flat):
        xw = torch.stack([k.project(x, flat[i], flat[i + 1])
                          for i in range(0, len(flat), 3)])
        return k._recurrence_reference(xw, flat[2::3], reverse, False)

    _, got = _port_run(args, w, dirs, reverse)
    _, want = _port_run(args, w, dirs, reverse, fn=plain)
    for g, a in zip(got, want):
        torch.testing.assert_close(g, a, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dirs,reverse", [(2, False), (1, False), (1, True)])
def test_wgrad_reference_is_the_adjoints_dwh(dirs, reverse):
    """The weight-gradient kernel's plain version, h_{t-1}^T @ dxw with
    h_{t-1} read from ys one step back or on, gives the adjoint's dWh."""
    args, _ = _inputs(seed=60 + dirs, b=3, t=5, dirs=dirs, d=8, h=16)
    x, *flat = [torch.from_numpy(a) for a in args]
    xw = torch.stack([k.project(x, flat[i], flat[i + 1])
                      for i in range(0, len(flat), 3)])
    ys, cs = k._recurrence_reference(xw, flat[2::3], reverse, True)
    dys = torch.from_numpy(np.random.default_rng(0).standard_normal(
        ys.shape).astype(np.float32))
    dxw, dwh, db = k._adjoint_reference(xw, flat[2::3], reverse, ys, cs, dys)
    assert dxw.shape == xw.shape and db.shape == (dirs, 64)
    torch.testing.assert_close(k.lstm_fused_wgrad_reference(ys, dxw, reverse),
                               dwh, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(db, dxw.sum(dim=(1, 2)), atol=1e-5, rtol=1e-5)


def test_saves_nothing_without_grad_and_raises_off_cpu_and_cuda():
    """Serving keeps no graph and no cell states; a weight that needs a
    gradient brings the graph; a device that is neither CPU nor CUDA
    raises; the CPU runs the plain versions and launches nothing."""
    args, _ = _inputs(seed=2, b=2, t=3, dirs=2, d=8, h=16)
    targs = [torch.from_numpy(a) for a in args]
    before = k.bilstm_fused_forward.launches
    assert k.bilstm_fused(*targs).grad_fn is None
    targs[3].requires_grad_()
    assert k.bilstm_fused(*targs).grad_fn is not None
    with torch.no_grad():
        assert k.bilstm_fused(*targs).grad_fn is None
    assert k.bilstm_fused_forward.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        k.lstm_fused(*[a.detach().to("meta") for a in targs[:4]])


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
    """Every wrapper of the two-kernel layers declares, and passes, as many
    pointers and ints as its C entry point takes (ctypes would refuse a
    call with another count only on the card)."""
    calls = []

    def entry(library, name, n_pointers, n_ints):
        return (library, name, n_pointers, n_ints)

    def launch(counter, fn, tensors, ints, device):
        calls.append((fn, len(tensors), len(ints)))

    monkeypatch.setattr(k, "_entry", entry)
    monkeypatch.setattr(k, "_launch", launch)
    wh = torch.zeros(16, 64)
    for dirs in (1, 2):
        xw = torch.zeros(dirs, 2, 5, 64)
        ys = cs = torch.zeros(2, 5, dirs * 16)
        whs = [wh] * dirs
        k._forward_cuda(k.lstm_fused_forward, xw, whs, False, True)
        k._backward_cuda(k.lstm_fused_backward, xw, whs, False, ys, cs, ys)
        k._wgrad_cuda(k.lstm_fused_wgrad, ys, xw, False)
    assert len(calls) == 6
    for (library, name, n_pointers, n_ints), passed_p, passed_i in calls:
        assert (n_pointers, n_ints) == (passed_p, passed_i) \
            == _c_signature(library, name), name


def _spy(monkeypatch, module, name, calls=None):
    """Count calls of module.name in `calls` (a new list by default),
    passing them through."""
    calls = [] if calls is None else calls
    real = getattr(module, name)

    def counted(*a, **kw):
        calls.append(name)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def _weights(rng, d, h):
    r = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32) * 0.2)
    return r(d, 4 * h), r(h, 4 * h), r(4 * h)


def _scan_bilstm(x, wx_f, wh_f, b_f, wx_b, wh_b, b_b):
    return torch.cat([rnn.lstm_scan(x, wx_f, wh_f, b_f),
                      rnn.lstm_scan(x, wx_b, wh_b, b_b, reverse=True)], -1)


# (D, H) -> the layer each route takes: the fused layer (K0) needs D % 4 ==
# 0, H % 4 == 0 and H <= 256, the two-kernel layer (K2) only the limits on H
# (its projection is a library product), so it takes the shapes whose D
# alone K0 refuses; the H outside both go to the scan
ROUTES = {"1": [((8, 16), "bilstm_layer"), ((6, 16), "bilstm_fused")],
          "0": [((8, 16), "bilstm_fused"), ((6, 16), "bilstm_fused")]}
OUTSIDE = [(8, 18), (8, 260)]


@pytest.mark.parametrize("layer", ["1", "0"])
def test_bilstm_gate_sends_other_shapes_to_the_scan(monkeypatch, layer):
    """ops/rnn.bilstm on WESEP_LSTM_LAYER=1 (K0) and =0 (K2): a shape the
    route's kernels take goes to its layer, one with an H that K0 takes
    but a D that it does not to K2, any other to the scan in both
    directions, decided from the shapes alone; the scan agrees with the
    layers' plain versions where both apply."""
    monkeypatch.setenv("WESEP_LSTM_LAYER", layer)
    rng = np.random.default_rng(3)
    calls = _spy(monkeypatch, rnn, "bilstm_layer")
    _spy(monkeypatch, rnn, "bilstm_fused", calls)
    x = torch.from_numpy(rng.standard_normal((2, 4, 8)).astype(np.float32))
    for (d, h), target in ROUTES[layer] + [(s, None) for s in OUTSIDE]:
        ws = _weights(rng, d, h) + _weights(rng, d, h)
        before = len(calls)
        y = rnn.bilstm(x[..., :d], *ws)
        assert y.shape == (2, 4, 2 * h)
        torch.testing.assert_close(y, _scan_bilstm(x[..., :d], *ws),
                                   atol=1e-6, rtol=1e-6)
        assert calls[before:] == ([target] if target else [])


def test_lstm_gate_sends_other_shapes_to_the_scan(monkeypatch):
    """ops/rnn.lstm: the two-kernel layer (K1) where H % 4 == 0 and
    H <= 256, else the scan; both directions of time."""
    rng = np.random.default_rng(4)
    calls = _spy(monkeypatch, rnn, "lstm_fused")
    x = torch.from_numpy(rng.standard_normal((3, 5, 6)).astype(np.float32))
    for reverse in (False, True):
        wx, wh, b = _weights(rng, 6, 16)
        torch.testing.assert_close(
            rnn.lstm(x, wx, wh, b, reverse),
            rnn.lstm_scan(x, wx, wh, b, reverse), atol=1e-6, rtol=1e-6)
    assert calls == ["lstm_fused"] * 2
    for h in (18, 260):
        wx, wh, b = _weights(rng, 6, h)
        assert rnn.lstm(x, wx, wh, b).shape == (3, 5, h)
    assert calls == ["lstm_fused"] * 2


def test_bilstm_unfold_gate_sends_other_shapes_to_the_plain_route(
        monkeypatch):
    """ops/rnn.bilstm_unfold on WESEP_LSTM_UNFOLD=1: the unfold-fused layer
    (K3) where ks * C % 4 == 0 and its H limits hold, else unfold + bilstm,
    whose own gate then picks the scan."""
    monkeypatch.setenv("WESEP_LSTM_UNFOLD", "1")
    rng = np.random.default_rng(5)
    unfold = _spy(monkeypatch, rnn, "bilstm_layer_unfold")
    layer = _spy(monkeypatch, rnn, "bilstm_layer")
    x = torch.from_numpy(rng.standard_normal((2, 9, 3)).astype(np.float32))
    ws = _weights(rng, 12, 16) + _weights(rng, 12, 16)
    rnn.bilstm_unfold(x, *ws, 4, 1)
    assert unfold == ["bilstm_layer_unfold"] and not layer
    ws = _weights(rng, 9, 16) + _weights(rng, 9, 16)
    y = rnn.bilstm_unfold(x, *ws, 3, 1)  # ks * C = 9
    assert unfold == ["bilstm_layer_unfold"] and not layer
    torch.testing.assert_close(
        y, _scan_bilstm(rnn.unfold_frames(x, 3, 1), *ws))
