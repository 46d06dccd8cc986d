"""Port parity: the reordered bf16 backward of the LSTM layers.

On the card a bf16 LSTM layer whose shapes `cuda_lstm_tc.backward_fits`
takes runs its backward as four tensor-core kernels: the gate products of
every step, a serial chain over clusters of 4 blocks that carries only dh
(each block's partial over its own gate columns, added in rank order) and
writes the rounded dgates dg, then dx and dW over dg.
`cuda_lstm_tc.split_backward(..., plain=True)` composes the plain versions
of those kernels exactly as the card composes the kernels (the same
cluster partition, 32-row tiles of db and permutations of the unfold
layer's k-major frames). Here that composition stands in for each layer's
backward, and every gradient must agree with the Pallas VJP of the JAX
package in interpret mode (as tests/test_torch_lstm_grad.py runs it) for
all four routes, f32 and bf16, both `reverse` values and a ragged batch.
Also: the route gate's decisions and the ctypes declarations of the new C
entry points.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_lstm_unfold import _c_signature
from wesep_tpu.ops import pallas_lstm
from wesep_tpu_torch.ops import cuda_lstm, cuda_lstm_fused, cuda_lstm_tc
from wesep_tpu_torch.ops import cuda_lstm_unfold

torch.set_num_threads(1)  # one intra-op thread per test worker

H = 64  # a hidden size the chain kernel takes: 4 blocks of 16 units


def _weights(rng, dirs, d, h=H):
    scale = 1.0 / np.sqrt(h)

    def u(*shape):
        return rng.uniform(-scale, scale, shape).astype(np.float32)

    out = []
    for _ in range(dirs):
        out += [u(d, 4 * h), u(4 * h), u(h, 4 * h)]
    return out


def _jax_grads(fn, args, w, bf16):
    """(y as f32, gradients of sum(y * w) as f32) through the Pallas VJP."""
    jargs = [jnp.asarray(a) for a in args]
    if bf16:
        jargs[0] = jargs[0].astype(jnp.bfloat16)

    def loss(*a):
        y = fn(*a).astype(jnp.float32)
        return jnp.sum(y * w[:, :y.shape[1]]), y

    (_, y), grads = jax.value_and_grad(loss, argnums=tuple(range(len(args))),
                                       has_aux=True)(*jargs)
    return np.asarray(y), [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grads(fn, args, w, bf16):
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    x = targs[0].bfloat16() if bf16 else targs[0]
    y = fn(x, *targs[1:])
    (y.float() * torch.from_numpy(w)[:, :y.shape[1]]).sum().backward()
    return y.detach().float().numpy(), [t.grad.float().numpy() for t in targs]


def _compare(got, want, bf16):
    """f32: relative L2 <= 1e-5 per gradient (the same f32 arithmetic, sums
    in another order). bf16: 4 bf16 units in the last place at each
    gradient's largest magnitude, the bound of the existing route tests
    (dgates and dx are rounded at the same points on both sides, and an f32
    sum that differs in its last bit flips such a rounding now and then)."""
    for i, (g, j) in enumerate(zip(got, want)):
        assert g.shape == j.shape, i
        if bf16:
            tol = 4 * 2.0 ** (math.floor(math.log2(np.abs(j).max())) - 7)
            assert np.abs(g - j).max() <= tol, (i, np.abs(g - j).max(), tol)
        else:
            rel = np.linalg.norm(g - j) / max(np.linalg.norm(j), 1e-30)
            assert rel <= 1e-5, (i, rel)


# ---- the fused layer (K0b) ----------------------------------------------------


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b,t", [(8, 10), (5, 7)])  # (5, 7): ragged batch
def test_layer_split_backward_matches_pallas(monkeypatch, b, t, bf16):
    rng = np.random.default_rng(100 + b + 10 * bf16)
    d = 32
    args = [rng.standard_normal((b, t, d)).astype(np.float32) * 0.5,
            *_weights(rng, 2, d)]
    w = rng.standard_normal((b, t, 2 * H)).astype(np.float32)
    monkeypatch.setattr(
        cuda_lstm, "bilstm_layer_backward_reference",
        lambda *a: cuda_lstm_tc.layer_backward(*a, plain=True))
    _, want = _jax_grads(pallas_lstm.bilstm_layer, args, w, bf16)
    _, got = _port_grads(cuda_lstm.bilstm_layer, args, w, bf16)
    _compare(got, want, bf16)


# ---- the unfold-fused layer (K3b) ---------------------------------------------


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("ks,hs,b", [(4, 1, 8), (3, 2, 5)])
def test_unfold_split_backward_matches_pallas(monkeypatch, ks, hs, b, bf16):
    rng = np.random.default_rng(200 + ks + 10 * bf16)
    c, length = 16, 17
    args = [rng.standard_normal((b, length, c)).astype(np.float32),
            *_weights(rng, 2, ks * c)]
    w = rng.standard_normal((b, length, 2 * H)).astype(np.float32)
    monkeypatch.setattr(
        cuda_lstm_unfold, "bilstm_layer_unfold_backward_reference",
        lambda *a: cuda_lstm_tc.unfold_backward(*a, plain=True))
    _, want = _jax_grads(
        lambda *a: pallas_lstm.bilstm_layer_unfold(*a, ks, hs), args, w,
        bf16)
    _, got = _port_grads(
        lambda *a: cuda_lstm_unfold.bilstm_layer_unfold(*a, ks, hs), args, w,
        bf16)
    _compare(got, want, bf16)


# ---- the two-kernel layers (K2b, K1b) -----------------------------------------


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("dirs,reverse,b", [(2, False, 8), (2, False, 5),
                                            (1, False, 8), (1, True, 5)])
def test_fused_split_backward_matches_pallas(monkeypatch, dirs, reverse, b,
                                             bf16):
    rng = np.random.default_rng(300 + b + dirs + 10 * reverse + 20 * bf16)
    d, t = 24, 9
    args = [rng.standard_normal((b, t, d)).astype(np.float32) * 0.5,
            *_weights(rng, dirs, d)]
    w = rng.standard_normal((b, t, dirs * H)).astype(np.float32)
    monkeypatch.setattr(
        cuda_lstm_fused, "_adjoint_reference",
        lambda xw, whs, rev, ys, cs, dys: cuda_lstm_tc.fused_backward(
            xw, whs, ys, cs, dys, rev, plain=True))
    if dirs == 2:
        jax_fn, port_fn = pallas_lstm.bilstm_fused, cuda_lstm_fused.bilstm_fused
    else:
        def jax_fn(*a):
            return pallas_lstm.lstm_fused(*a, reverse)

        def port_fn(*a):
            return cuda_lstm_fused.lstm_fused(*a, reverse)
    _, want = _jax_grads(jax_fn, args, w, bf16)
    _, got = _port_grads(port_fn, args, w, bf16)
    _compare(got, want, bf16)


# ---- the pieces ---------------------------------------------------------------


def test_chain_partition_and_tiles_match_the_step_by_step_adjoint():
    """The plain chain (4 partial products of dh in rank order, db over
    32-row tiles) against the plain two-kernel adjoint, which sums dh and db
    in one product each: f32, 130 rows (five tiles, the last ragged)."""
    rng = np.random.default_rng(7)
    b, t = 130, 5
    xw = torch.from_numpy(rng.standard_normal((2, b, t, 4 * H))
                          .astype(np.float32) * 0.5)
    whs = [torch.from_numpy(w) for w in _weights(rng, 2, 0)[2::3]]
    ys, cs = cuda_lstm_fused.bilstm_fused_reference(xw, *whs, return_cs=True)
    dys = torch.from_numpy(rng.standard_normal((b, t, 2 * H))
                           .astype(np.float32))
    want = cuda_lstm_fused.bilstm_fused_backward_reference(xw, *whs, ys, cs,
                                                           dys)
    got = cuda_lstm_tc.fused_backward(xw, whs, ys, cs, dys, plain=True)
    for g, j in zip(got, want):
        torch.testing.assert_close(g, j, atol=1e-5, rtol=1e-5)


def test_unfold_rows_are_k_major_frames_and_permute_back():
    """gate_rows' x part is the frame in k-major order, and to_k_major maps
    the weights' channel-major rows onto it: A @ Wx is the same product."""
    rng = np.random.default_rng(8)
    ks, hs, c, length, b = 3, 2, 8, 11, 2
    x = torch.from_numpy(rng.standard_normal((b, length, c))
                         .astype(np.float32))
    frames = (length - ks) // hs + 1
    ys = torch.zeros(b, frames, 2 * H)
    spec = cuda_lstm_tc.RowSpec(cuda_lstm_tc.ROW_UNFOLD, ks * c, length, c,
                                hs)
    a = cuda_lstm_tc.gate_rows(x, ys, spec, 2)[0, ..., :ks * c]
    wx = torch.from_numpy(rng.standard_normal((ks * c, 5)).astype(np.float32))
    u = cuda_lstm_unfold.unfold_frames(x, ks, hs)
    torch.testing.assert_close(a @ cuda_lstm_tc.to_k_major(wx, c, ks), u @ wx,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rows,per", [(192512, 38528), (100, 128), (1, 64)])
def test_wgrad_splits_are_aligned_and_cover_the_rows(rows, per):
    """At the pBSRNN's K0b shape 5 slices of 48 tiles of 128 x 128: 240
    blocks, one wave of two blocks on each of 132 SMs."""
    got = cuda_lstm_tc.wgrad_splits(rows, 384, 1024, 2)
    assert got == per and got % 64 == 0
    assert -(-rows // got) * got >= rows


# ---- the route gate -----------------------------------------------------------


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,d,h,rows,c,fits", [
    (BF16, 128, 256, 376 * 512, None, True),    # pBSRNN band, K0b
    (BF16, 128, 256, 32 * 6016, None, True),    # pBSRNN comm, K0b
    (BF16, 0, 256, 376 * 512, None, True),      # pBSRNN, K1b / K2b
    (BF16, 192, 192, 2056 * 68, 48, True),      # TF-GridNet intra, K3b
    (BF16, 192, 192, 568 * 254, 48, True),      # TF-GridNet inter, K3b
    (BF16, 192, 192, 568 * 254, None, True),    # TF-GridNet inter, K0b
    (F32, 128, 256, 376 * 512, None, False),    # f32: today's kernels
    (BF16, 128, 96, 1000, None, False),         # H not 64, 128, 192, 256
    (BF16, 12, 256, 1000, None, False),         # D % 8
    (BF16, 48, 64, 1000, 12, False),            # C % 8
    (BF16, 128, 256, 65535 * 128 + 1, None, False),  # a grid dimension
])
def test_route_gate_decides_from_the_shapes(dtype, d, h, rows, c, fits):
    assert cuda_lstm_tc.backward_fits(dtype, d, h, rows, c=c) is fits


class _Taken(Exception):
    """Raised by the stand-ins of the two backward paths."""


def _stand_in(label):
    def run(*args, **kwargs):
        raise _Taken(label)
    return run


@pytest.mark.parametrize("dtype,hidden,new", [(BF16, 64, True),
                                              (F32, 64, True),
                                              (F32, 96, False),
                                              (BF16, 32, False)])
def test_layer_routes_take_the_gate(monkeypatch, dtype, hidden, new):
    """Each route's card backward asks the gates before any launch: the
    split backward (the tensor-core kernels in bf16, the f32 FMA kernels of
    cuda_lstm_f32 in f32, both through cuda_lstm_tc's compositions) where
    it fits, the route's own kernels otherwise."""
    for name in ("layer_backward", "unfold_backward", "fused_backward"):
        monkeypatch.setattr(cuda_lstm_tc, name, _stand_in("new"))
    monkeypatch.setattr(cuda_lstm, "bilstm_layer_backward", _stand_in("old"))
    monkeypatch.setattr(cuda_lstm_unfold, "bilstm_layer_unfold_backward",
                        _stand_in("old"))
    monkeypatch.setattr(cuda_lstm_fused, "_backward_cuda", _stand_in("old"))
    monkeypatch.setattr(cuda_lstm_fused, "_on_kernel_path", lambda *a: True)
    want = "new" if new else "old"
    b, t, c, ks = 2, 5, 8, 2
    frames = t - ks + 1
    x = torch.zeros(b, t, c, dtype=dtype)

    def weights(d):
        return [torch.zeros(d, 4 * hidden), torch.zeros(4 * hidden),
                torch.zeros(hidden, 4 * hidden)] * 2

    ys = torch.zeros(b, t, 2 * hidden, dtype=dtype)
    yu = ys[:, :frames].contiguous()
    runs = [
        lambda: cuda_lstm._backward_cuda(x, *weights(c), ys, ys.float(), ys),
        lambda: cuda_lstm_unfold._backward_cuda(
            x, *weights(ks * c), yu, yu.float(), yu, ks, 1),
    ]
    flat = weights(c)

    class Ctx:
        plain, reverse = False, False
        saved_tensors = (x, *flat, ys, ys.float())

    runs.append(lambda: cuda_lstm_fused._layer_backward(
        Ctx, cuda_lstm_fused._BIDIRECTIONAL, ys))
    for run in runs:
        with pytest.raises(_Taken) as taken:
            run()
        assert taken.value.args[0] == want


def test_ctypes_declarations_match_the_c_entry_points(monkeypatch):
    """Every wrapper of the tensor-core backward declares, and passes, as
    many pointers and ints as its C entry point in
    csrc/lstm_backward_tc.cu takes."""
    calls = []

    def entry(library, name, n_pointers, n_ints):
        return (library, name, n_pointers, n_ints)

    def launch(counter, fn, tensors, ints, device):
        calls.append((fn, len(tensors), len(ints)))

    monkeypatch.setattr(cuda_lstm_tc, "_entry", entry)
    monkeypatch.setattr(cuda_lstm_tc, "_launch", launch)
    b, t, d = 2, 6, 16
    x = torch.zeros(b, t, d, dtype=BF16)
    ys = torch.zeros(b, t, 2 * H, dtype=BF16)
    wxs = [torch.zeros(d, 4 * H, dtype=BF16)] * 2
    whs = [torch.zeros(H, 4 * H, dtype=BF16)] * 2
    biases = [torch.zeros(4 * H)] * 2
    cuda_lstm_tc.split_backward(x, cuda_lstm_tc.RowSpec(cuda_lstm_tc.ROW_X, d),
                                wxs, biases, whs, ys, ys.float(), ys)
    assert len(calls) == 4
    for (library, name, n_pointers, n_ints), passed_p, passed_i in calls:
        assert (n_pointers, n_ints) == (passed_p, passed_i) \
            == _c_signature(library, name), name
