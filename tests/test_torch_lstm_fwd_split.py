"""Port parity: the split bf16 forward of the LSTM layers.

On the card a bf16 LSTM layer whose shapes `cuda_lstm_tc.forward_fits`
takes runs its forward as two tensor-core kernels: the input projection xw
= x @ Wx + b of every step (the layers that project x; the two-kernel
layers bring xw themselves) and a recurrence over clusters of 4 blocks,
each block computing the gate columns of its own H / 4 units from the
whole h_{t-1}, with h rounded to bf16 where it enters the next product and
y. `cuda_lstm_tc.split_forward(..., plain=True)` composes the plain
versions of those kernels exactly as the card composes the kernels (the
same partition of the gate columns, the k-major frames of the unfold
layer). Here that composition stands in for each layer's forward, and y
and the cell states must agree with the Pallas forward of the JAX package
in interpret mode for all four routes, f32 and bf16, both `reverse` values
and ragged batches (rows that fill no whole 64-row cluster); then forward
and backward together (the split backward of test_torch_lstm_bwd_split
under it) against the Pallas VJP. Also: the route gate's decisions, the
chain order of the projection's output, and the ctypes declarations of the
new C entry points.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_torch_lstm_bwd_split import (
    H,
    _compare,
    _jax_grads,
    _port_grads,
    _weights,
)
from test_torch_lstm_unfold import _c_signature
from wesep_tpu.ops import pallas_lstm
from wesep_tpu_torch.ops import cuda_lstm, cuda_lstm_fused, cuda_lstm_tc
from wesep_tpu_torch.ops import cuda_lstm_unfold

torch.set_num_threads(1)  # one intra-op thread per test worker

tc = cuda_lstm_tc


def _ulps(ref, n=4):
    """n bf16 units in the last place at ref's largest magnitude."""
    amax = max(float(np.abs(ref).max()), 2.0 ** -126)
    return n * 2.0 ** (math.floor(math.log2(amax)) - 7)


def _compare_forward(y, cs, want_y, want_cs, bf16):
    """f32: relative L2 <= 1e-5 for y and cs (the same f32 arithmetic, sums
    in another order). bf16: y within 4 bf16 units in the last place at its
    largest magnitude (h is rounded to bf16 every step on both sides, and
    an f32 sum that differs in its last bit flips such a rounding now and
    then); cs, which is f32 but carries those roundings of h through Wh,
    within 10 such units of y (the card tests' limit)."""
    assert y.shape == want_y.shape and cs.shape == want_cs.shape
    if bf16:
        tol = _ulps(want_y)
        assert np.abs(y - want_y).max() <= tol, (np.abs(y - want_y).max(),
                                                 tol)
        assert np.abs(cs - want_cs).max() <= 10 * tol, (
            np.abs(cs - want_cs).max(), 10 * tol)
    else:
        for got, want in ((y, want_y), (cs, want_cs)):
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= 1e-5, rel


def _time_major_cs(*cs):
    """Pallas cell states [T, B, H] per direction -> [B, T, dirs * H]."""
    return np.concatenate([np.swapaxes(np.asarray(c, np.float32), 0, 1)
                           for c in cs], axis=-1)


def _inputs(rng, b, t, d, dirs, scale=0.5):
    return [rng.standard_normal((b, t, d)).astype(np.float32) * scale,
            *_weights(rng, dirs, d)]


def _to_jax(args, bf16):
    jargs = [jnp.asarray(a) for a in args]
    if bf16:
        jargs[0] = jargs[0].astype(jnp.bfloat16)
    return jargs


def _to_torch(args, bf16):
    targs = [torch.from_numpy(a) for a in args]
    if bf16:
        targs[0] = targs[0].bfloat16()
    return targs


def _np(t):
    return t.detach().float().numpy()


def _split_layers(monkeypatch):
    """Every layer's plain forward and backward replaced by the split
    compositions of the card's kernels."""
    def layer_fwd(*a, return_cs=False):
        y, cs = tc.layer_forward(*a, with_cs=return_cs, plain=True)
        return (y, cs) if return_cs else y

    def unfold_fwd(*a, return_cs=False):
        y, cs = tc.unfold_forward(*a, with_cs=return_cs, plain=True)
        return (y, cs) if return_cs else y

    def fused_fwd(xw, whs, reverse, return_cs):
        y, cs = tc.fused_forward(xw, whs, reverse, with_cs=return_cs,
                                 plain=True)
        return (y, cs) if return_cs else y

    monkeypatch.setattr(cuda_lstm, "bilstm_layer_reference", layer_fwd)
    monkeypatch.setattr(cuda_lstm, "bilstm_layer_backward_reference",
                        lambda *a: tc.layer_backward(*a, plain=True))
    monkeypatch.setattr(cuda_lstm_unfold, "bilstm_layer_unfold_reference",
                        unfold_fwd)
    monkeypatch.setattr(
        cuda_lstm_unfold, "bilstm_layer_unfold_backward_reference",
        lambda *a: tc.unfold_backward(*a, plain=True))
    monkeypatch.setattr(cuda_lstm_fused, "_recurrence_reference", fused_fwd)
    monkeypatch.setattr(
        cuda_lstm_fused, "_adjoint_reference",
        lambda xw, whs, rev, ys, cs, dys: tc.fused_backward(
            xw, whs, ys, cs, dys, rev, plain=True))


# ---- the fused layer (K0) -----------------------------------------------------


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b,t", [(8, 10), (5, 7), (70, 3)])  # ragged: 5, 70
def test_layer_split_forward_matches_pallas(monkeypatch, b, t, bf16):
    rng = np.random.default_rng(400 + b + 10 * bf16)
    args = _inputs(rng, b, t, 32, 2)
    want_y, (_, _, _, cs_f, cs_b) = pallas_lstm._bi_layer_fwd_impl(
        *_to_jax(args, bf16))
    targs = _to_torch(args, bf16)
    y, cs = tc.layer_forward(*targs, with_cs=True, plain=True)
    _compare_forward(_np(y), _np(cs), np.asarray(want_y, np.float32),
                     _time_major_cs(cs_f, cs_b), bf16)
    # and as the layer's forward: the split stands in for its plain version
    _split_layers(monkeypatch)
    assert torch.equal(cuda_lstm.bilstm_layer(*targs), y)


# ---- the unfold-fused layer (K3) ----------------------------------------------


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("ks,hs,b", [(4, 1, 8), (3, 2, 5), (2, 1, 67)])
def test_unfold_split_forward_matches_pallas(ks, hs, b, bf16):
    rng = np.random.default_rng(500 + ks + b + 10 * bf16)
    c, length = 16, 13
    args = [rng.standard_normal((b, length, c)).astype(np.float32),
            *_weights(rng, 2, ks * c)]
    want_y, (_, _, _, cs_f, cs_b) = pallas_lstm._bi_unfold_fwd_impl(
        *_to_jax(args, bf16), ks, hs)
    y, cs = tc.unfold_forward(*_to_torch(args, bf16), ks, hs, with_cs=True,
                              plain=True)
    _compare_forward(_np(y), _np(cs), np.asarray(want_y, np.float32),
                     _time_major_cs(cs_f, cs_b), bf16)


# ---- the two-kernel layers (K2, K1) -------------------------------------------


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("dirs,reverse,b", [(2, False, 8), (2, False, 5),
                                            (1, False, 8), (1, True, 5),
                                            (1, True, 66)])
def test_fused_split_forward_matches_pallas(dirs, reverse, b, bf16):
    rng = np.random.default_rng(600 + b + dirs + 10 * reverse + 20 * bf16)
    d, t = 24, 9
    args = _inputs(rng, b, t, d, dirs)
    jargs = _to_jax(args, bf16)
    if dirs == 2:
        want_y, (_, _, cs_f, cs_b) = pallas_lstm._bi_fused_fwd_impl(*jargs)
        want_cs = _time_major_cs(cs_f, cs_b)
    else:
        want_y, cs_tm = pallas_lstm._fused_fwd_impl(*jargs, reverse)
        want_cs = _time_major_cs(cs_tm)
    targs = _to_torch(args, bf16)
    weights = [targs[1 + i:4 + i] for i in range(0, 3 * dirs, 3)]
    xw = cuda_lstm_fused._project_all(targs[0], weights)
    y, cs = tc.fused_forward(xw, [w[2] for w in weights], reverse,
                             with_cs=True, plain=True)
    _compare_forward(_np(y), _np(cs), np.asarray(want_y, np.float32),
                     want_cs, bf16)


# ---- forward and backward together against the Pallas VJP --------------------


ROUTES = ["layer", "unfold", "two_kernel", "unidirectional",
          "unidirectional_reverse"]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("route", ROUTES)
def test_split_forward_and_backward_match_the_pallas_vjp(monkeypatch, route,
                                                         bf16):
    """y and every gradient of sum(y * w) through the split forward and the
    split backward, against the Pallas kernels' forward and VJP; the limits
    of test_torch_lstm_bwd_split (f32: rel. L2 1e-5; bf16: 4 units in the
    last place at each gradient's largest magnitude)."""
    _split_layers(monkeypatch)
    rng = np.random.default_rng(700 + ROUTES.index(route) + 10 * bf16)
    b, t, d = 6, 7, 16
    dirs = 1 if route.startswith("unidirectional") else 2
    reverse = route.endswith("reverse")
    if route == "unfold":
        ks, hs = 3, 1
        args = [rng.standard_normal((b, t + ks - 1, d)).astype(np.float32),
                *_weights(rng, 2, ks * d)]

        def jax_fn(*a):
            return pallas_lstm.bilstm_layer_unfold(*a, ks, hs)

        def port_fn(*a):
            return cuda_lstm_unfold.bilstm_layer_unfold(*a, ks, hs)
    else:
        args = _inputs(rng, b, t, d, dirs)
        if route == "layer":
            jax_fn, port_fn = pallas_lstm.bilstm_layer, cuda_lstm.bilstm_layer
        elif route == "two_kernel":
            jax_fn = pallas_lstm.bilstm_fused
            port_fn = cuda_lstm_fused.bilstm_fused
        else:
            def jax_fn(*a):
                return pallas_lstm.lstm_fused(*a, reverse)

            def port_fn(*a):
                return cuda_lstm_fused.lstm_fused(*a, reverse)
    w = rng.standard_normal((b, t, dirs * H)).astype(np.float32)
    want_y, want = _jax_grads(jax_fn, args, w, bf16)
    got_y, got = _port_grads(port_fn, args, w, bf16)
    _compare([got_y], [want_y], bf16)
    _compare(got, want, bf16)


# ---- the pieces ---------------------------------------------------------------


def test_chain_partition_matches_the_plain_recurrence():
    """The plain chain (each of the 4 blocks' gate columns from the whole
    h_{t-1}) is the step-by-step recurrence of the two-kernel layers: f32,
    130 rows (three 64-row clusters, the last ragged), both directions."""
    rng = np.random.default_rng(9)
    b, t = 130, 5
    xw = torch.from_numpy(rng.standard_normal((2, b, t, 4 * H))
                          .astype(np.float32) * 0.5)
    whs = [torch.from_numpy(w) for w in _weights(rng, 2, 0)[2::3]]
    want = cuda_lstm_fused.bilstm_fused_reference(xw, *whs, return_cs=True)
    got = tc.lstm_forward_chain_reference(xw, whs, with_cs=True)
    for g, j in zip(got, want):
        torch.testing.assert_close(g, j, atol=1e-6, rtol=1e-6)


def test_projection_of_k_major_frames_matches_the_unfolded_product():
    """lstm_project_reference over k-major frames with to_k_major weights
    is x @ Wx + b over the channel-major frames of unfold_frames."""
    rng = np.random.default_rng(10)
    ks, hs, c, length, b = 3, 2, 8, 11, 2
    x = torch.from_numpy(rng.standard_normal((b, length, c))
                         .astype(np.float32))
    frames = (length - ks) // hs + 1
    wx = torch.from_numpy(rng.standard_normal((ks * c, 4 * H))
                          .astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(4 * H).astype(np.float32))
    spec = tc.RowSpec(tc.ROW_UNFOLD, ks * c, length, c, hs)
    got = tc.lstm_project_reference(x, [tc.to_k_major(wx, c, ks)], [bias],
                                    spec, frames)
    want = cuda_lstm_unfold.unfold_frames(x, ks, hs) @ wx + bias
    torch.testing.assert_close(got[0], want, atol=1e-5, rtol=1e-5)


def _chain_at(hidden, t_len, tiles, d, b, t, c):
    """Where ChainXw::at (csrc/lstm_tc.cuh) puts xw[d][b][t][c], written
    out again."""
    hu = hidden // 4
    groups = hu // 8
    splits = 1 if groups >= 6 else 2
    warps, warp_rows = groups * splits, 64 // splits
    r, q, u = b % 64, c // hidden, c % hidden
    rank, j, rr = u // hu, u % hu, r % warp_rows
    warp = (r // warp_rows) * groups + j // 8
    lane = (rr % 8) * 4 + (j % 8) // 2
    v = (((rr // 16) * 4 + q) * 2 + (rr // 8) % 2) * 2 + j % 2
    slab = ((d * tiles + b // 64) * t_len + t) * (64 * 4 * hidden)
    return slab + ((rank * warps + warp) * warp_rows + (v // 4) * 4) * 32 \
        + lane * 4 + v % 4


@pytest.mark.parametrize("hidden", [64, 128, 192, 256])
def test_chain_order_inverts_the_projection_layout(hidden):
    """from_chain_order undoes the order in which the projection writes xw
    for the chain (every value in one place, 70 rows: a ragged second
    tile)."""
    dirs, b, t = 2, 70, 2
    tiles = -(-b // 64)
    natural = torch.randn(dirs, b, t, 4 * hidden,
                          generator=torch.Generator().manual_seed(hidden))
    at = torch.tensor([_chain_at(hidden, t, tiles, d, i, s, c)
                       for d in range(dirs) for i in range(b)
                       for s in range(t) for c in range(4 * hidden)])
    assert len(set(at.tolist())) == at.numel()
    buf = torch.full((dirs, tiles, t, 64 * 4 * hidden), float("nan"))
    buf.view(-1)[at] = natural.reshape(-1)
    assert torch.equal(tc.from_chain_order(buf, b), natural)


# ---- the route gate -----------------------------------------------------------


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,d,h,rows,c,fits", [
    (BF16, 128, 256, 376 * 512, None, True),    # pBSRNN band, K0
    (BF16, 128, 256, 32 * 6016, None, True),    # pBSRNN comm, K0
    (BF16, 0, 256, 376 * 512, None, True),      # pBSRNN, K1 / K2
    (BF16, 192, 192, 2056 * 68, 48, True),      # TF-GridNet intra, K3
    (BF16, 192, 192, 568 * 254, None, True),    # TF-GridNet inter, K0
    (BF16, 128, 256, 376 * 64, None, True),     # serving shapes in bf16
    (F32, 128, 256, 376 * 64, None, False),     # f32 serving: FMA kernel
    (BF16, 128, 96, 1000, None, False),         # H not 64, 128, 192, 256
    (BF16, 12, 256, 1000, None, False),         # D % 8
    (BF16, 48, 64, 1000, 12, False),            # C % 8
    (BF16, 128, 256, 0, None, False),           # no rows
    (BF16, 128, 256, 65535 * 128 + 1, None, False),  # a grid dimension
])
def test_forward_gate_decides_from_the_shapes(dtype, d, h, rows, c, fits):
    assert tc.forward_fits(dtype, d, h, rows, c=c) is fits


class _Taken(Exception):
    """Raised by the stand-ins of the two forward paths."""


def _stand_in(label):
    def run(*args, **kwargs):
        raise _Taken(label)
    return run


@pytest.mark.parametrize("dtype,hidden,new", [(BF16, 64, True),
                                              (F32, 64, True),
                                              (BF16, 32, False)])
def test_layer_routes_take_the_forward_gate(monkeypatch, dtype, hidden, new):
    """Each route's card forward asks the gates before any launch: the
    split forward (cuda_lstm_tc's compositions: the tensor-core kernels in
    bf16, the f32 cluster kernels of cuda_lstm_f32 in f32) where it fits,
    the route's own FMA kernel otherwise (f32 shapes the f32 gate refuses:
    test_torch_lstm_fwd_f32)."""
    for name in ("layer_forward", "unfold_forward", "fused_forward"):
        monkeypatch.setattr(tc, name, _stand_in("new"))
    for module in (cuda_lstm, cuda_lstm_unfold, cuda_lstm_fused):
        monkeypatch.setattr(module, "_entry", lambda *a: None)
        monkeypatch.setattr(module, "_launch", _stand_in("old"))
    want = "new" if new else "old"
    b, t, c, ks = 2, 5, 8, 2

    def weights(d):
        return [torch.zeros(d, 4 * hidden), torch.zeros(4 * hidden),
                torch.zeros(hidden, 4 * hidden)] * 2

    x = torch.zeros(b, t, c, dtype=dtype)
    xw = torch.zeros(2, b, t, 4 * hidden, dtype=dtype)
    runs = [
        lambda: cuda_lstm._forward_cuda(x, *weights(c), with_cs=True),
        lambda: cuda_lstm_unfold._forward_cuda(x, *weights(ks * c), ks, 1,
                                               with_cs=True),
        lambda: cuda_lstm_fused._forward_cuda(
            cuda_lstm_fused.bilstm_fused_forward, xw,
            [torch.zeros(hidden, 4 * hidden)] * 2, False, True),
    ]
    for run in runs:
        with pytest.raises(_Taken) as taken:
            run()
        assert taken.value.args[0] == want


def test_ctypes_declarations_match_the_c_entry_points(monkeypatch):
    """Every wrapper of the tensor-core forward declares, and passes, as
    many pointers and ints as its C entry point in csrc/lstm_forward_tc.cu
    takes."""
    calls = []

    def entry(library, name, n_pointers, n_ints):
        def fn(*args):
            calls.append((library, name, n_pointers, n_ints, len(args)))
            return 0
        fn.decl = (library, name, n_pointers, n_ints)
        return fn

    def launch(counter, fn, tensors, ints, device):
        library, name, n_pointers, n_ints = fn.decl
        calls.append((library, name, n_pointers, n_ints,
                      len(tensors) + len(ints) + 1))

    monkeypatch.setattr(tc, "_entry", entry)
    monkeypatch.setattr(tc, "_launch", launch)
    b, t, d = 2, 6, 16
    x = torch.zeros(b, t, d, dtype=BF16)
    wxs = [torch.zeros(d, 4 * H, dtype=BF16)] * 2
    whs = [torch.zeros(H, 4 * H, dtype=BF16)] * 2
    biases = [torch.zeros(4 * H)] * 2
    tc.split_forward(x, tc.RowSpec(tc.ROW_X, d), wxs, biases, whs, t_len=t,
                     with_cs=True)
    tc.split_forward(None, tc.RowSpec(tc.ROW_H, 0), None, None, whs,
                     xw=torch.zeros(2, b, t, 4 * H, dtype=BF16))
    tc.forward_clusters(H)
    assert [c[1] for c in calls] == ["lstm_tc_project", "lstm_tc_forward",
                                     "lstm_tc_forward",
                                     "lstm_tc_forward_clusters"]
    for library, name, n_pointers, n_ints, passed in calls:
        assert (n_pointers, n_ints) == _c_signature(library, name), name
        assert passed == n_pointers + n_ints + 1, name  # and the stream
