"""Port parity: the split f32 forward of the LSTM layers (serving).

On the card an f32 LSTM layer whose shapes `cuda_lstm_f32.f32_forward_fits`
takes runs its forward as two FMA kernels: the input projection xw = x @ Wx
+ b of every step (the layers that project x; the two-kernel layers bring xw
from their own f32 projection) and a recurrence over clusters of H / 32
blocks, each of the 8 warps of a block summing H / 8 rows of k of h_{t-1}
@ Wh for its block's 32 units, the warps' partial sums added in order.
`cuda_lstm_tc.split_forward(..., plain=True)` composes, for f32 operands,
the plain versions of those kernels as the card composes them
(`cuda_lstm_f32.split_forward_f32`). Here that composition stands in for
each layer's forward, and y and the cell states must agree with the Pallas
forward of the JAX package in interpret mode within 1e-5 abs on all four
routes, both `reverse` values and ragged batches (rows that fill no whole
row tile or cluster). Also: the plain chain's partition against the
straight recurrence, the projection's chain order against its index
formula, the route gate, the rows a cluster the wrapper picks, the routes'
use of the gate, and the ctypes declarations of the new C entry points.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_torch_lstm_bwd_split import _weights
from test_torch_lstm_unfold import _c_signature
from wesep_tpu.ops import pallas_lstm
from wesep_tpu_torch.ops import cuda_lstm, cuda_lstm_f32, cuda_lstm_fused
from wesep_tpu_torch.ops import cuda_lstm_tc, cuda_lstm_unfold

torch.set_num_threads(1)  # one intra-op thread per test worker

f32 = cuda_lstm_f32
tc = cuda_lstm_tc
F32, BF16 = torch.float32, torch.bfloat16
ATOL = 1e-5  # f32 on both sides, sums in another order


def _close(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= ATOL, np.abs(got - want).max()


def _time_major_cs(*cs):
    """Pallas cell states [T, B, H] per direction -> [B, T, dirs * H]."""
    return np.concatenate([np.swapaxes(np.asarray(c, np.float32), 0, 1)
                           for c in cs], axis=-1)


def _inputs(rng, b, t, d, dirs, h):
    return [rng.standard_normal((b, t, d)).astype(np.float32) * 0.5,
            *_weights(rng, dirs, d, h)]


# ---- the fused layer (K0) -----------------------------------------------------


@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("b,t", [(5, 7), (37, 4)])  # ragged row tiles
def test_layer_f32_split_forward_matches_pallas(b, t, h):
    rng = np.random.default_rng(800 + b + h)
    d = 24
    args = _inputs(rng, b, t, d, 2, h)
    assert f32.f32_forward_fits(F32, d, h, b * t)
    want_y, (_, _, _, cs_f, cs_b) = pallas_lstm._bi_layer_fwd_impl(
        *[jnp.asarray(a) for a in args])
    y, cs = tc.layer_forward(*[torch.from_numpy(a) for a in args],
                             with_cs=True, plain=True)
    _close(y, want_y)
    _close(cs, _time_major_cs(cs_f, cs_b))


# ---- the unfold-fused layer (K3) ----------------------------------------------


@pytest.mark.parametrize("ks,hs", [(4, 1), (4, 2)])
def test_unfold_f32_split_forward_matches_pallas(ks, hs):
    rng = np.random.default_rng(900 + hs)
    b, c, length, h = 11, 8, 13, 64
    args = [rng.standard_normal((b, length, c)).astype(np.float32),
            *_weights(rng, 2, ks * c, h)]
    frames = (length - ks) // hs + 1
    assert f32.f32_forward_fits(F32, ks * c, h, b * frames, c=c)
    want_y, (_, _, _, cs_f, cs_b) = pallas_lstm._bi_unfold_fwd_impl(
        *[jnp.asarray(a) for a in args], ks, hs)
    y, cs = tc.unfold_forward(*[torch.from_numpy(a) for a in args], ks, hs,
                              with_cs=True, plain=True)
    _close(y, want_y)
    _close(cs, _time_major_cs(cs_f, cs_b))


# ---- the two-kernel layers (K2, K1) -------------------------------------------


@pytest.mark.parametrize("dirs,reverse,b", [(2, False, 13), (1, False, 9),
                                            (1, True, 21)])
def test_fused_f32_split_forward_matches_pallas(dirs, reverse, b):
    rng = np.random.default_rng(1000 + b + dirs + 10 * reverse)
    d, t, h = 24, 9, 64
    args = _inputs(rng, b, t, d, dirs, h)
    jargs = [jnp.asarray(a) for a in args]
    if dirs == 2:
        want_y, (_, _, cs_f, cs_b) = pallas_lstm._bi_fused_fwd_impl(*jargs)
        want_cs = _time_major_cs(cs_f, cs_b)
    else:
        want_y, cs_tm = pallas_lstm._fused_fwd_impl(*jargs, reverse)
        want_cs = _time_major_cs(cs_tm)
    targs = [torch.from_numpy(a) for a in args]
    weights = [targs[1 + i:4 + i] for i in range(0, 3 * dirs, 3)]
    xw = cuda_lstm_fused._project_all(targs[0], weights)
    assert f32.f32_forward_fits(xw.dtype, 0, h, b * t)
    y, cs = tc.fused_forward(xw, [w[2] for w in weights], reverse,
                             with_cs=True, plain=True)
    _close(y, want_y)
    _close(cs, want_cs)


# ---- the pieces ---------------------------------------------------------------


@pytest.mark.parametrize("dirs,reverse", [(2, False), (1, True)])
def test_f32_chain_partition_matches_the_plain_recurrence(dirs, reverse):
    """The plain chain (each gate xw + the partial sums over H / 8 rows of
    k, in order) is the step-by-step recurrence of the two-kernel layers:
    f32, H 128, 19 rows."""
    rng = np.random.default_rng(11 + dirs)
    b, t, h = 19, 5, 128
    xw = torch.from_numpy(rng.standard_normal((dirs, b, t, 4 * h))
                          .astype(np.float32) * 0.5)
    whs = [torch.from_numpy(w) for w in _weights(rng, dirs, 0, h)[2::3]]
    want = cuda_lstm_fused._recurrence_reference(xw, whs, reverse, True)
    got = f32.lstm_f32_forward_chain_reference(xw, whs, reverse, True)
    for g, j in zip(got, want):
        torch.testing.assert_close(g, j, atol=1e-6, rtol=1e-6)


def _chain_columns(hidden):
    """The projection's column order within its tiles: column rank * 128 +
    j * 4 + q is gate q of unit rank * 32 + j (the four gates of a unit side
    by side, one 16-byte piece; f32_project_kernel stages Wx so)."""
    return torch.arange(4 * hidden).view(4, hidden // 32, 32) \
        .permute(1, 2, 0).reshape(-1)


def _f32_chain_at(hidden, t_len, tiles, rows, d, b, t, c):
    """Where F32ChainXw::at (csrc/lstm_forward_f32.cu) puts
    xw[d][b][t][c], written out again."""
    q, u = c // hidden, c % hidden
    rank, j = u // 32, u % 32
    slab = ((d * tiles + b // rows) * t_len + t) * (rows * 4 * hidden)
    return slab + (rank * rows + b % rows) * 128 + j * 4 + q


@pytest.mark.parametrize("hidden,rows", [(64, 8), (128, 16), (192, 20),
                                         (256, 12)])
def test_f32_chain_order_inverts_the_projection_layout(hidden, rows):
    """The projection writes column c' of its tile order (`_chain_columns`)
    of row (b, t) at F32ChainXw's place;
    from_f32_chain_order undoes it (every value in one place, 21 rows: a
    ragged last tile)."""
    dirs, b, t = 2, 21, 2
    tiles = -(-b // rows)
    natural = torch.randn(dirs, b, t, 4 * hidden,
                          generator=torch.Generator().manual_seed(hidden))
    cols = _chain_columns(hidden)
    assert sorted(cols.tolist()) == list(range(4 * hidden))
    # the projection: its column c' holds natural column cols[c'] and goes
    # to at(rank = c' // 128) + c' % 128
    buf = torch.full((dirs, tiles, t, rows * 4 * hidden), float("nan"))
    flat = buf.view(-1)
    seen = set()
    for d in range(dirs):
        for i in range(b):
            for s in range(t):
                for cp in range(4 * hidden):
                    c = int(cols[cp])
                    at = _f32_chain_at(hidden, t, tiles, rows, d, i, s, c)
                    base = ((d * tiles + i // rows) * t + s) \
                        * (rows * 4 * hidden) \
                        + ((cp // 128) * rows + i % rows) * 128
                    assert at == base + cp % 128
                    seen.add(at)
                    flat[at] = natural[d, i, s, c]
    assert len(seen) == dirs * b * t * 4 * hidden
    assert torch.equal(f32.from_f32_chain_order(buf, b, hidden), natural)


# ---- the route gate -----------------------------------------------------------


@pytest.mark.parametrize("dtype,d,h,rows,c,fits", [
    (F32, 128, 256, 376 * 64, None, True),      # pBSRNN serve band, K0
    (F32, 128, 256, 32 * 752, None, True),      # pBSRNN serve comm, K0
    (F32, 128, 256, 376 * 512, None, True),     # pBSRNN validation, K0
    (F32, 0, 256, 376 * 64, None, True),        # pBSRNN, K1 / K2
    (F32, 192, 192, 1514 * 68, 48, True),       # TF-GridNet intra, K3
    (F32, 192, 192, 142 * 754, None, True),     # TF-GridNet inter, K0
    (BF16, 128, 256, 376 * 64, None, False),    # bf16: the tensor cores
    (F32, 128, 96, 1000, None, False),          # H not 64, 128, 192, 256
    (F32, 12, 256, 1000, None, False),          # D % 8
    (F32, 48, 64, 1000, 12, False),             # C % 8
    (F32, 128, 256, 0, None, False),            # no rows
    (F32, 128, 256, 2 ** 31, None, False),      # a 32-bit row index
])
def test_f32_forward_gate_decides_from_the_shapes(dtype, d, h, rows, c,
                                                  fits):
    assert f32.f32_forward_fits(dtype, d, h, rows, c=c) is fits


@pytest.mark.parametrize("batch,dirs,hidden,at_once,want", [
    (64, 2, 256, 15, 12),    # serve band: 12 clusters of 12 rows, one wave
    (64, 1, 256, 15, 8),     # the unidirectional serve band: 8 of 8 rows
    (64, 2, 256, 8, 16),     # ... when only 8 fit at once
    (142, 2, 192, 17, 20),   # TF-GridNet inter: 16 clusters of 20 rows
    (752, 2, 256, 15, 16),   # serve comm: the fewest cycles over its waves
    (3, 1, 64, 60, 8),       # a tie of waves: the fewest cycles
    (6016, 2, 64, 200, 32),  # many waves at any rows: the most rows
])
def test_rows_per_cluster_follows_the_waves(monkeypatch, batch, dirs, hidden,
                                            at_once, want):
    monkeypatch.setattr(f32, "_clusters_at_once", lambda h, r, dev: at_once)
    assert f32.rows_per_cluster(batch, dirs, hidden, device=0) == want


class _Taken(Exception):
    """Raised by the stand-ins of the two forward paths."""


def _stand_in(label):
    def run(*args, **kwargs):
        raise _Taken(label)
    return run


@pytest.mark.parametrize("hidden,c,new", [(64, 8, True), (32, 8, False),
                                          (64, 4, False)])
def test_f32_routes_take_the_f32_gate(monkeypatch, hidden, c, new):
    """Each route's card forward asks the f32 gate before any launch: the
    new kernels (through cuda_lstm_tc's compositions) where it takes the
    shapes, the route's own FMA kernel where it refuses them (H 32; a row
    of x of 4 or 8 values, D % 8; the two-kernel layers have no x part)."""
    for name in ("layer_forward", "unfold_forward", "fused_forward"):
        monkeypatch.setattr(tc, name, _stand_in("new"))
    for module in (cuda_lstm, cuda_lstm_unfold, cuda_lstm_fused):
        monkeypatch.setattr(module, "_entry", lambda *a: None)
        monkeypatch.setattr(module, "_launch", _stand_in("old"))
    b, t, ks = 2, 5, 2

    def weights(d):
        return [torch.zeros(d, 4 * hidden), torch.zeros(4 * hidden),
                torch.zeros(hidden, 4 * hidden)] * 2

    x = torch.zeros(b, t, c)
    xw = torch.zeros(2, b, t, 4 * hidden)
    runs = [
        (lambda: cuda_lstm._forward_cuda(x, *weights(c), with_cs=True),
         new),
        (lambda: cuda_lstm_unfold._forward_cuda(x, *weights(ks * c), ks, 1,
                                                with_cs=True), new),
        (lambda: cuda_lstm_fused._forward_cuda(
            cuda_lstm_fused.bilstm_fused_forward, xw,
            [torch.zeros(hidden, 4 * hidden)] * 2, False, True),
         hidden in f32.F32_HIDDEN),
    ]
    for run, want_new in runs:
        with pytest.raises(_Taken) as taken:
            run()
        assert taken.value.args[0] == ("new" if want_new else "old")


def test_ctypes_declarations_match_the_c_entry_points(monkeypatch):
    """Every wrapper of the f32 forward declares, and passes, as many
    pointers and ints as its C entry point in csrc/lstm_forward_f32.cu
    takes; and the composition launches the projection with the rows a
    cluster it picked, then the chain."""
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

    monkeypatch.setattr(f32, "_entry", entry)
    monkeypatch.setattr(f32, "_launch", launch)
    monkeypatch.setattr(f32, "_clusters_at_once", lambda h, r, dev: 16)
    b, t, d, h = 2, 6, 16, 64
    x = torch.zeros(b, t, d)
    wxs = [torch.zeros(d, 4 * h)] * 2
    whs = [torch.zeros(h, 4 * h)] * 2
    biases = [torch.zeros(4 * h)] * 2
    f32.split_forward_f32(x, tc.RowSpec(tc.ROW_X, d), wxs, biases, whs,
                          t_len=t, with_cs=True)
    f32.split_forward_f32(None, tc.RowSpec(tc.ROW_H, 0), None, None, whs,
                          xw=torch.zeros(2, b, t, 4 * h))
    f32.f32_forward_clusters(h, 8)
    assert [c[1] for c in calls] == ["lstm_f32_project", "lstm_f32_forward",
                                     "lstm_f32_forward",
                                     "lstm_f32_forward_clusters"]
    for library, name, n_pointers, n_ints, passed in calls:
        assert (n_pointers, n_ints) == _c_signature(library, name), name
        assert passed == n_pointers + n_ints + 1, name  # and the stream
