"""Port parity: the split f32 backward of the LSTM layers (the joint v2
recipes' train step and the f32 gradient checks).

On the card an f32 LSTM layer whose shapes `cuda_lstm_f32.f32_backward_fits`
takes runs its backward as four FMA kernels: the gates of every step
(`lstm_f32_gates`, stored activated in the chain's order), a serial adjoint
over clusters of H / 32 blocks that carries only dh (each block's partial
over its own 128 gate columns, added by the owner in rank order) and writes
the dgates dg, then dx and dW over dg. `cuda_lstm_tc.split_backward(...,
plain=True)` composes, for f32 operands, the plain versions of those kernels
as the card composes them (`cuda_lstm_f32.split_backward_f32`). Here that
composition stands in for each layer's backward, and every gradient must
agree with the Pallas VJP of the JAX package in interpret mode within
relative L2 1e-5 on all four routes (K0, K3 at hs 1 and 2, K2, K1 both
`reverse` values) and ragged batches. Also: the plain chain's partition
against the step-by-step adjoint, where the gates product puts G for the
chain, the weight-gradient slices, the route gate, the rows a cluster the
adjoint picks, the routes' use of the gate and the ctypes declarations of
the new C entry points.
"""

import numpy as np
import pytest

import torch

from test_torch_lstm_bwd_split import (
    _compare,
    _jax_grads,
    _port_grads,
    _weights,
)
from test_torch_lstm_unfold import _c_signature
from wesep_tpu.ops import pallas_lstm
from wesep_tpu_torch.ops import cuda_lstm, cuda_lstm_f32, cuda_lstm_fused
from wesep_tpu_torch.ops import cuda_lstm_tc, cuda_lstm_unfold

torch.set_num_threads(1)  # one intra-op thread per test worker

f32 = cuda_lstm_f32
tc = cuda_lstm_tc
F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture
def composed(monkeypatch):
    """Count the calls of the f32 composition, so that a test can show the
    layer's backward went through it."""
    calls = []
    inner = f32.split_backward_f32

    def counted(*args, **kwargs):
        calls.append(kwargs.get("plain", args[10] if len(args) > 10
                                else False))
        return inner(*args, **kwargs)

    monkeypatch.setattr(f32, "split_backward_f32", counted)
    return calls


# ---- the fused layer (K0b) ----------------------------------------------------


@pytest.mark.parametrize("h,b,t", [(64, 5, 7), (128, 37, 4), (64, 9, 10)])
def test_layer_f32_split_backward_matches_pallas(monkeypatch, composed, h, b,
                                                 t):
    rng = np.random.default_rng(1300 + b + h)
    d = 24
    args = [rng.standard_normal((b, t, d)).astype(np.float32) * 0.5,
            *_weights(rng, 2, d, h)]
    w = rng.standard_normal((b, t, 2 * h)).astype(np.float32)
    assert f32.f32_backward_fits(F32, d, h, b * t)
    monkeypatch.setattr(
        cuda_lstm, "bilstm_layer_backward_reference",
        lambda *a: tc.layer_backward(*a, plain=True))
    _, want = _jax_grads(pallas_lstm.bilstm_layer, args, w, False)
    _, got = _port_grads(cuda_lstm.bilstm_layer, args, w, False)
    _compare(got, want, False)
    assert composed == [True]


# ---- the unfold-fused layer (K3b) ---------------------------------------------


@pytest.mark.parametrize("ks,hs,b", [(4, 1, 11), (4, 2, 5)])
def test_unfold_f32_split_backward_matches_pallas(monkeypatch, composed, ks,
                                                  hs, b):
    rng = np.random.default_rng(1400 + ks + hs + b)
    c, length, h = 8, 13, 64
    args = [rng.standard_normal((b, length, c)).astype(np.float32),
            *_weights(rng, 2, ks * c, h)]
    w = rng.standard_normal((b, length, 2 * h)).astype(np.float32)
    frames = (length - ks) // hs + 1
    assert f32.f32_backward_fits(F32, ks * c, h, b * frames, c=c)
    monkeypatch.setattr(
        cuda_lstm_unfold, "bilstm_layer_unfold_backward_reference",
        lambda *a: tc.unfold_backward(*a, plain=True))
    _, want = _jax_grads(
        lambda *a: pallas_lstm.bilstm_layer_unfold(*a, ks, hs), args, w,
        False)
    _, got = _port_grads(
        lambda *a: cuda_lstm_unfold.bilstm_layer_unfold(*a, ks, hs), args, w,
        False)
    _compare(got, want, False)
    assert composed == [True]


# ---- the two-kernel layers (K2b, K1b) -----------------------------------------


@pytest.mark.parametrize("dirs,reverse,b", [(2, False, 13), (2, False, 5),
                                            (1, False, 9), (1, True, 21)])
def test_fused_f32_split_backward_matches_pallas(monkeypatch, composed, dirs,
                                                 reverse, b):
    rng = np.random.default_rng(1500 + b + dirs + 10 * reverse)
    d, t, h = 24, 6, 64
    args = [rng.standard_normal((b, t, d)).astype(np.float32) * 0.5,
            *_weights(rng, dirs, d, h)]
    w = rng.standard_normal((b, t, dirs * h)).astype(np.float32)
    assert f32.f32_backward_fits(F32, 0, h, b * t)
    monkeypatch.setattr(
        cuda_lstm_fused, "_adjoint_reference",
        lambda xw, whs, rev, ys, cs, dys: tc.fused_backward(
            xw, whs, ys, cs, dys, rev, plain=True))
    if dirs == 2:
        jax_fn, port_fn = pallas_lstm.bilstm_fused, cuda_lstm_fused.bilstm_fused
    else:
        def jax_fn(*a):
            return pallas_lstm.lstm_fused(*a, reverse)

        def port_fn(*a):
            return cuda_lstm_fused.lstm_fused(*a, reverse)
    _, want = _jax_grads(jax_fn, args, w, False)
    _, got = _port_grads(port_fn, args, w, False)
    _compare(got, want, False)
    assert composed == [True]


# ---- the pieces ---------------------------------------------------------------


def _fused_case(rng, dirs, b, t, h):
    """xw [dirs, b, t, 4h], the recurrent weights, the plain forward's ys
    and cs and a cotangent, f32."""
    xw = torch.from_numpy(rng.standard_normal((dirs, b, t, 4 * h))
                          .astype(np.float32) * 0.5)
    whs = [torch.from_numpy(w) for w in _weights(rng, dirs, 0, h)[2::3]]
    dys = torch.from_numpy(rng.standard_normal((b, t, dirs * h))
                           .astype(np.float32))
    return xw, whs, dys


@pytest.mark.parametrize("dirs,reverse,rows", [(2, False, 8), (2, False, 12),
                                               (1, True, 32), (1, False, 20)])
def test_f32_chain_partition_matches_the_step_by_step_adjoint(dirs, reverse,
                                                              rows):
    """The plain chain (H / 32 partial products of dh, each over one
    block's 128 gate columns, added in rank order; db over tiles of `rows`
    rows, then over the tiles) against the plain two-kernel adjoint, which
    sums dh and db in one product each: f32, H 128 (4 blocks), 37 rows (a
    ragged last tile)."""
    rng = np.random.default_rng(70 + dirs + rows)
    b, t, h = 37, 5, 128
    xw, whs, dys = _fused_case(rng, dirs, b, t, h)
    ys, cs = cuda_lstm_fused._recurrence_reference(xw, whs, reverse, True)
    want_dg, _, want_db = cuda_lstm_fused._adjoint_reference(
        xw, whs, reverse, ys, cs, dys)
    g = f32.lstm_f32_gates_reference(None, ys, None, whs,
                                     tc.RowSpec(tc.ROW_H, 0), xw=xw,
                                     reverse=reverse)
    dg, db = f32.lstm_f32_adjoint_chain_reference(g, whs, cs, dys, reverse,
                                                  rows)
    torch.testing.assert_close(dg, want_dg, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(db, want_db, atol=1e-5, rtol=1e-5)
    # the partition: every gate column in exactly one block, 128 a block
    cols = torch.cat(f32._own_columns(h))
    assert sorted(cols.tolist()) == list(range(4 * h))
    assert all(len(c) == 128 for c in f32._own_columns(h))


def _chain_g_at(hidden, t_len, tiles, rows, d, b, t, rank):
    """ChainG::at of csrc/lstm_backward_f32.cu, written out again."""
    return ((d * tiles + b // rows) * t_len + t) * (rows * 4 * hidden) \
        + (rank * rows + b % rows) * 128


@pytest.mark.parametrize("hidden,rows,dirs,reverse", [(64, 8, 2, False),
                                                      (192, 20, 2, False),
                                                      (128, 12, 1, True)])
def test_gates_land_where_the_chain_reads_them(hidden, rows, dirs, reverse):
    """The gates product's epilogue, mirrored: the thread (ty, tx) of the
    tile (m0, n0) writes row m0 + tile_index(ty, i) of its columns 4 tx ..
    and 64 + 4 tx .. (gates i, f, g, o of units 32 rank + tx and + 16 + tx,
    rank = n0 / 128) as two 16-byte pieces at ChainG::at + 4 tx and + 64 +
    4 tx. Every (row, gate column) lands in one place, the chain's item
    (row r, lane j of block rank) finds its four gates at at + 4 j, and
    from_f32_chain_order undoes it: the activated gates of the plain gate
    product, 21 rows (a ragged last tile) of 3 steps."""
    rng = np.random.default_rng(hidden + rows)
    b, t, d = 21, 3, 16
    x = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32))
    ys = torch.from_numpy(rng.standard_normal((b, t, dirs * hidden))
                          .astype(np.float32) * 0.5)
    ws = _weights(rng, dirs, d, hidden)
    wxs = [torch.from_numpy(w) for w in ws[0::3]]
    biases = [torch.from_numpy(w) for w in ws[1::3]]
    whs = [torch.from_numpy(w) for w in ws[2::3]]
    spec = tc.RowSpec(tc.ROW_X, d)
    gates = f32.lstm_f32_gates_reference(x, ys, wxs, whs, spec, biases,
                                         reverse=reverse)
    tiles = -(-b // rows)
    buf = torch.full((dirs * tiles * t * rows * 4 * hidden,), float("nan"))
    written = torch.zeros_like(buf, dtype=torch.int32)

    def tile_index(t16, i):
        return 4 * t16 + i if i < 4 else 64 + 4 * t16 + (i - 4)

    for dr in range(dirs):
        for m0 in range(0, b * t, 128):
            for n0 in range(0, 4 * hidden, 128):
                rank = n0 // 128
                for ty in range(16):
                    for i in range(8):
                        m = m0 + tile_index(ty, i)
                        if m >= b * t:
                            continue
                        bb, tt = divmod(m, t)
                        at = _chain_g_at(hidden, t, tiles, rows, dr, bb, tt,
                                         rank)
                        for tx in range(16):
                            for half in range(2):
                                u = rank * 32 + tx + 16 * half
                                for q in range(4):
                                    k = at + 64 * half + 4 * tx + q
                                    buf[k] = gates[dr, bb, tt, q * hidden + u]
                                    written[k] += 1
    assert int(written.max()) == 1
    assert int(written.sum()) == dirs * b * t * 4 * hidden
    g = buf.view(dirs, tiles, t, rows * 4 * hidden)
    assert torch.equal(f32.from_f32_chain_order(g, b, hidden), gates)
    # the chain's read: item (row r of tile, lane j) of block rank
    for dr, bb, tt, rank, j in [(0, 0, 0, 0, 0), (dirs - 1, b - 1, t - 1,
                                                  hidden // 32 - 1, 31),
                                (0, rows, 1, 1, 17)]:
        at = _chain_g_at(hidden, t, tiles, rows, dr, bb, tt, rank) + 4 * j
        want = gates[dr, bb, tt, [q * hidden + rank * 32 + j
                                  for q in range(4)]]
        assert torch.equal(buf[at:at + 4], want)


@pytest.mark.parametrize("rows,d,h,dirs", [
    (376 * 512, 128, 256, 2),    # pBSRNN train band, K0b
    (32 * 6016, 0, 256, 1),      # pBSRNN train comm, K1b
    (4 * 2 * 754, 192, 192, 2),  # v2 TF-GridNet inter
    (100, 24, 64, 2), (1, 8, 64, 1), (17, 16, 128, 2),
])
def test_f32_wgrad_slices_cover_every_row_once(rows, d, h, dirs):
    """The weight-gradient kernel's slices of the B * T rows (the wrapper's
    rows_per_split, a multiple of the 16-row stage) and, within a slice,
    the rows a thread stages (rows wrow and wrow + 8 of each 16-row stage,
    those past the slice skipped): every row summed once into one
    partial."""
    per = f32.tc.wgrad_splits(rows, d + h, 4 * h, dirs)
    assert per % 16 == 0
    splits = -(-rows // per)
    assert splits * dirs <= 65535
    seen = np.zeros(rows, np.int64)
    for s in range(splits):
        begin, end = s * per, min((s + 1) * per, rows)
        k_len = end - begin
        if rows > 4096:  # the large shapes: the stage walk of one slice
            seen[begin:end] += 1
            continue
        for stage in range(-(-k_len // 16)):
            for wrow in range(8):
                for q in range(2):
                    r = stage * 16 + wrow + 8 * q
                    if r < k_len:
                        seen[begin + r] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("dtype,d,h,rows,c,fits", [
    (F32, 128, 256, 376 * 512, None, True),     # v2 pBSRNN train band, K0b
    (F32, 128, 256, 32 * 6016, None, True),     # v2 pBSRNN train comm, K0b
    (F32, 0, 256, 376 * 512, None, True),       # pBSRNN, K1b / K2b
    (F32, 192, 192, 4 * 2 * 754, None, True),   # v2 TF-GridNet inter, K0b
    (F32, 192, 192, 4 * 2 * 68 * 89, 48, True),  # v2 TF-GridNet intra, K3b
    (BF16, 128, 256, 376 * 512, None, False),   # bf16: the tensor cores
    (F32, 128, 96, 1000, None, False),          # H not 64, 128, 192, 256
    (F32, 12, 256, 1000, None, False),          # D % 8
    (F32, 48, 64, 1000, 12, False),             # C % 8
    (F32, 128, 256, 0, None, False),            # no rows
    (F32, 128, 256, 2 ** 31, None, False),      # a 32-bit row index
])
def test_f32_backward_gate_decides_from_the_shapes(dtype, d, h, rows, c,
                                                   fits):
    assert f32.f32_backward_fits(dtype, d, h, rows, c=c) is fits


@pytest.mark.parametrize("batch,dirs,hidden,at_once,want", [
    (512, 2, 256, 15, 12),   # train band: 86 clusters of 12 rows, 6 waves
    (142, 2, 192, 17, 20),   # TF-GridNet inter: 16 clusters of 20 rows
    (3, 1, 64, 60, 8),       # a tie of waves: the fewest cycles
    (6016, 2, 64, 200, 32),  # many waves at any rows: the most rows
])
def test_adjoint_rows_per_cluster_follows_the_waves(monkeypatch, batch, dirs,
                                                    hidden, at_once, want):
    monkeypatch.setattr(f32, "_adjoint_clusters_at_once",
                        lambda h, r, dev: at_once)
    assert f32.adjoint_rows_per_cluster(batch, dirs, hidden, device=0) \
        == want


class _Taken(Exception):
    """Raised by the stand-ins of the two backward paths."""


def _stand_in(label):
    def run(*args, **kwargs):
        raise _Taken(label)
    return run


@pytest.mark.parametrize("hidden,c,new", [(64, 8, True), (96, 8, False),
                                          (64, 4, False)])
def test_f32_routes_take_the_f32_backward_gate(monkeypatch, hidden, c, new):
    """Each route's card backward asks the f32 gate before any launch: the
    f32 backward (through cuda_lstm_tc's compositions) where it takes the
    shapes, the route's own FMA kernels where it refuses them (H 96; a row
    of x of 4 or 8 values, D % 8; the two-kernel layers have no x part)."""
    for name in ("layer_backward", "unfold_backward", "fused_backward"):
        monkeypatch.setattr(tc, name, _stand_in("new"))
    monkeypatch.setattr(cuda_lstm, "bilstm_layer_backward", _stand_in("old"))
    monkeypatch.setattr(cuda_lstm_unfold, "bilstm_layer_unfold_backward",
                        _stand_in("old"))
    monkeypatch.setattr(cuda_lstm_fused, "_backward_cuda", _stand_in("old"))
    monkeypatch.setattr(cuda_lstm_fused, "_on_kernel_path", lambda *a: True)
    b, t, ks = 2, 5, 2
    frames = t - ks + 1

    def weights(d):
        return [torch.zeros(d, 4 * hidden), torch.zeros(4 * hidden),
                torch.zeros(hidden, 4 * hidden)] * 2

    x = torch.zeros(b, t, c)
    ys = torch.zeros(b, t, 2 * hidden)
    yu = ys[:, :frames].contiguous()
    flat = weights(c)

    class Ctx:
        plain, reverse = False, False
        saved_tensors = (x, *flat, ys, ys)

    runs = [
        (lambda: cuda_lstm._backward_cuda(x, *weights(c), ys, ys, ys), new),
        (lambda: cuda_lstm_unfold._backward_cuda(
            x, *weights(ks * c), yu, yu, yu, ks, 1), new),
        (lambda: cuda_lstm_fused._layer_backward(
            Ctx, cuda_lstm_fused._BIDIRECTIONAL, ys),
         hidden in f32.F32_HIDDEN),
    ]
    for run, want_new in runs:
        with pytest.raises(_Taken) as taken:
            run()
        assert taken.value.args[0] == ("new" if want_new else "old")


def test_ctypes_declarations_match_the_c_entry_points(monkeypatch):
    """Every wrapper of the f32 backward declares, and passes, as many
    pointers and ints as its C entry point in csrc/lstm_backward_f32.cu
    takes; the composition launches the gates with the rows a cluster it
    picked, then the chain, dx (the layers that project x) and dW."""
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
    monkeypatch.setattr(f32, "_adjoint_clusters_at_once",
                        lambda h, r, dev: 16)
    b, t, d, h = 2, 6, 16, 64
    x = torch.zeros(b, t, d)
    ys = torch.zeros(b, t, 2 * h)
    wxs = [torch.zeros(d, 4 * h)] * 2
    whs = [torch.zeros(h, 4 * h)] * 2
    biases = [torch.zeros(4 * h)] * 2
    f32.split_backward_f32(x, tc.RowSpec(tc.ROW_X, d), wxs, biases, whs, ys,
                           ys, ys)
    f32.split_backward_f32(None, tc.RowSpec(tc.ROW_H, 0), None, None, whs,
                           ys, ys, ys, xw=torch.zeros(2, b, t, 4 * h))
    f32.f32_adjoint_clusters(h, 8)
    assert [c[1] for c in calls] == [
        "lstm_f32_gates", "lstm_f32_adjoint", "lstm_f32_dx", "lstm_f32_wgrad",
        "lstm_f32_gates", "lstm_f32_adjoint", "lstm_f32_wgrad",
        "lstm_f32_adjoint_clusters"]
    for library, name, n_pointers, n_ints, passed in calls:
        assert (n_pointers, n_ints) == _c_signature(library, name), name
        assert passed == n_pointers + n_ints + 1, name  # and the stream
