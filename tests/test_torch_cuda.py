"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: on a host without a GPU every test here skips. On the card,
where neither JAX nor pytest-xdist need be installed, run them without the
suite's conftest and options:

    python -m pytest -o addopts="" --noconftest tests/test_torch_cuda.py -q
"""

import math

import pytest
import torch

from wesep_tpu_torch.ops import (
    _build,
    cuda_conv2d,
    cuda_lstm,
    cuda_lstm_f32,
    cuda_lstm_fused,
    cuda_lstm_tc,
    cuda_lstm_unfold,
    cuda_tcn,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tolerance(ref):
    """1e-4 in f32; 4 units in the last place at the largest |ref| in bf16
    (h is rounded to bf16 every step; a different sum order may flip one
    rounding)."""
    if ref.dtype == torch.float32:
        return 1e-4
    amax = max(ref.float().abs().max().item(), 2.0 ** -126)
    return 4 * 2.0 ** (math.floor(math.log2(amax)) - 7)


def _args(device, b, t, d, h, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: (torch.randn(*s, generator=gen) * 0.2).to(device)  # noqa
    return (r(b, t, d).to(dtype), r(d, 4 * h), r(4 * h), r(h, 4 * h),
            r(d, 4 * h), r(4 * h), r(h, 4 * h))


def _fwd_counts():
    """The layer's own forward kernel, then the tensor-core forward's two."""
    return (cuda_lstm.bilstm_layer.launches,
            cuda_lstm_tc.lstm_project.launches,
            cuda_lstm_tc.lstm_forward_chain.launches)


def _f32_counts():
    """The f32 cluster forward's two kernels: projection, chain."""
    return (cuda_lstm_f32.lstm_f32_project.launches,
            cuda_lstm_f32.lstm_f32_forward_chain.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,h", [(8, 10, 64, 128), (13, 7, 128, 256),
                                     (1100, 2, 16, 32), (1, 1, 4, 4)])
def test_bilstm_layer_matches_plain(cuda, dtype, b, t, d, h):
    """One launch of the layer's own forward kernel, or (bf16 shapes
    `forward_fits` takes) one each of the tensor-core projection and
    chain, or (f32 shapes `f32_forward_fits` takes) one each of the f32
    projection and cluster chain; y against the plain version."""
    args = _args(cuda, b, t, d, h, dtype)
    new = cuda_lstm_tc.forward_fits(dtype, d, h, b * t)
    f32 = cuda_lstm_f32.f32_forward_fits(dtype, d, h, b * t)
    before, f32_before = _fwd_counts(), _f32_counts()
    y = cuda_lstm.bilstm_layer(*args)
    torch.cuda.synchronize()
    assert _fwd_counts() == (before[0] + (not new and not f32),
                             before[1] + new, before[2] + new)
    assert _f32_counts() == (f32_before[0] + f32, f32_before[1] + f32)
    assert y.dtype == dtype and y.shape == (b, t, 2 * h)
    ref = cuda_lstm.bilstm_layer_reference(*args)
    assert (y.float() - ref.float()).abs().max().item() <= _tolerance(ref)


def _grad_tolerances(refs, dtype):
    """Per-gradient limits on the max abs error, relative to the largest
    magnitude of the plain version's gradient: 1e-4 in f32 (sums in another
    order), 2e-2 in bf16 (dgates and dh are rounded to bf16 every step, and
    one flipped rounding moves a whole term)."""
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    return [rel * max(r.float().abs().max().item(), 1e-6) for r in refs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,h", [(8, 10, 64, 128), (13, 7, 128, 256),
                                     (1100, 2, 16, 32), (1, 1, 4, 4),
                                     (5, 9, 128, 32)])
def test_bilstm_layer_backward_matches_plain(cuda, dtype, b, t, d, h):
    """Forward with cell states, then the backward kernels, each against
    its plain version on the same tensors: the four of the tensor-core
    backward (bf16 shapes it takes), the four of the f32 backward (f32
    shapes `f32_backward_fits` takes) or the layer's own two (other
    shapes)."""
    args = _args(cuda, b, t, d, h, dtype)
    tc = cuda_lstm_tc.backward_fits(dtype, d, h, b * t)
    new = cuda_lstm_tc.forward_fits(dtype, d, h, b * t)
    f32 = cuda_lstm_f32.f32_forward_fits(dtype, d, h, b * t)
    f32b = cuda_lstm_f32.f32_backward_fits(dtype, d, h, b * t)
    own = not tc and not f32b
    fwd, f32_before = _fwd_counts(), _f32_counts()
    f32b_before = _f32_bwd_counts()
    counts = (cuda_lstm.bilstm_layer.launches,
              cuda_lstm.bilstm_layer_backward.launches,
              cuda_lstm.bilstm_layer_wgrad.launches, _tc_counts())
    ys, cs = cuda_lstm._forward_cuda(*args, with_cs=True)
    ref_ys, ref_cs = cuda_lstm.bilstm_layer_reference(*args, return_cs=True)
    assert cs.dtype == torch.float32 and cs.shape == (b, t, 2 * h)
    assert (ys.float() - ref_ys.float()).abs().max().item() \
        <= _tolerance(ref_ys)
    # c is not bounded by 1 like h; in bf16 it carries h's rounding
    assert (cs - ref_cs).abs().max().item() <= (
        1e-4 if dtype == torch.float32 else 10 * _tolerance(ref_ys))
    gen = torch.Generator().manual_seed(1)
    dys = torch.randn(b, t, 2 * h, generator=gen).to(cuda).to(dtype)
    # both versions get the same saved tensors, so only the adjoint differs
    got = cuda_lstm._backward_cuda(*args, ref_ys, ref_cs, dys)
    torch.cuda.synchronize()
    assert (cuda_lstm.bilstm_layer.launches,
            cuda_lstm.bilstm_layer_backward.launches,
            cuda_lstm.bilstm_layer_wgrad.launches, _tc_counts()) == (
                counts[0] + (not new and not f32), counts[1] + own,
                counts[2] + own, tuple(c + tc for c in counts[3]))
    assert _f32_bwd_counts() == tuple(c + f32b for c in f32b_before)
    assert _fwd_counts()[1:] == (fwd[1] + new, fwd[2] + new)
    assert _f32_counts() == (f32_before[0] + f32, f32_before[1] + f32)
    want = cuda_lstm.bilstm_layer_backward_reference(
        *args, ref_ys, ref_cs, dys)
    assert got[0].dtype == dtype
    assert all(g.dtype == torch.float32 for g in got[1:])
    # the weight-gradient kernel alone, on the serial kernel's own dgates
    _, _, dg = cuda_lstm.bilstm_layer_backward(*args, ref_ys, ref_cs, dys)
    dw = cuda_lstm.bilstm_layer_wgrad(args[0], ref_ys, dg)
    dw_ref = cuda_lstm.bilstm_layer_wgrad_reference(args[0], ref_ys, dg)
    assert (dw - dw_ref).abs().max().item() \
        <= 1e-4 * max(dw_ref.abs().max().item(), 1e-6)
    names = ("dx", "dwx_f", "db_f", "dwh_f", "dwx_b", "db_b", "dwh_b")
    for name, g, w, tol in zip(names, got, want,
                               _grad_tolerances(want, dtype)):
        assert g.shape == w.shape, name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol, (name, err, tol)


def test_function_gradients_match_finite_differences(cuda):
    """gradcheck-style: the Function's gradients through the kernels, along
    a random direction of every input, against a central difference of the
    kernel forward (f32; the difference quotient is good to about 1%)."""
    args = [a.requires_grad_() for a in
            _args(cuda, 6, 5, 16, 32, torch.float32, seed=2)]
    gen = torch.Generator().manual_seed(3)
    w = torch.randn(6, 5, 64, generator=gen).to(cuda)
    loss = lambda *a: (cuda_lstm.bilstm_layer(*a) * w).sum()  # noqa: E731
    y = cuda_lstm.bilstm_layer(*args)
    assert y.grad_fn is not None
    grads = torch.autograd.grad((y * w).sum(), args)
    eps = 1e-2
    for i, (a, g) in enumerate(zip(args, grads)):
        v = torch.randn(a.shape, generator=gen).to(cuda)
        with torch.no_grad():
            plus = [p + eps * v if k == i else p for k, p in enumerate(args)]
            minus = [p - eps * v if k == i else p for k, p in enumerate(args)]
            numeric = ((loss(*plus) - loss(*minus)) / (2 * eps)).item()
        analytic = (g * v).sum().item()
        assert abs(numeric - analytic) <= 2e-2 * max(abs(analytic), 1.0), \
            (i, numeric, analytic)


def test_function_bf16_returns_f32_weight_gradients(cuda):
    """A bf16 stream with f32 parameters: dx in bf16, weight gradients in
    f32, and serving (no gradient asked) writes no cell states."""
    args = [a.requires_grad_() for a in
            _args(cuda, 9, 6, 64, 128, torch.bfloat16)]
    y = cuda_lstm.bilstm_layer(*args)
    y.float().sum().backward()
    assert args[0].grad.dtype == torch.bfloat16
    assert all(a.grad.dtype == torch.float32 for a in args[1:])
    plain = [a.detach().clone().requires_grad_() for a in args]
    cuda_lstm.bilstm_layer(*plain, plain=True).float().sum().backward()
    for a, p, tol in zip(args, plain, _grad_tolerances(
            [p.grad for p in plain], torch.bfloat16)):
        assert (a.grad.float() - p.grad.float()).abs().max().item() <= tol
    with torch.no_grad():
        assert cuda_lstm.bilstm_layer(*args).grad_fn is None


def test_bilstm_layer_rejects_what_it_cannot_run(cuda):
    args = _args(cuda, 2, 3, 8, 8, torch.float32)
    with pytest.raises(TypeError):
        cuda_lstm.bilstm_layer(args[0].half(), *args[1:])
    with pytest.raises(ValueError):  # H above one thread per unit
        cuda_lstm.bilstm_layer(*_args(cuda, 2, 3, 8, 260, torch.float32))
    with pytest.raises(ValueError):  # a weight left on the host
        cuda_lstm.bilstm_layer(args[0], args[1].cpu(), *args[2:])


# --- the two-kernel LSTM layers (K2/K2b both directions, K1/K1b one) -------

FUSED_ROUTES = [(2, False), (1, False), (1, True)]  # (dirs, reverse)


def _fused_inputs(device, dirs, b, t, h, dtype, seed=0):
    """xw [dirs, b, t, 4h] in `dtype` at the scale of a projected input,
    and dirs f32 recurrent weights [h, 4h]."""
    gen = torch.Generator().manual_seed(seed)
    xw = (torch.randn(dirs, b, t, 4 * h, generator=gen) * 0.5).to(device)
    whs = [(torch.randn(h, 4 * h, generator=gen) * 0.2).to(device)
           for _ in range(dirs)]
    return xw.to(dtype), whs


def _tc_counts():
    return tuple(f.launches for f in (
        cuda_lstm_tc.lstm_gates, cuda_lstm_tc.lstm_adjoint_chain,
        cuda_lstm_tc.lstm_dx, cuda_lstm_tc.lstm_wgrad))


# (route, B, T, D, H): ragged row tiles (B % 32), one step, the smallest
# hidden size the chain takes, a unidirectional layer walked backwards
TC_SHAPES = [("layer", 37, 9, 24, 64), ("layer", 5, 1, 8, 128),
             ("two_kernel", 70, 6, 0, 192), ("reverse", 33, 7, 0, 256),
             ("unfold", 19, 11, 16, 64)]


@pytest.mark.parametrize("route,b,t,d,h", TC_SHAPES)
def test_tc_backward_matches_its_plain_composition(cuda, route, b, t, d, h):
    """The tensor-core backward's four kernels against the same composition
    of their plain versions, bf16, on the same saved tensors: G and dW
    within 1e-4 of their largest magnitude (f32 sums of exact products in
    another order); dg, db and dx within 2e-2 (bf16 roundings flip where an
    f32 sum differs in its last bit); a second run bit for bit."""
    tc = cuda_lstm_tc
    gen = torch.Generator().manual_seed(7)
    r = lambda *s: (torch.randn(*s, generator=gen) * 0.3).to(cuda)  # noqa
    dirs = 1 if route == "reverse" else 2
    whs = [r(h, 4 * h).bfloat16() for _ in range(dirs)]
    ys = r(b, t, dirs * h).bfloat16()
    cs = r(b, t, dirs * h)
    dys = r(b, t, dirs * h).bfloat16()
    biases, xw, wxs, x = None, None, None, None
    if route == "unfold":  # ks 2, hs 1 over C = d // 2: T = L - 1
        x = r(b, t + 1, d // 2).bfloat16()
        spec = tc.RowSpec(tc.ROW_UNFOLD, d, t + 1, d // 2, 1)
    elif route == "layer":
        x = r(b, t, d).bfloat16()
        spec = tc.RowSpec(tc.ROW_X, d)
    else:
        spec = tc.RowSpec(tc.ROW_H, 0)
        xw = r(dirs, b, t, 4 * h).bfloat16()
    if x is not None:
        wxs = [r(d, 4 * h).bfloat16() for _ in range(dirs)]
        biases = [r(4 * h) for _ in range(dirs)]
    rev = route == "reverse"
    before = _tc_counts()
    got = tc.split_backward(x, spec, wxs, biases, whs, ys, cs, dys, xw, rev)
    again = tc.split_backward(x, spec, wxs, biases, whs, ys, cs, dys, xw,
                              rev)
    torch.cuda.synchronize()
    assert _tc_counts() == tuple(
        c + 2 * n for c, n in zip(before, (1, 1, x is not None, 1)))
    assert all(a is None and g is None or torch.equal(a, g)
               for a, g in zip(again, got))
    g = tc.lstm_gates(x, ys, wxs, whs, spec, biases, xw, rev)
    g_ref = tc.lstm_gates_reference(x, ys, wxs, whs, spec, biases, xw, rev)
    dg_ref, db_ref = tc.lstm_adjoint_chain_reference(g, whs, cs, dys, rev)
    dx2, dw, db, dg = got

    def rel(a, w):
        return ((a.float() - w.float()).abs().max()
                / w.float().abs().max().clamp_min(1e-6)).item()

    assert rel(g, g_ref) <= 1e-4
    assert rel(dg, dg_ref) <= 2e-2 and rel(db, db_ref) <= 2e-2
    assert rel(dw, tc.lstm_wgrad_reference(x, ys, dg, spec, rev)) <= 1e-4
    if x is not None:
        assert rel(dx2, tc.lstm_dx_reference(dg, wxs)) <= 2e-2


# (route, B, T, D, H, ks): ragged row tiles (B % 64), one step, three
# tiles, each hidden size, a unidirectional layer walked backwards; then a
# training shape per route: the pBSRNN's band on K0, K2 and K1 (walked
# backwards) and TF-GridNet's intra RNN on K3 (T the frames)
TC_FORWARD_SHAPES = [("layer", 37, 9, 24, 64, 1), ("layer", 5, 1, 8, 128, 1),
                     ("layer", 130, 5, 32, 256, 1),
                     ("two_kernel", 70, 6, 0, 192, 1),
                     ("reverse", 33, 7, 0, 256, 1),
                     ("unfold", 19, 11, 16, 64, 2),
                     ("layer", 512, 376, 128, 256, 1),
                     ("two_kernel", 512, 376, 0, 256, 1),
                     ("reverse", 512, 376, 0, 256, 1),
                     ("unfold", 2056, 68, 192, 192, 4)]


@pytest.mark.parametrize("route,b,t,d,h,ks", TC_FORWARD_SHAPES)
def test_tc_forward_matches_its_plain_composition(cuda, route, b, t, d, h,
                                                  ks):
    """The tensor-core forward's two kernels against their plain versions,
    bf16: the projection (its chain order undone) within 1e-4 of its
    largest magnitude (f32 sums of exact products in another order); the
    chain on the projection's own xw, and the whole split forward against
    the plain composition, y within 4 bf16 units in the last place at its
    largest magnitude and cs within 10 of them (h is rounded to bf16 every
    step; a different sum order may flip one rounding); one launch of each
    a run, and a second run bit for bit."""
    tc = cuda_lstm_tc
    gen = torch.Generator().manual_seed(8)
    scale = 1.0 / math.sqrt(h)

    def u(*s):
        return ((torch.rand(*s, generator=gen) * 2 - 1) * scale).to(cuda)

    dirs = 1 if route == "reverse" else 2
    whs = [u(h, 4 * h).bfloat16() for _ in range(dirs)]
    x = xw = wxs = biases = None
    if route in ("two_kernel", "reverse"):
        spec = tc.RowSpec(tc.ROW_H, 0)
        xw = (torch.randn(dirs, b, t, 4 * h, generator=gen) * 0.5).to(cuda) \
            .bfloat16()
    else:
        if route == "unfold":
            c = d // ks
            x = torch.randn(b, t + ks - 1, c, generator=gen).to(cuda)
            spec = tc.RowSpec(tc.ROW_UNFOLD, d, t + ks - 1, c, 1)
        else:
            x = (torch.randn(b, t, d, generator=gen) * 0.5).to(cuda)
            spec = tc.RowSpec(tc.ROW_X, d)
        x = x.bfloat16()
        wxs = [u(d, 4 * h).bfloat16() for _ in range(dirs)]
        biases = [u(4 * h) for _ in range(dirs)]
    rev = route == "reverse"
    before = (tc.lstm_project.launches, tc.lstm_forward_chain.launches)

    def run():
        xw_k = xw if xw is not None else tc.lstm_project(x, wxs, biases, spec,
                                                         t)
        return (xw_k, *tc.lstm_forward_chain(xw_k, whs, rev, True, batch=b))

    got, again = run(), run()
    torch.cuda.synchronize()
    assert (tc.lstm_project.launches, tc.lstm_forward_chain.launches) == (
        before[0] + 2 * (x is not None), before[1] + 2)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    xw_k, y, cs = got
    assert y.dtype == torch.bfloat16 and y.shape == (b, t, dirs * h)
    assert cs.dtype == torch.float32 and cs.shape == y.shape
    if x is not None:
        xw_k = tc.from_chain_order(xw_k, b)
        ref = tc.lstm_project_reference(x, wxs, biases, spec, t)
        assert ((xw_k - ref).abs().max() / ref.abs().max()).item() <= 1e-4
    for (gy, gcs), (ry, rcs) in (
            ((y, cs), tc.lstm_forward_chain_reference(xw_k, whs, rev, True)),
            (tc.split_forward(x, spec, wxs, biases, whs, xw, t, rev, True),
             tc.split_forward(x, spec, wxs, biases, whs, xw, t, rev, True,
                              plain=True))):
        tol = _tolerance(ry)
        assert (gy.float() - ry.float()).abs().max().item() <= tol
        assert (gcs - rcs).abs().max().item() <= 10 * tol


# (route, B, T, D, H, ks, hs): each hidden size the f32 chain takes, ragged
# row tiles and clusters (B not a multiple of 8, 12, 16, 20 or 32), one step,
# the two-kernel layers' own xw order, a unidirectional layer walked
# backwards, the unfold-fused layer at hs 1 and 2
F32_FORWARD_SHAPES = [("layer", 37, 9, 24, 64, 1, 1),
                      ("layer", 5, 1, 8, 128, 1, 1),
                      ("layer", 45, 6, 128, 256, 1, 1),
                      ("two_kernel", 70, 6, 0, 192, 1, 1),
                      ("reverse", 33, 7, 0, 256, 1, 1),
                      ("unfold", 19, 11, 16, 64, 2, 1),
                      ("unfold", 21, 9, 192, 192, 4, 2)]


@pytest.mark.parametrize("route,b,t,d,h,ks,hs", F32_FORWARD_SHAPES)
def test_f32_forward_matches_its_plain_composition(cuda, route, b, t, d, h,
                                                   ks, hs):
    """The f32 cluster forward's two kernels against their plain versions,
    at every rows a cluster the chain takes at this H: the projection (its
    chain order undone) within 1e-4 of its largest magnitude (f32 sums in
    another order); the chain on the projection's own xw (or the layers'
    xw), y and cs within 1e-4 abs of the plain chain (the same f32 sums of
    each warp's 32 rows of k, added in the same order, transcendentals of
    another rounding); one launch of each a run, a second run bit for bit;
    and the whole split forward (the wrapper's own rows a cluster) against
    the plain composition."""
    tc, f = cuda_lstm_tc, cuda_lstm_f32
    gen = torch.Generator().manual_seed(9)
    scale = 1.0 / math.sqrt(h)

    def u(*s):
        return ((torch.rand(*s, generator=gen) * 2 - 1) * scale).to(cuda)

    dirs = 1 if route == "reverse" else 2
    whs = [u(h, 4 * h) for _ in range(dirs)]
    x = xw = wxs = biases = None
    if route in ("two_kernel", "reverse"):
        spec = tc.RowSpec(tc.ROW_H, 0)
        xw = (torch.randn(dirs, b, t, 4 * h, generator=gen) * 0.5).to(cuda)
    else:
        if route == "unfold":
            c = d // ks
            length = (t - 1) * hs + ks
            x = torch.randn(b, length, c, generator=gen).to(cuda)
            spec = tc.RowSpec(tc.ROW_UNFOLD, d, length, c, hs)
        else:
            x = (torch.randn(b, t, d, generator=gen) * 0.5).to(cuda)
            spec = tc.RowSpec(tc.ROW_X, d)
        wxs = [u(d, 4 * h) for _ in range(dirs)]
        biases = [u(4 * h) for _ in range(dirs)]
    assert f.f32_forward_fits(torch.float32, spec.d, h, b * t,
                              c=spec.c or None)
    rev = route == "reverse"
    xw_ref = xw if xw is not None else f.lstm_f32_project_reference(
        x, wxs, biases, spec, t)
    y_ref, cs_ref = f.lstm_f32_forward_chain_reference(xw_ref, whs, rev, True)
    for rows in f.F32_ROWS:
        before = _f32_counts()

        def run():
            if xw is not None:
                return (xw, *f.lstm_f32_forward_chain(xw, whs, rev, True,
                                                      rows=rows))
            xw_k = f.lstm_f32_project(x, wxs, biases, spec, t, rows)
            return (xw_k, *f.lstm_f32_forward_chain(xw_k, whs, rev, True,
                                                    batch=b))

        got, again = run(), run()
        torch.cuda.synchronize()
        assert _f32_counts() == (before[0] + 2 * (x is not None),
                                 before[1] + 2), rows
        if x is not None:  # the rows of the last tile past B are not written
            got, again = [(f.from_f32_chain_order(r[0], b, h), *r[1:])
                          for r in (got, again)]
        assert all(torch.equal(a, g) for a, g in zip(again, got)), rows
        xw_k, y, cs = got
        assert y.dtype == cs.dtype == torch.float32
        assert y.shape == cs.shape == (b, t, dirs * h)
        if x is not None:
            assert ((xw_k - xw_ref).abs().max()
                    / xw_ref.abs().max()).item() <= 1e-4, rows
        assert (y - y_ref).abs().max().item() <= 1e-4, rows
        assert (cs - cs_ref).abs().max().item() <= 1e-4, rows
    gy, gcs = tc.split_forward(x, spec, wxs, biases, whs, xw, t, rev, True)
    ry, rcs = tc.split_forward(x, spec, wxs, biases, whs, xw, t, rev, True,
                               plain=True)
    assert (gy - ry).abs().max().item() <= 1e-4
    assert (gcs - rcs).abs().max().item() <= 1e-4


def _f32_bwd_counts():
    """The f32 backward's four kernels: gates, chain, dx, dW."""
    f = cuda_lstm_f32
    return tuple(k.launches for k in (
        f.lstm_f32_gates, f.lstm_f32_adjoint_chain, f.lstm_f32_dx,
        f.lstm_f32_wgrad))


def _rel(got, want):
    """Largest error relative to the reference's largest magnitude."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-6)).item()


@pytest.mark.parametrize("route,b,t,d,h,ks,hs", F32_FORWARD_SHAPES)
def test_f32_backward_matches_its_plain_composition(cuda, route, b, t, d, h,
                                                    ks, hs):
    """The f32 backward's four kernels against their plain versions, at
    every rows a cluster the adjoint takes at this H, on the same saved
    tensors: G (its chain order undone), dg, db, dx and dW within 1e-4 of
    their largest magnitude (f32 sums in another order, transcendentals of
    another rounding); one launch of the gates and the chain a run, a
    second run bit for bit; and the whole split backward (the wrapper's own
    rows a cluster, one launch of each kernel) against the plain
    composition."""
    tc, f = cuda_lstm_tc, cuda_lstm_f32
    gen = torch.Generator().manual_seed(11)
    scale = 1.0 / math.sqrt(h)

    def u(*s):
        return ((torch.rand(*s, generator=gen) * 2 - 1) * scale).to(cuda)

    def n(*s, k=0.5):
        return (torch.randn(*s, generator=gen) * k).to(cuda)

    dirs = 1 if route == "reverse" else 2
    whs = [u(h, 4 * h) for _ in range(dirs)]
    x = xw = wxs = biases = None
    if route in ("two_kernel", "reverse"):
        spec = tc.RowSpec(tc.ROW_H, 0)
        xw = n(dirs, b, t, 4 * h)
    else:
        if route == "unfold":
            c = d // ks
            length = (t - 1) * hs + ks
            x = n(b, length, c, k=1.0)
            spec = tc.RowSpec(tc.ROW_UNFOLD, d, length, c, hs)
        else:
            x = n(b, t, d)
            spec = tc.RowSpec(tc.ROW_X, d)
        wxs = [u(d, 4 * h) for _ in range(dirs)]
        biases = [u(4 * h) for _ in range(dirs)]
    ys, cs, dys = n(b, t, dirs * h), n(b, t, dirs * h), n(b, t, dirs * h)
    assert f.f32_backward_fits(torch.float32, spec.d, h, b * t,
                               c=spec.c or None)
    rev = route == "reverse"
    g_ref = f.lstm_f32_gates_reference(x, ys, wxs, whs, spec, biases, xw,
                                       rev)
    for rows in f.F32_ROWS:
        before = _f32_bwd_counts()

        def run():
            g = f.lstm_f32_gates(x, ys, wxs, whs, spec, rows, biases, xw,
                                 rev)
            return (f.from_f32_chain_order(g, b, h),
                    *f.lstm_f32_adjoint_chain(g, whs, cs, dys, b, rev))

        got, again = run(), run()
        torch.cuda.synchronize()
        assert _f32_bwd_counts()[:2] == (before[0] + 2, before[1] + 2), rows
        assert all(torch.equal(a, g) for a, g in zip(again, got)), rows
        g, dg, db = got
        dg_ref, db_ref = f.lstm_f32_adjoint_chain_reference(
            g, whs, cs, dys, rev, rows)
        assert _rel(g, g_ref) <= 1e-4, rows
        assert _rel(dg, dg_ref) <= 1e-4 and _rel(db, db_ref) <= 1e-4, rows
    dw = f.lstm_f32_wgrad(x, ys, dg, spec, rev)
    assert _rel(dw, f.lstm_f32_wgrad_reference(x, ys, dg, spec, rev)) <= 1e-4
    if x is not None:
        dx2 = f.lstm_f32_dx(dg, wxs)
        assert _rel(dx2, f.lstm_f32_dx_reference(dg, wxs)) <= 1e-4
    before = _f32_bwd_counts()
    got = tc.split_backward(x, spec, wxs, biases, whs, ys, cs, dys, xw, rev)
    want = tc.split_backward(x, spec, wxs, biases, whs, ys, cs, dys, xw, rev,
                             plain=True)
    torch.cuda.synchronize()
    assert _f32_bwd_counts() == tuple(
        c + k for c, k in zip(before, (1, 1, x is not None, 1)))
    for a, w in zip(got, want):
        assert a is None and w is None or _rel(a, w) <= 1e-4


def _fused_counts():
    k = cuda_lstm_fused
    return tuple(f.launches for f in (
        k.bilstm_fused_forward, k.bilstm_fused_backward, k.bilstm_fused_wgrad,
        k.lstm_fused_forward, k.lstm_fused_backward, k.lstm_fused_wgrad))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dirs,reverse", FUSED_ROUTES)
@pytest.mark.parametrize("b,t,h", [(8, 10, 64), (13, 7, 256), (1100, 2, 32),
                                   (1, 1, 4), (5, 9, 32)])
def test_fused_layer_matches_plain(cuda, dtype, dirs, reverse, b, t, h):
    """The forward with cell states, the serial adjoint (on the plain
    forward's saved tensors, so only the adjoint differs) and the
    weight-gradient kernel (on the adjoint's own dxw), each against its
    plain version; each wrapper counts one launch (the forward: the
    tensor-core chain for bf16 shapes `forward_fits` takes, the f32 cluster
    chain for f32 shapes `f32_forward_fits` takes)."""
    k = cuda_lstm_fused
    xw, whs = _fused_inputs(cuda, dirs, b, t, h, dtype)
    new = cuda_lstm_tc.forward_fits(dtype, 0, h, b * t)
    f32 = cuda_lstm_f32.f32_forward_fits(dtype, 0, h, b * t)
    chain = cuda_lstm_tc.lstm_forward_chain.launches
    f32_before = _f32_counts()
    before = _fused_counts()
    ys, cs = k._forward_cuda(
        k.bilstm_fused_forward if dirs == 2 else k.lstm_fused_forward, xw,
        whs, reverse, True)
    ref_ys, ref_cs = k._recurrence_reference(xw, whs, reverse, True)
    assert ys.dtype == dtype and ys.shape == (b, t, dirs * h)
    assert cs.dtype == torch.float32 and cs.shape == ys.shape
    assert (ys.float() - ref_ys.float()).abs().max().item() \
        <= _tolerance(ref_ys)
    assert (cs - ref_cs).abs().max().item() <= (
        1e-4 if dtype == torch.float32 else 10 * _tolerance(ref_ys))
    gen = torch.Generator().manual_seed(1)
    dys = torch.randn(b, t, dirs * h, generator=gen).to(cuda).to(dtype)
    if dirs == 2:
        dxw, db = k.bilstm_fused_backward(xw, *whs, ref_ys, ref_cs, dys)
        dwh = k.bilstm_fused_wgrad(ref_ys, dxw)
    else:
        dxw, db = k.lstm_fused_backward(xw, *whs, ref_ys, ref_cs, dys,
                                        reverse=reverse)
        dwh = k.lstm_fused_wgrad(ref_ys, dxw, reverse=reverse)
    torch.cuda.synchronize()
    own = not new and not f32
    step = (own, 1, 1, 0, 0, 0) if dirs == 2 else (0, 0, 0, own, 1, 1)
    assert _fused_counts() == tuple(c + s for c, s in zip(before, step))
    assert cuda_lstm_tc.lstm_forward_chain.launches == chain + new
    assert _f32_counts() == (f32_before[0], f32_before[1] + f32)
    want_dxw, want_dwh, want_db = k._adjoint_reference(
        xw, whs, reverse, ref_ys, ref_cs, dys)
    assert dxw.dtype == dtype and db.dtype == dwh.dtype == torch.float32
    for name, g, w, tol in zip(
            ("dxw", "db", "dwh"), (dxw, db, dwh), (want_dxw, want_db,
                                                   want_dwh),
            _grad_tolerances((want_dxw, want_db, want_dwh), dtype)):
        assert g.shape == w.shape, name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol, (name, err, tol)
    dwh_ref = k.lstm_fused_wgrad_reference(ref_ys, dxw, reverse)
    assert (dwh - dwh_ref).abs().max().item() \
        <= 1e-4 * max(dwh_ref.abs().max().item(), 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dirs,reverse", [(2, False), (1, True)])
def test_fused_kernels_repeat_bit_for_bit(cuda, dtype, dirs, reverse):
    """The pBSRNN's comm RNN at 4 rows x 3 s (B' 1504, T 32, H 256): no
    atomics, the bias tiles and the weight-gradient slices are added in a
    fixed order, so every result is the same bits from run to run."""
    k = cuda_lstm_fused
    xw, whs = _fused_inputs(cuda, dirs, 1504, 32, 256, dtype, seed=2)
    route = (k.bilstm_fused_forward, k.bilstm_fused_backward,
             k.bilstm_fused_wgrad) if dirs == 2 else (
                 k.lstm_fused_forward, k.lstm_fused_backward,
                 k.lstm_fused_wgrad)
    ys, cs = k._forward_cuda(route[0], xw, whs, reverse, True)
    again = k._forward_cuda(route[0], xw, whs, reverse, True)
    assert torch.equal(ys, again[0]) and torch.equal(cs, again[1])
    gen = torch.Generator().manual_seed(3)
    dys = torch.randn(tuple(ys.shape), generator=gen).to(cuda).to(dtype)

    def backward():
        dxw, db = k._backward_cuda(route[1], xw, whs, reverse, ys, cs, dys)
        return dxw, db, k._wgrad_cuda(route[2], ys, dxw, reverse)

    first = backward()
    for _ in range(2):
        for name, a, b in zip(("dxw", "db", "dwh"), first, backward()):
            assert torch.equal(a, b), name


def test_fused_functions_route_and_return_f32_weight_gradients(
        cuda, monkeypatch):
    """Through models.common.LSTM on a bf16 stream with f32 parameters:
    WESEP_LSTM_LAYER=0 sends the bidirectional layer to K2 and none to K0;
    the unidirectional one goes to K1; both backwards (bf16, H 128) to the
    tensor-core backward's gates, chain and dW, and both forwards to the
    tensor-core chain. dx comes back in bf16, weight gradients in f32
    within the bf16 limits of the plain versions'; no gradient asked, no
    graph."""
    from wesep_tpu_torch.models.common import LSTM

    monkeypatch.setenv("WESEP_LSTM_LAYER", "0")
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(9, 6, 64, generator=gen).to(cuda).bfloat16()
    for bidirectional in (True, False):
        torch.manual_seed(0)
        module = LSTM(64, 128, bidirectional=bidirectional).to(cuda)
        before, k0 = _fused_counts(), cuda_lstm.bilstm_layer.launches
        tc_before = _tc_counts()
        chain = cuda_lstm_tc.lstm_forward_chain.launches
        xg = x.clone().requires_grad_()
        module(xg).float().square().sum().backward()
        step = (0, 0, 0, 0, 0, 0)
        assert _fused_counts() == tuple(c + s for c, s in zip(before, step))
        assert cuda_lstm_tc.lstm_forward_chain.launches == chain + 1
        assert _tc_counts() == tuple(c + s for c, s in zip(tc_before,
                                                            (1, 1, 0, 1)))
        assert cuda_lstm.bilstm_layer.launches == k0
        assert xg.grad.dtype == torch.bfloat16
        got = [xg.grad] + [p.grad.clone() for p in module.parameters()]
        assert all(g.dtype == torch.float32 for g in got[1:])
        module.zero_grad()
        module.plain = True
        xp = x.clone().requires_grad_()
        module(xp).float().square().sum().backward()
        want = [xp.grad] + [p.grad for p in module.parameters()]
        assert _fused_counts() == tuple(c + s for c, s in zip(before, step))
        for g, w, tol in zip(got, want, _grad_tolerances(want,
                                                         torch.bfloat16)):
            assert (g.float() - w.float()).abs().max().item() <= tol
        module.plain = False
        with torch.no_grad():
            assert module(x).grad_fn is None


def test_fused_layer_rejects_what_it_cannot_run(cuda):
    """The wrappers raise on what the kernels do not take; ops/rnn sends
    such a layer to the scan before any launch."""
    from wesep_tpu_torch.ops import rnn

    k = cuda_lstm_fused
    xw, whs = _fused_inputs(cuda, 1, 2, 3, 8, torch.float32)
    with pytest.raises(TypeError):
        k.lstm_fused_forward(xw.half(), whs[0])
    xw, whs = _fused_inputs(cuda, 2, 2, 3, 260, torch.float32)
    with pytest.raises(ValueError):  # H above one thread per unit
        k.bilstm_fused_forward(xw, *whs)
    with pytest.raises(ValueError):  # a weight left on the host
        k.lstm_fused_forward(xw[:1], whs[0].cpu())
    x = torch.randn(2, 3, 8, device=cuda)
    wx, b = torch.randn(8, 4 * 260, device=cuda), torch.zeros(
        4 * 260, device=cuda)
    before = _fused_counts()
    y = rnn.lstm(x, wx, whs[0], b)
    assert y.shape == (2, 3, 260) and _fused_counts() == before


# --- the unfold-fused BiLSTM layer -----------------------------------------

UNFOLD_NAMES = ("dx", "dwx_f", "db_f", "dwh_f", "dwx_b", "db_b", "dwh_b")


def _unfold_args(device, b, length, c, ks, h, dtype, seed=0):
    """x [b, length, c] in `dtype`, f32 weights [ks * c, 4h] etc. at torch
    LSTM scale (away from saturated gates)."""
    gen = torch.Generator().manual_seed(seed)
    scale = 1.0 / math.sqrt(h)
    u = lambda *s: ((torch.rand(*s, generator=gen) * 2 - 1) * scale)  # noqa
    d = ks * c
    args = [torch.randn(b, length, c, generator=gen).to(dtype), u(d, 4 * h),
            u(4 * h), u(h, 4 * h), u(d, 4 * h), u(4 * h), u(h, 4 * h)]
    return [a.to(device) for a in args]


# (B, L, C, ks, hs, H): small and ragged (tiles partly empty, hs > 1 with
# rows of x in no frame, a tail past the last frame, one frame), then
# TF-GridNet's inter RNN at training (8 rows x 1 s: B' 568, L 257)
UNFOLD_SHAPES = [(5, 13, 8, 4, 1, 16), (3, 19, 16, 4, 2, 32),
                 (9, 17, 12, 3, 3, 32), (11, 10, 8, 2, 1, 64),
                 (2, 4, 4, 4, 1, 8), (568, 257, 48, 4, 1, 192)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,length,c,ks,hs,h", UNFOLD_SHAPES)
def test_unfold_layer_matches_plain(cuda, dtype, b, length, c, ks, hs, h):
    """Forward (with and without cell states: the layer's own kernel, the
    tensor-core forward in bf16 or the f32 cluster forward where their
    gates take the shapes) and the backward kernels (the layer's own two,
    or the tensor-core backward's four for bf16 shapes its route gate
    takes) against their plain versions (unfold + the plain
    layer + the fold), each from the same saved tensors. Limits as for the
    plain layer: ys 1e-4 or 4 bf16 units in the last place; gradients 1e-4
    (f32) or 2e-2 (bf16) of the plain version's largest magnitude; the
    weight-gradient kernel 1e-4 of the plain product on the kernel's own
    dgates."""
    args = _unfold_args(cuda, b, length, c, ks, h, dtype)
    k = cuda_lstm_unfold
    frames = (length - ks) // hs + 1
    tc = cuda_lstm_tc.backward_fits(dtype, ks * c, h, b * frames, c=c)
    new = cuda_lstm_tc.forward_fits(dtype, ks * c, h, b * frames, c=c)
    f32 = cuda_lstm_f32.f32_forward_fits(dtype, ks * c, h, b * frames, c=c)
    f32b = cuda_lstm_f32.f32_backward_fits(dtype, ks * c, h, b * frames,
                                           c=c)
    own = not tc and not f32b
    fwd, f32_before = _fwd_counts(), _f32_counts()
    f32b_before = _f32_bwd_counts()
    counts = (k.bilstm_layer_unfold.launches,
              k.bilstm_layer_unfold_backward.launches,
              k.bilstm_layer_unfold_wgrad.launches, _tc_counts())
    y = k.bilstm_layer_unfold(*args, ks, hs)
    ys, cs = k._forward_cuda(*args, ks, hs, with_cs=True)
    torch.cuda.synchronize()
    ref_ys, ref_cs = k.bilstm_layer_unfold_reference(*args, ks, hs,
                                                     return_cs=True)
    assert y.dtype == dtype and y.shape == (b, frames, 2 * h)
    for got in (y, ys):
        assert (got.float() - ref_ys.float()).abs().max().item() \
            <= _tolerance(ref_ys)
    assert (cs - ref_cs).abs().max().item() <= (
        1e-4 if dtype == torch.float32 else 10 * _tolerance(ref_ys))
    gen = torch.Generator().manual_seed(1)
    dys = torch.randn(b, frames, 2 * h, generator=gen).to(cuda).to(dtype)
    got = k._backward_cuda(*args, ref_ys, ref_cs, dys, ks, hs)
    torch.cuda.synchronize()
    assert (k.bilstm_layer_unfold.launches,
            k.bilstm_layer_unfold_backward.launches,
            k.bilstm_layer_unfold_wgrad.launches, _tc_counts()) == (
                counts[0] + 2 * (not new and not f32), counts[1] + own,
                counts[2] + own, tuple(c + tc for c in counts[3]))
    assert _f32_bwd_counts() == tuple(c + f32b for c in f32b_before)
    assert _fwd_counts()[1:] == (fwd[1] + 2 * new, fwd[2] + 2 * new)
    assert _f32_counts() == (f32_before[0] + 2 * f32,
                             f32_before[1] + 2 * f32)
    want = k.bilstm_layer_unfold_backward_reference(
        *args, ref_ys, ref_cs, dys, ks, hs)
    assert got[0].dtype == dtype and got[0].shape == (b, length, c)
    assert all(g.dtype == torch.float32 for g in got[1:])
    for name, g, w, tol in zip(UNFOLD_NAMES, got, want,
                               _grad_tolerances(want, dtype)):
        assert g.shape == w.shape, name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol, (name, err, tol)
    covered = torch.zeros(length, dtype=torch.bool)
    for t in range(frames):
        covered[t * hs:t * hs + ks] = True
    assert (got[0][:, ~covered.to(cuda)] == 0).all()  # rows in no frame
    _, _, dg = k.bilstm_layer_unfold_backward(*args, ref_ys, ref_cs, dys,
                                              ks, hs)
    dw = k.bilstm_layer_unfold_wgrad(args[0], ref_ys, dg, ks, hs)
    dw_ref = k.bilstm_layer_unfold_wgrad_reference(args[0], ref_ys, dg, ks,
                                                   hs)
    assert (dw - dw_ref).abs().max().item() \
        <= 1e-4 * max(dw_ref.abs().max().item(), 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unfold_gradients_repeat_bit_for_bit(cuda, dtype):
    """TF-GridNet's intra RNN at training (B' 2056, L 71): no atomics, the
    weight-gradient slices and the bias tiles are added in a fixed order,
    so every gradient is the same bits from run to run."""
    args = _unfold_args(cuda, 2056, 71, 48, 4, 192, dtype, seed=2)
    k = cuda_lstm_unfold
    ys, cs = k._forward_cuda(*args, 4, 1, with_cs=True)
    again_ys, again_cs = k._forward_cuda(*args, 4, 1, with_cs=True)
    assert torch.equal(ys, again_ys) and torch.equal(cs, again_cs)
    gen = torch.Generator().manual_seed(3)
    dys = torch.randn(tuple(ys.shape), generator=gen).to(cuda).to(dtype)
    first = k._backward_cuda(*args, ys, cs, dys, 4, 1)
    for _ in range(2):
        again = k._backward_cuda(*args, ys, cs, dys, 4, 1)
        for name, a, b in zip(UNFOLD_NAMES, first, again):
            assert torch.equal(a, b), name


def test_unfold_function_routes_and_dtypes(cuda, monkeypatch):
    """The Function on a bf16 stream with f32 parameters: dx in bf16,
    weight gradients f32 and within the bf16 limits of the plain route's;
    no gradient asked, no graph. Through models.common.LSTM (f32, H 64:
    the f32 cluster forward's shapes), the switch WESEP_LSTM_UNFOLD picks
    the unfold-fused layer's forward (its projection over k-major frames)
    or the plain layer's, each one launch of the f32 projection and chain
    and none of either layer's own kernel, and the two agree on the same
    module."""
    from wesep_tpu_torch.models.common import LSTM

    k = cuda_lstm_unfold
    args = [a.requires_grad_() for a in
            _unfold_args(cuda, 9, 23, 16, 4, 64, torch.bfloat16)]
    k.bilstm_layer_unfold(*args, 4, 1).float().sum().backward()
    assert args[0].grad.dtype == torch.bfloat16
    assert all(a.grad.dtype == torch.float32 for a in args[1:])
    plain = [a.detach().clone().requires_grad_() for a in args]
    k.bilstm_layer_unfold(*plain, 4, 1, plain=True).float().sum().backward()
    for a, p, tol in zip(args, plain, _grad_tolerances(
            [p.grad for p in plain], torch.bfloat16)):
        assert (a.grad.float() - p.grad.float()).abs().max().item() <= tol
    with torch.no_grad():
        assert k.bilstm_layer_unfold(*args, 4, 1).grad_fn is None

    torch.manual_seed(0)
    module = LSTM(16, 64, unfold_ks=4, unfold_hs=1).to(cuda)
    x = args[0].detach().float()
    calls = []
    for name in ("unfold_forward", "layer_forward"):
        def spy(*a, _name=name, _real=getattr(cuda_lstm_tc, name), **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(cuda_lstm_tc, name, spy)
    outs = {}
    for route in ("1", "0"):
        monkeypatch.setenv("WESEP_LSTM_UNFOLD", route)
        counts = (k.bilstm_layer_unfold.launches,
                  cuda_lstm.bilstm_layer.launches, *_f32_counts())
        calls.clear()
        outs[route] = module(x)
        fused = route == "1"
        assert (k.bilstm_layer_unfold.launches - counts[0],
                cuda_lstm.bilstm_layer.launches - counts[1],
                *(n - c for n, c in zip(_f32_counts(), counts[2:]))) == (
                    0, 0, 1, 1)
        assert calls == ["unfold_forward" if fused else "layer_forward"]
    assert (outs["1"] - outs["0"]).abs().max().item() <= 1e-4


def test_unfold_layer_rejects_what_it_cannot_run(cuda):
    args = _unfold_args(cuda, 2, 9, 8, 4, 16, torch.float32)
    k = cuda_lstm_unfold
    with pytest.raises(TypeError):
        k.bilstm_layer_unfold(args[0].half(), *args[1:], 4, 1)
    with pytest.raises(ValueError):  # fewer rows than one frame
        k.bilstm_layer_unfold(args[0][:, :3], *args[1:], 4, 1)
    with pytest.raises(ValueError):  # ks * C not a multiple of 4
        k.bilstm_layer_unfold(*_unfold_args(cuda, 2, 9, 3, 3, 16,
                                            torch.float32), 3, 1)
    with pytest.raises(ValueError):  # a weight left on the host
        k.bilstm_layer_unfold(args[0], args[1].cpu(), *args[2:], 4, 1)


def test_unfold_failed_build_raises_and_nothing_falls_back(cuda, monkeypatch,
                                                           tmp_path):
    """A CUDA tensor meets a build that fails: the unfold-fused wrapper
    raises the compiler's error; it does not run the plain version."""
    args = _unfold_args(cuda, 2, 9, 8, 4, 16, torch.float32)

    def no_nvcc():
        raise RuntimeError("nvcc not found (test)")

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(cuda_lstm_unfold, "bilstm_layer_unfold_reference",
                        None)
    cuda_lstm._entry.cache_clear()
    _build.load_library.cache_clear()
    try:
        before = cuda_lstm_unfold.bilstm_layer_unfold.launches
        with pytest.raises(RuntimeError, match="nvcc not found"):
            cuda_lstm_unfold.bilstm_layer_unfold(*args, 4, 1)
        assert cuda_lstm_unfold.bilstm_layer_unfold.launches == before
    finally:
        cuda_lstm._entry.cache_clear()
        _build.load_library.cache_clear()


# --- the fused gLN TCN block ----------------------------------------------

TCN_GRADS = ("dx", "db1_eff", "dw1", "dp0", "dkd", "dbd", "dg0w", "dg0b",
             "dp1", "dw2", "db2", "dg1w", "dg1b")


def _tcn_args(device, b, t, c, h, k, dtype, seed=0):
    """The thirteen arguments of tcn_block_gln (x in `dtype`, f32
    parameters) and a cotangent."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    u = lambda n: torch.rand(n, generator=gen) + 0.5  # noqa: E731
    args = [r(b, t, c) * 0.5, r(b, h) * 0.1, r(c, h) * 0.08,
            torch.tensor([0.25]), r(k, h) * 0.3, r(h) * 0.1, u(h),
            r(h) * 0.2, torch.tensor([0.2]), r(h, c) * 0.08, r(c) * 0.1,
            u(h), r(h) * 0.2]
    args = [a.to(device) for a in args]
    args[0] = args[0].to(dtype)
    return args, (r(b, t, c) * 0.1).to(device).to(dtype)


def _rel_l2(got, ref):
    return ((got.float() - ref.float()).norm()
            / ref.float().norm().clamp_min(1e-20)).item()


# small and ragged shapes (tiles and chunks partly empty, k = 2, causal,
# a dilation past the length), then SpEx+'s full width at 2 rows; then the
# tensor-core products' edges: the narrowest block (C = H = 8) at B 1 with
# dilation 128 and T not a multiple of the 128-row tile, T shorter than a
# tile with the most taps (k 8, causal), and H a tile and a half
TCN_SHAPES = [(2, 301, 40, 72, 3, 4, True), (3, 130, 64, 128, 2, 3, False),
              (1, 50, 8, 8, 3, 64, False), (2, 4799, 256, 512, 3, 128, False),
              (1, 601, 8, 8, 3, 128, False), (1, 5, 8, 16, 8, 1, True),
              (2, 257, 24, 192, 3, 16, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,c,h,k,d,causal", TCN_SHAPES)
def test_tcn_block_matches_plain(cuda, dtype, b, t, c, h, k, d, causal):
    """Forward and backward kernels against their plain versions. y: 1e-4
    of the largest magnitude in f32, 4 bf16 units in the last place in
    bf16. Gradients: relative L2 2e-3 (f32) or 2e-2 (bf16) and largest
    error 5e-2 of the largest magnitude: a PReLU input within an f32
    rounding of zero may take the other branch in the two versions, which
    moves one element of dv or ds by (1 - slope) of its size."""
    args, dy = _tcn_args(cuda, b, t, c, h, k, dtype)
    conf = (d, k, causal, 1e-5)
    counts = (cuda_tcn.tcn_block_gln.launches,
              cuda_tcn.tcn_block_gln_backward.launches)
    y, stats = cuda_tcn._forward_cuda(*args, *conf)
    torch.cuda.synchronize()
    ref_y, ref_stats = cuda_tcn.tcn_block_gln_reference(
        *args, *conf, return_stats=True)
    assert y.dtype == dtype and y.shape == (b, t, c)
    tol = 1e-4 * ref_y.abs().max().item() if dtype == torch.float32 \
        else _tolerance(ref_y)
    assert (y.float() - ref_y.float()).abs().max().item() <= tol
    assert (stats - ref_stats).abs().max().item() \
        <= 1e-4 * ref_stats.abs().max().item()
    got = cuda_tcn.tcn_block_gln_backward(*args, ref_stats, dy, *conf)
    torch.cuda.synchronize()
    assert (cuda_tcn.tcn_block_gln.launches,
            cuda_tcn.tcn_block_gln_backward.launches) == tuple(
                n + 1 for n in counts)
    want = cuda_tcn.tcn_block_gln_backward_reference(
        *args, ref_stats, dy, *conf)
    assert got[0].dtype == dtype
    assert all(g.dtype == torch.float32 for g in got[1:])
    l2_limit = 2e-3 if dtype == torch.float32 else 2e-2
    for name, g, w in zip(TCN_GRADS, got, want):
        assert g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        assert _rel_l2(g, w) <= l2_limit, (name, _rel_l2(g, w))
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 5e-2 * max(w.float().abs().max().item(), 1e-6), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tcn_block_gradients_repeat_bit_for_bit(cuda, dtype):
    """No atomics: every sum over blocks is added in a fixed order."""
    args, dy = _tcn_args(cuda, 4, 1500, 256, 512, 3, dtype, seed=1)
    conf = (8, 3, False, 1e-5)
    y1, stats = cuda_tcn._forward_cuda(*args, *conf)
    y2, stats2 = cuda_tcn._forward_cuda(*args, *conf)
    assert torch.equal(y1, y2) and torch.equal(stats, stats2)
    first = cuda_tcn.tcn_block_gln_backward(*args, stats, dy, *conf)
    for _ in range(3):
        again = cuda_tcn.tcn_block_gln_backward(*args, stats, dy, *conf)
        for name, a, b in zip(TCN_GRADS, first, again):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tcn_fused_block_with_embedding_matches_plain(cuda, dtype):
    """A speaker-fused block (the embedding folded into the per-sample
    bias) through its module on the kernels against its plain version: y
    and the gradients of x, the embedding and every parameter, at the
    limits of test_tcn_block_matches_plain."""
    from wesep_tpu_torch.models.convtasnet import FuseTCNBlock

    torch.manual_seed(3)
    block = FuseTCNBlock(64, 32, 128, 3, dilation=4, norm="gLN").to(cuda)
    gen = torch.Generator().manual_seed(4)
    x = (torch.randn(2, 333, 64, generator=gen) * 0.5).to(cuda).to(dtype) \
        .requires_grad_()
    emb = torch.randn(2, 32, generator=gen).to(cuda).to(dtype) \
        .requires_grad_()
    dy = (torch.randn(2, 333, 64, generator=gen) * 0.1).to(cuda).to(dtype)
    params = tuple(block.parameters())

    def run():
        y = block(x, emb)
        return y, torch.autograd.grad(y, (x, emb) + params, dy)

    before = cuda_tcn.tcn_block_gln.launches
    y, grads = run()
    assert cuda_tcn.tcn_block_gln.launches == before + 1
    block.plain = True
    ref_y, ref = run()
    tol = 1e-4 * ref_y.float().abs().max().item() \
        if dtype == torch.float32 else _tolerance(ref_y)
    assert (y.float() - ref_y.float()).abs().max().item() <= tol
    l2_limit = 2e-3 if dtype == torch.float32 else 2e-2
    for i, (g, w) in enumerate(zip(grads, ref)):
        assert torch.isfinite(g).all(), i
        assert _rel_l2(g, w) <= l2_limit, (i, _rel_l2(g, w))


def test_tcn_launch_times_cover_each_launch(cuda):
    """launch_times: one CUDA event between each pair of launches of a
    pass, every named launch timed, their sum within the pass's span."""
    args, dy = _tcn_args(cuda, 2, 700, 64, 128, 3, torch.bfloat16)
    conf = (2, 3, False, 1e-5)
    _, stats = cuda_tcn._forward_cuda(*args, *conf)
    fwd = cuda_tcn.launch_times(
        lambda ev: cuda_tcn._forward_cuda(*args, *conf, events=ev),
        cuda_tcn.FORWARD_LAUNCHES)
    bwd = cuda_tcn.launch_times(
        lambda ev: cuda_tcn.tcn_block_gln_backward(*args, stats, dy, *conf,
                                                   events=ev),
        cuda_tcn.BACKWARD_LAUNCHES)
    assert set(fwd) == set(cuda_tcn.FORWARD_LAUNCHES)
    assert set(bwd) == set(cuda_tcn.BACKWARD_LAUNCHES)
    assert all(v > 0 for v in (*fwd.values(), *bwd.values()))


def test_tcn_function_bf16_returns_f32_parameter_gradients(cuda):
    """The Function on a bf16 stream with f32 parameters: dx in bf16, every
    parameter gradient f32 in its parameter's shape; no gradient asked, no
    graph."""
    args, dy = _tcn_args(cuda, 2, 700, 64, 128, 3, torch.bfloat16)
    leaves = [a.requires_grad_() for a in args]
    y = cuda_tcn.tcn_block_gln(*leaves, 2, 3, False, 1e-5)
    y.backward(dy)
    assert leaves[0].grad.dtype == torch.bfloat16
    for leaf in leaves[1:]:
        assert leaf.grad.dtype == torch.float32
        assert leaf.grad.shape == leaf.shape
    plain = [a.detach().clone().requires_grad_() for a in args]
    cuda_tcn.tcn_block_gln(*plain, 2, 3, False, 1e-5, plain=True).backward(dy)
    for name, a, p in zip(TCN_GRADS, leaves, plain):
        assert _rel_l2(a.grad, p.grad) <= 2e-2, name
    with torch.no_grad():
        assert cuda_tcn.tcn_block_gln(*args, 2, 3, False, 1e-5).grad_fn \
            is None


def test_tcn_block_rejects_what_it_cannot_run(cuda):
    args, _ = _tcn_args(cuda, 2, 30, 16, 32, 3, torch.float32)
    conf = (1, 3, False, 1e-5)
    with pytest.raises(TypeError):
        cuda_tcn.tcn_block_gln(args[0].half(), *args[1:], *conf)
    bad, _ = _tcn_args(cuda, 2, 30, 12, 32, 3, torch.float32)
    with pytest.raises(ValueError):  # C not a multiple of 8
        cuda_tcn.tcn_block_gln(*bad, *conf)
    with pytest.raises(ValueError):  # a parameter left on the host
        cuda_tcn.tcn_block_gln(args[0], args[1].cpu(), *args[2:], *conf)


def test_failed_build_raises_and_nothing_falls_back(cuda, monkeypatch,
                                                    tmp_path):
    """A CUDA tensor meets a build that fails: the wrapper raises the
    compiler's error; it does not run the plain version instead."""
    args, _ = _tcn_args(cuda, 2, 30, 16, 32, 3, torch.float32)

    def no_nvcc():
        raise RuntimeError("nvcc not found (test)")

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(cuda_tcn, "tcn_block_gln_reference", None)
    cuda_tcn._library.cache_clear()
    _build.load_library.cache_clear()
    try:
        before = cuda_tcn.tcn_block_gln.launches
        with pytest.raises(RuntimeError, match="nvcc not found"):
            cuda_tcn.tcn_block_gln(*args, 1, 3, False, 1e-5)
        assert cuda_tcn.tcn_block_gln.launches == before
    finally:
        cuda_tcn._library.cache_clear()
        _build.load_library.cache_clear()


# --- the fused DPCCN Conv2dBlock (conv3x3 -> ELU -> InstanceNorm) ---------

CONV_GRADS = ("dx", "dK", "db")
# ragged tiles (odd F, T not a tile multiple), several input-channel
# chunks, 64 and 48 output channels, then DPCCN's widest gated shape
CONV_SHAPES = [(2, 50, 37, 8, 16), (3, 130, 65, 48, 32),
               (1, 33, 17, 96, 32), (2, 40, 33, 16, 64),
               (2, 23, 11, 16, 48), (2, 376, 257, 32, 16)]
# the edges of the bf16 passes' 128-position tiles and of their segments:
# T 1, F 1 (both f-edges at every position), T * F a multiple of 128, less
# than one tile, Ci 24 (a chunk of 32 half zero), Co 8 and 40 (a slab of 16
# or 32 half used), a tile's segments past both ends of the sample
CONV_EDGE_SHAPES = [(3, 1, 300, 16, 16), (2, 200, 1, 16, 8),
                    (2, 64, 2, 24, 16), (1, 7, 17, 32, 32),
                    (5, 11, 13, 8, 40), (2, 3, 129, 32, 32)]


def _conv_args(device, b, t, f, ci, co, dtype, seed=0):
    """x in `dtype`, f32 kernel and bias, and a cotangent."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    args = [(r(b, t, f, ci) * 0.5).to(dtype), r(3, 3, ci, co) * 0.1,
            r(co) * 0.1]
    return [a.to(device) for a in args], \
        (r(b, t, f, co) * 0.1).to(dtype).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,f,ci,co", CONV_SHAPES + CONV_EDGE_SHAPES)
def test_conv2d_block_matches_plain(cuda, dtype, b, t, f, ci, co):
    """K5 and K5b against their plain versions. y: 1e-4 of the largest
    magnitude in f32, 4 bf16 units in the last place in bf16; stats 1e-4.
    Gradients (the backward from the plain forward's statistics): relative
    L2 1e-3 (f32) or 2e-2 (bf16: dout is rounded, and an f32 sum that
    differs in its last bit flips such a rounding now and then), largest
    error 5e-2 of the largest magnitude."""
    args, dy = _conv_args(cuda, b, t, f, ci, co, dtype)
    counts = (cuda_conv2d.conv2d_block_in.launches,
              cuda_conv2d.conv2d_block_in_backward.launches)
    y, stats = cuda_conv2d._forward_cuda(*args, 1e-5)
    torch.cuda.synchronize()
    ref_y, ref_stats = cuda_conv2d.conv2d_block_in_reference(
        *args, return_stats=True)
    assert y.dtype == dtype and y.shape == (b, t, f, co)
    tol = 1e-4 * ref_y.abs().max().item() if dtype == torch.float32 \
        else _tolerance(ref_y)
    assert (y.float() - ref_y.float()).abs().max().item() <= tol
    assert (stats - ref_stats).abs().max().item() \
        <= 1e-4 * ref_stats.abs().max().item()
    got = cuda_conv2d.conv2d_block_in_backward(*args, ref_stats, dy)
    torch.cuda.synchronize()
    assert (cuda_conv2d.conv2d_block_in.launches,
            cuda_conv2d.conv2d_block_in_backward.launches) == tuple(
                n + 1 for n in counts)
    want = cuda_conv2d.conv2d_block_in_backward_reference(
        *args, ref_stats, dy)
    assert got[0].dtype == dtype
    assert all(g.dtype == torch.float32 for g in got[1:])
    l2_limit = 1e-3 if dtype == torch.float32 else 2e-2
    for name, g, w in zip(CONV_GRADS, got, want):
        assert g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        assert _rel_l2(g, w) <= l2_limit, (name, _rel_l2(g, w))
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 5e-2 * max(w.float().abs().max().item(), 1e-6), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv2d_block_repeats_bit_for_bit(cuda, dtype):
    """No atomics: every sum over blocks is added in a fixed order."""
    args, dy = _conv_args(cuda, 4, 200, 129, 32, 32, dtype, seed=1)
    y1, stats = cuda_conv2d._forward_cuda(*args, 1e-5)
    y2, stats2 = cuda_conv2d._forward_cuda(*args, 1e-5)
    assert torch.equal(y1, y2) and torch.equal(stats, stats2)
    first = cuda_conv2d.conv2d_block_in_backward(*args, stats, dy)
    for _ in range(3):
        again = cuda_conv2d.conv2d_block_in_backward(*args, stats, dy)
        for name, a, b in zip(CONV_GRADS, first, again):
            assert torch.equal(a, b), name


def test_conv2d_function_bf16_returns_f32_parameter_gradients(cuda):
    """The Function on a bf16 stream with f32 parameters: dx in bf16, dK
    and db f32 in their parameters' shapes, near the plain versions'; no
    gradient asked, no graph."""
    args, dy = _conv_args(cuda, 2, 64, 65, 16, 32, torch.bfloat16)
    leaves = [a.requires_grad_() for a in args]
    cuda_conv2d.conv2d_block_in(*leaves).backward(dy)
    assert leaves[0].grad.dtype == torch.bfloat16
    for leaf in leaves[1:]:
        assert leaf.grad.dtype == torch.float32
        assert leaf.grad.shape == leaf.shape
    plain = [a.detach().clone().requires_grad_() for a in args]
    cuda_conv2d.conv2d_block_in(*plain, plain=True).backward(dy)
    for name, a, p in zip(CONV_GRADS, leaves, plain):
        assert _rel_l2(a.grad, p.grad) <= 2e-2, name
    with torch.no_grad():
        assert cuda_conv2d.conv2d_block_in(*args).grad_fn is None


def test_conv2d_block_rejects_what_it_cannot_run(cuda):
    args, _ = _conv_args(cuda, 2, 10, 9, 16, 16, torch.float32)
    with pytest.raises(TypeError):
        cuda_conv2d.conv2d_block_in(args[0].half(), *args[1:])
    bad, _ = _conv_args(cuda, 2, 10, 9, 12, 16, torch.float32)
    with pytest.raises(ValueError):  # Ci not a multiple of 8
        cuda_conv2d.conv2d_block_in(*bad)
    with pytest.raises(ValueError):  # a parameter left on the host
        cuda_conv2d.conv2d_block_in(args[0], args[1].cpu(), args[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv2d_plans_match_the_c_scratch_queries(cuda, dtype):
    """The wrapper's plans equal what the C `_scratch` entry points return
    at DPCCN's six shapes and the edge shapes, for the dK blocks the card's
    wave gives."""
    import ctypes

    from wesep_tpu_torch.ops._build import load_library

    code = 0 if dtype == torch.float32 else 1
    queries = {
        "fwd": load_library("conv2d_block").conv2d_block_forward_scratch,
        "bwd": load_library("conv2d_block_bwd")
        .conv2d_block_backward_scratch}
    shapes = [(2 if dtype == torch.float32 else 8, 376, f, ci, co)
              for f, ci, co in ((257, 16, 16), (257, 32, 16), (129, 32, 32),
                                (65, 32, 32), (33, 32, 32), (17, 32, 32))]
    for b, t, f, ci, co in shapes + CONV_EDGE_SHAPES:
        n_stream, n_f32 = ctypes.c_longlong(), ctypes.c_longlong()
        query = queries["fwd"]
        query.argtypes = [ctypes.c_int] * 6 \
            + [ctypes.POINTER(ctypes.c_longlong)] * 2
        query(b, t, f, ci, co, code, ctypes.byref(n_stream),
              ctypes.byref(n_f32))
        assert (n_stream.value, n_f32.value) == cuda_conv2d.forward_plan(
            b, t, f, ci, co, dtype)
        slots = cuda_conv2d._slots(ci, co, dtype, cuda)
        blocks, *plan = cuda_conv2d.backward_plan(b, t, f, ci, co, dtype,
                                                  slots)
        query = queries["bwd"]
        query.argtypes = [ctypes.c_int] * 7 \
            + [ctypes.POINTER(ctypes.c_longlong)] * 2
        query(b, t, f, ci, co, code, blocks, ctypes.byref(n_stream),
              ctypes.byref(n_f32))
        assert [n_stream.value, n_f32.value] == plan, (b, t, f, ci, co)


# --- the joint speaker branch: fbank and ResNet34 on the card ------------


def _voices(rows, samples, seed):
    gen = torch.Generator().manual_seed(seed)
    t = torch.arange(samples, dtype=torch.float64) / 16000.0
    f0 = 90 + 160 * torch.rand(rows, 1, generator=gen, dtype=torch.float64)
    s = sum(torch.sin(2 * math.pi * f0 * k * t) / k for k in range(1, 6))
    return (0.1 * s + 0.02 * torch.randn(rows, samples, generator=gen,
                                         dtype=torch.float64)).float()


@pytest.mark.parametrize("rows,samples", [(16, 48000), (1, 16037)])
def test_kaldi_fbank_on_the_card_matches_the_cpu(cuda, rows, samples):
    """cuFFT and the f32 mel product against the CPU: 1e-4 of the largest
    log-mel value (the SSA route's shape and an odd length)."""
    from wesep_tpu_torch.ops.fbank import kaldi_fbank

    wav = _voices(rows, samples, 0)
    want = kaldi_fbank(wav, input_scale=32768.0)
    got = kaldi_fbank(wav.to(cuda), input_scale=32768.0)
    assert got.device.type == "cuda" and got.shape == want.shape
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert err <= 1e-4


def test_speaker_feat_on_the_card_matches_the_cpu(cuda):
    """The consistent frontend on two 6 s enrollments: 99.9 % within 2e-4,
    all within 1e-2 (low-energy bins, as in the CPU parity test)."""
    from wesep_tpu_torch.ops.fbank import speaker_feat

    wav = _voices(2, 96000, 1)
    err = (speaker_feat(wav.to(cuda)).cpu() - speaker_feat(wav)).abs()
    assert torch.quantile(err.flatten(), 0.999) <= 2e-4
    assert err.max() <= 1e-2


def test_kaldi_fbank_dithers_from_its_card_generator(cuda):
    from wesep_tpu_torch.ops.fbank import kaldi_fbank

    wav = _voices(2, 8000, 2).to(cuda)

    def run(seed):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        return kaldi_fbank(wav, dither=1.0, generator=gen, input_scale=32768.0)

    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))


@pytest.mark.parametrize("train", [False, True])
def test_resnet34_on_the_card_matches_the_cpu(cuda, train):
    """The v2 recipes' ResNet34 (m_channels 32, embed_dim 256, TSTP) on
    fbank [4, 598, 80], TF32 off: the embedding within 1e-4 relative L2 of
    the CPU's, and in train mode every updated statistic within 1e-4 of
    its largest; a bf16 input gives an f32 embedding."""
    from wesep_tpu_torch.models.speaker import speaker_encoder
    from wesep_tpu_torch.ops.fbank import apply_cmvn, kaldi_fbank

    args = dict(feat_dim=80, embed_dim=256, pooling_func="TSTP",
                two_emb_layer=False)
    torch.manual_seed(0)
    cpu_model = speaker_encoder("ResNet34", args).train(train)
    card_model = speaker_encoder("ResNet34", args)
    card_model.load_state_dict(cpu_model.state_dict())
    card_model = card_model.to(cuda).train(train)
    feats = apply_cmvn(kaldi_fbank(_voices(4, 96000, 3), input_scale=32768.0))
    with torch.no_grad():
        want = cpu_model(feats)
        got = card_model(feats.to(cuda))
    assert got.dtype == torch.float32
    rel = ((got.cpu() - want).norm() / want.norm()).item()
    assert rel <= 1e-4
    cpu_stats = dict(cpu_model.named_buffers())
    for name, b in card_model.named_buffers():
        w = cpu_stats[name]
        assert (b.cpu() - w).abs().max() <= 1e-4 * w.abs().max().clamp_min(
            1e-6), name
    with torch.no_grad():
        half = card_model.eval()(feats.to(cuda).bfloat16())
    assert half.dtype == torch.float32


@pytest.mark.parametrize("fs", [8000, 16000])
def test_pesq_on_the_card_matches_the_cpu(cuda, fs):
    """P.862 of 4 rows x 3 s on the card (cuFFT) against the CPU: scores
    within 1e-4 MOS, the valid mask equal."""
    from wesep_tpu_torch.ops.pesq import pesq_norm_batch

    n = 3 * fs
    ref = _voices(4, n, 4)
    deg = ref + 0.05 * torch.randn(4, n, generator=torch.Generator()
                                   .manual_seed(5)) * torch.arange(4)[:, None]
    want, want_ok = pesq_norm_batch(deg, ref, fs)
    got, ok = pesq_norm_batch(deg.to(cuda), ref.to(cuda), fs)
    assert torch.equal(ok.cpu(), want_ok)
    assert (got.cpu() - want).abs().max() * 5 <= 1e-4


def test_discriminator_on_the_card_matches_the_cpu(cuda):
    """The full-width CMGAN discriminator, train mode (one dropout mask),
    TF32 off: scores within 1e-4 of the largest, u within 1e-5, gradients
    rel. L2 1e-3 but in_bias_0's, 5e-3 of its own norm (a sum of ~2e5
    terms a channel that the next instance norm all but cancels, added in
    another order; chip_smoke.DISC_IN_BIAS0_LIMIT); eval mode stores no
    u."""
    from wesep_tpu_torch.models.discriminator import CMGANDiscriminator

    torch.manual_seed(0)
    cpu_d = CMGANDiscriminator().train()
    card_d = CMGANDiscriminator()
    card_d.load_state_dict(cpu_d.state_dict())
    card_d = card_d.to(cuda).train()
    ref = _voices(2, 48000, 6)
    est = ref + 0.1 * torch.randn(2, 48000,
                                  generator=torch.Generator().manual_seed(7))
    mask = cpu_d.dropout_mask(2, torch.Generator().manual_seed(8), "cpu")
    outs = []
    for model, dev in ((cpu_d, "cpu"), (card_d, cuda)):
        out = model(ref.to(dev), est.to(dev), [m.to(dev) for m in mask])
        grads = torch.autograd.grad(out.sum(), list(model.parameters()))
        outs.append((out.detach().cpu(), [g.cpu() for g in grads]))
    (want, want_g), (got, got_g) = outs
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    for (name, _), g, w in zip(card_d.named_parameters(), got_g, want_g):
        limit = 5e-3 if name == "in_bias_0" else 1e-3
        assert (g - w).norm() <= limit * w.norm(), (name, (
            (g - w).norm() / w.norm()).item())
    assert (card_d.conv_0.u.cpu() - cpu_d.conv_0.u).abs().max() <= 1e-5
    u = card_d.fc_0.u.clone()
    with torch.no_grad():
        card_d.eval()(ref.to(cuda), est.to(cuda))
    assert torch.equal(card_d.fc_0.u, u)


def test_bsrnn_multi_train_forward_runs_24_f32_chains(cuda):
    """A bf16 train forward of a joint BSRNN_Multi (one repeat: 2 BiLSTMs
    a pass) promotes both passes after the fuse to f32: 4 launches of the
    f32 chain with cs; eval mode 2 (one pass)."""
    from wesep_tpu_torch.models.bsrnn_multi_optim import BSRNN_Multi

    torch.manual_seed(0)
    model = BSRNN_Multi(
        feature_dim=32, num_repeat=1, use_spk_transform=False,
        spk_fuse_type="multiply", multi_fuse=False, joint_training=True,
        spk_model="ResNet34", spk_emb_dim=32, spk_feat=False,
        spk_args=dict(feat_dim=80, m_channels=8, embed_dim=32,
                      pooling_func="TSTP", two_emb_layer=False)).to(cuda)
    mix = _voices(2, 16000, 9).to(cuda).bfloat16()
    enroll = _voices(2, 32000, 10).to(cuda).bfloat16()
    chain = cuda_lstm_f32.lstm_f32_forward_chain
    chain.launches = 0
    out, _ = model.train()(mix, enroll)
    assert chain.launches == 4 and out[1].dtype == torch.float32
    chain.launches = 0
    with torch.no_grad():
        model.eval()(mix, enroll)
    assert chain.launches == 2
