"""Port parity: the fused gLN TCN block, forward and every gradient.

The port's `tcn_block_gln` is an autograd Function whose forward and
backward on the CPU are the plain versions of the CUDA kernels. On the same
numpy-seeded inputs they must agree with
wesep_tpu.ops.pallas_tcn.tcn_block_gln (Pallas interpret mode on the CPU,
custom VJP), as tests/test_pallas_tcn.py runs it: odd lengths, dilations
1/4/16, causal and non-causal padding, and a speaker-fused block whose
embedding is folded into the per-sample bias.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wesep_tpu.ops.pallas_tcn import tcn_block_gln as jax_tcn_block_gln
from wesep_tpu_torch.ops import cuda_tcn

torch.set_num_threads(1)  # one intra-op thread per test worker

NAMES = "x b1e w1 p0 kd bd g0w g0b p1 w2 b2 g1w g1b".split()
EPS = 1e-5
C, H, K = 32, 64, 3


def _inputs(seed, b, t, c=C, h=H, k=K):
    """The thirteen arguments in the kernel's order, and a target."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    args = [
        f(rng.standard_normal((b, t, c)) * 0.5),
        f(rng.standard_normal((b, h)) * 0.1),
        f(rng.standard_normal((c, h)) * 0.08),
        f([0.25]),
        f(rng.standard_normal((k, h)) * 0.3),
        f(rng.standard_normal(h) * 0.1),
        f(rng.uniform(0.5, 1.5, h)),
        f(rng.standard_normal(h) * 0.2),
        f([0.2]),
        f(rng.standard_normal((h, c)) * 0.08),
        f(rng.standard_normal(c) * 0.1),
        f(rng.uniform(0.5, 1.5, h)),
        f(rng.standard_normal(h) * 0.2),
    ]
    return args, f(rng.standard_normal((b, t, c)))


def _jax_args(args, bf16):
    jargs = [jnp.asarray(a) for a in args]
    jargs[3], jargs[8] = jargs[3][0], jargs[8][0]  # scalar slopes
    if bf16:
        jargs[0] = jargs[0].astype(jnp.bfloat16)
    return jargs


def _jax_forward(args, d, causal, bf16=False):
    y = jax_tcn_block_gln(*_jax_args(args, bf16), d, K, causal, EPS)
    return np.asarray(y.astype(jnp.float32))


def _jax_grads(args, tgt, d, causal, bf16=False):
    def loss(*a):
        y = jax_tcn_block_gln(*a, d, K, causal, EPS).astype(jnp.float32)
        return jnp.sum((y - tgt) ** 2)

    grads = jax.grad(loss, argnums=tuple(range(13)))(*_jax_args(args, bf16))
    return [np.asarray(g.astype(jnp.float32)).reshape(a.shape)
            for g, a in zip(grads, args)]


def _port(args, d, causal, bf16=False, tgt=None):
    """y (f32 numpy) and, with a target, the gradients of sum((y - tgt)^2)."""
    targs = [torch.from_numpy(a).requires_grad_(tgt is not None)
             for a in args]
    x = targs[0].bfloat16() if bf16 else targs[0]
    y = cuda_tcn.tcn_block_gln(x, *targs[1:], d, K, causal, EPS)
    assert y.dtype == x.dtype and y.shape == x.shape
    if tgt is None:
        return y.float().numpy()
    ((y.float() - torch.from_numpy(tgt)) ** 2).sum().backward()
    return y.detach().float().numpy(), [t.grad.numpy() for t in targs]


def _bf16_ulps(n, want):
    """n bf16 units in the last place at want's largest magnitude."""
    return n * 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)


@pytest.mark.parametrize(
    "d,causal,t",
    [(1, False, 701), (4, False, 701), (16, False, 513), (4, True, 701),
     (16, True, 333)],
)
def test_forward_matches_pallas_f32(d, causal, t):
    """atol 2e-4 * max|want|, the limit tests/test_pallas_tcn.py holds the
    Pallas kernel to: both sides do the same f32 arithmetic and differ in
    the order of the sums (products, the gLN statistics)."""
    args, _ = _inputs(d + t, 2, t)
    want = _jax_forward(args, d, causal)
    got = _port(args, d, causal)
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max(),
                               rtol=0)


@pytest.mark.parametrize("d,causal,t", [(1, False, 701), (16, False, 513),
                                        (4, True, 701)])
def test_gradients_match_pallas_f32(d, causal, t):
    """Every gradient at atol 2e-4 * max|want| (see above); the weight
    gradients come back f32 in the parameters' shapes."""
    args, tgt = _inputs(100 + d, 2, t)
    want = _jax_grads(args, tgt, d, causal)
    _, got = _port(args, d, causal, tgt=tgt)
    for name, g, j in zip(NAMES, got, want):
        assert g.dtype == np.float32 and g.shape == j.shape, name
        np.testing.assert_allclose(
            g, j, atol=2e-4 * (np.abs(j).max() + 1e-6), rtol=0, err_msg=name)


def test_forward_and_gradients_match_pallas_bf16():
    """A bf16 stream with f32 parameters. Both sides round at the same
    points (u before its statistics, n0/v/w op by op, q, round(dv),
    round(ds), dn0 accumulated in bf16), but XLA on the CPU may keep an f32
    intermediate where the kernel rounds, and the Pallas kernel adds the
    dn0 taps in chunk order: an element can differ by a bf16 unit, and the
    f32 parameter gradients sum many such elements. Limits: y and dx (bf16
    themselves) 4 bf16 units in the last place at the largest magnitude;
    every other gradient 2 % of its largest magnitude."""
    d, t = 4, 701
    args, tgt = _inputs(7, 2, t)
    want_y = _jax_forward(args, d, False, bf16=True)
    want = _jax_grads(args, tgt, d, False, bf16=True)
    y, got = _port(args, d, False, bf16=True, tgt=tgt)
    np.testing.assert_allclose(y, want_y, atol=_bf16_ulps(4, want_y), rtol=0)
    for name, g, j in zip(NAMES, got, want):
        assert g.dtype == np.float32, name  # the leaves are f32
        tol = _bf16_ulps(4, j) if name == "x" else 2e-2 * np.abs(j).max()
        np.testing.assert_allclose(g, j, atol=tol, rtol=0, err_msg=name)


def test_fused_block_folds_the_embedding_into_the_bias():
    """concat([x, e]) @ W1 == x @ W1[:C] + e @ W1[C:]: the fused block's
    kernel call takes b1_eff = b1 + e @ W1[C:], and the gradient of b1_eff
    flows back to the embedding, b1 and W1[C:] outside the kernel. Checked
    against jax.grad through the same fold around the Pallas kernel."""
    e_dim, t, d = 16, 333, 4
    args, tgt = _inputs(11, 2, t)
    rng = np.random.default_rng(12)
    emb = rng.standard_normal((2, e_dim)).astype(np.float32)
    w1e = (rng.standard_normal((e_dim, H)) * 0.08).astype(np.float32)
    b1 = (rng.standard_normal(H) * 0.1).astype(np.float32)

    def jax_loss(emb, w1e, b1):
        jargs = _jax_args(args, False)
        jargs[1] = b1[None, :] + emb @ w1e
        y = jax_tcn_block_gln(*jargs, d, K, False, EPS)
        return jnp.sum((y - tgt) ** 2)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(emb), jnp.asarray(w1e), jnp.asarray(b1))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (emb, w1e, b1)]
    targs = [torch.from_numpy(a) for a in args]
    targs[1] = leaves[2][None, :] + leaves[0] @ leaves[1]
    y = cuda_tcn.tcn_block_gln(*targs, d, K, False, EPS)
    ((y - torch.from_numpy(tgt)) ** 2).sum().backward()
    for name, leaf, j in zip(("embed", "w1[C:]", "b1"), leaves, want):
        j = np.asarray(j)
        np.testing.assert_allclose(
            leaf.grad.numpy(), j, atol=2e-4 * np.abs(j).max(), rtol=0,
            err_msg=name)


def test_backward_reference_is_the_adjoint_of_the_forward_reference():
    """The hand-written backward against torch.autograd through the plain
    forward written with differentiable ops, f32: 1e-4 of each gradient's
    largest magnitude (sum order only)."""
    d, t = 4, 257
    args, tgt = _inputs(21, 2, t)
    _, got = _port(args, d, False, tgt=tgt)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    y = cuda_tcn.tcn_block_gln_reference(*targs, d, K, False, EPS)
    ((y - torch.from_numpy(tgt)) ** 2).sum().backward()
    for name, g, leaf in zip(NAMES, got, targs):
        j = leaf.grad.numpy()
        np.testing.assert_allclose(g, j, atol=1e-4 * np.abs(j).max(),
                                   rtol=0, err_msg=name)


def test_no_gradient_saves_nothing_and_counts_no_launch_on_the_cpu():
    args, _ = _inputs(3, 1, 50)
    before = (cuda_tcn.tcn_block_gln.launches,
              cuda_tcn.tcn_block_gln_backward.launches)
    targs = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        y = cuda_tcn.tcn_block_gln(*targs, 2, K, False, EPS)
    assert y.grad_fn is None
    assert before == (cuda_tcn.tcn_block_gln.launches,
                      cuda_tcn.tcn_block_gln_backward.launches)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_tcn.tcn_block_gln(targs[0].to("meta"), *targs[1:], 2, K, False,
                               EPS)
