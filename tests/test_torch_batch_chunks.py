"""The TCN block (K4/K4b) and the Conv2dBlock (K5/K5b) on shapes past a grid
dimension.

The kernels take at most 65535 samples a launch (the batch is a grid
dimension), so their wrappers run a larger batch as slices
(`cuda_tcn.run_in_batch_chunks`): every statistic is per sample, so the
per-sample results of the slices are the whole batch's and the weight
gradients are their sum. Here the slicing arithmetic, and the plain
versions run slice by slice against the whole batch at once. K4's walks
take the chunks of kTile rows of a sample as a grid dimension, each
chunk's rows in row groups; their cover is checked with the constants
read from csrc/tcn_common.cuh.
"""

import os
import re

import numpy as np
import pytest
import torch

from wesep_tpu_torch.ops import cuda_conv2d, cuda_tcn

torch.set_num_threads(1)  # one intra-op thread per test worker


@pytest.mark.parametrize("batch,most,want", [
    (1, 65535, [(0, 1)]),
    (65535, 65535, [(0, 65535)]),
    (65537, 65535, [(0, 65535), (65535, 65537)]),
    (131071, 65535, [(0, 65535), (65535, 131070), (131070, 131071)]),
    (7, 3, [(0, 3), (3, 6), (6, 7)]),
])
def test_batch_chunks_cover_the_batch_in_order(batch, most, want):
    got = cuda_tcn.batch_chunks(batch, most)
    assert got == want
    assert all(0 < b1 - b0 <= most for b0, b1 in got)


def test_grid_stride_loop_covers_every_chunk_once():
    """K4's walks (the dconv, dn0 and colsum passes and the products'
    column epilogues) take chunk blockIdx.x of kTile rows of a sample, a
    grid dimension of up to 2^31 - 1 blocks, and within it each row group
    of 64 threads kRows rows: every row of every chunk is walked once."""
    path = os.path.join(os.path.dirname(cuda_tcn.__file__), os.pardir,
                        "csrc", "tcn_common.cuh")
    with open(path) as f:
        src = f.read()
    tile = int(re.search(r"kTile = (\d+);", src).group(1))
    rows = int(re.search(r"kRows = (\d+);", src).group(1))
    threads = int(re.search(r"kThreads = (\d+);", src).group(1))
    groups = threads // 64  # Walk: 64 pairs of channels a row group
    for t_len in (1, rows, tile, 65535 * tile, 65535 * tile + 1,
                  70000 * tile + 5):
        chunks = -(-t_len // tile)
        assert chunks <= 2 ** 31 - 1
        seen = np.zeros(t_len, dtype=np.int64)
        for cy in {0, chunks // 2, chunks - 1}:
            m0 = cy * tile
            for g in range(groups):
                r0 = g * rows
                r1 = min(r0 + rows, t_len - m0)
                seen[m0 + r0:m0 + max(r1, r0)] += 1
            covered = seen[m0:min(m0 + tile, t_len)]
            assert (covered == 1).all(), (t_len, cy)


def _tcn_args(rng, b, t=11, c=8, h=16, k=3):
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    args = [f(rng.standard_normal((b, t, c)) * 0.5),
            f(rng.standard_normal((b, h)) * 0.1),
            f(rng.standard_normal((c, h)) * 0.1), f([0.25]),
            f(rng.standard_normal((k, h)) * 0.3),
            f(rng.standard_normal(h) * 0.1), f(rng.uniform(0.5, 1.5, h)),
            f(rng.standard_normal(h) * 0.2), f([0.2]),
            f(rng.standard_normal((h, c)) * 0.1),
            f(rng.standard_normal(c) * 0.1), f(rng.uniform(0.5, 1.5, h)),
            f(rng.standard_normal(h) * 0.2)]
    return args, f(rng.standard_normal((b, t, c)))


def test_tcn_block_in_slices_is_the_whole_batch():
    """The plain K4/K4b run over slices of 3 of 7 samples, combined as the
    wrappers combine the kernels' slices: y, the statistics, dx and
    db1_eff join exactly; the weight gradients sum within f32 rounding."""
    rng = np.random.default_rng(0)
    args, dy = _tcn_args(rng, 7)
    conf = (2, 3, False, 1e-5)
    y, stats = cuda_tcn.tcn_block_gln_reference(*args, *conf,
                                                return_stats=True)
    got_y, got_stats = cuda_tcn.run_in_batch_chunks(
        lambda b0, b1: cuda_tcn.tcn_block_gln_reference(
            args[0][b0:b1], args[1][b0:b1], *args[2:], *conf,
            return_stats=True), 7, most=3)
    assert torch.equal(got_y, y) and torch.equal(got_stats, stats)
    want = cuda_tcn.tcn_block_gln_backward_reference(*args, stats, dy, *conf)
    got = cuda_tcn.run_in_batch_chunks(
        lambda b0, b1: cuda_tcn.tcn_block_gln_backward_reference(
            args[0][b0:b1], args[1][b0:b1], *args[2:], stats[b0:b1],
            dy[b0:b1], *conf), 7, summed=range(2, 13), most=3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_conv2d_block_in_slices_is_the_whole_batch():
    """The plain K5/K5b over slices of 2 of 5 samples: y, the statistics and
    dx join exactly; dK and db sum within f32 rounding."""
    rng = np.random.default_rng(1)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x = f(rng.standard_normal((5, 6, 7, 8)))
    kernel = f(rng.standard_normal((3, 3, 8, 8)) * 0.1)
    bias = f(rng.standard_normal(8) * 0.1)
    dy = f(rng.standard_normal((5, 6, 7, 8)))
    y, stats = cuda_conv2d.conv2d_block_in_reference(x, kernel, bias,
                                                     return_stats=True)
    got_y, got_stats = cuda_tcn.run_in_batch_chunks(
        lambda b0, b1: cuda_conv2d.conv2d_block_in_reference(
            x[b0:b1], kernel, bias, return_stats=True), 5, most=2)
    assert torch.equal(got_y, y) and torch.equal(got_stats, stats)
    want = cuda_conv2d.conv2d_block_in_backward_reference(x, kernel, bias,
                                                          stats, dy)
    got = cuda_tcn.run_in_batch_chunks(
        lambda b0, b1: cuda_conv2d.conv2d_block_in_backward_reference(
            x[b0:b1], kernel, bias, stats[b0:b1], dy[b0:b1]), 5,
        summed=(1, 2), most=2)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_one_slice_is_the_call_itself():
    calls = []
    out = cuda_tcn.run_in_batch_chunks(
        lambda b0, b1: calls.append((b0, b1)) or (torch.ones(1),), 65535)
    assert calls == [(0, 65535)] and torch.equal(out[0], torch.ones(1))
