"""Port parity: the P.862 model (wesep_tpu_torch/ops/pesq.py) and the
normalised host PESQ (wesep_tpu_torch/utils/score.py) against the JAX
package's, from the same numpy-seeded speech-like inputs.

Scores agree within 1e-4 MOS: the thresholds of the model make the score
piecewise, but a 1e-5 relative perturbation of a 4 x 3 s input moves the
JAX scores by at most 3.6e-7 MOS, so FFT and sum-order rounding stay far
below the limit.
"""

import numpy as np
import pytest
import torch

from wesep_tpu.ops import pesq as jax_pesq
from wesep_tpu.utils import score as jax_score
from wesep_tpu_torch.ops import pesq
from wesep_tpu_torch.utils import score

torch.set_num_threads(1)  # one intra-op thread per test worker

MOS_LIMIT = 1e-4


def _speech_like(n, fs, rng):
    """Band-limited noise under a 4 Hz envelope, peak 1."""
    from scipy import signal as sp

    x = rng.standard_normal(n)
    b, a = sp.butter(4, [100, min(4000, 0.45 * fs)], btype="band", fs=fs)
    x = sp.lfilter(b, a, x) * (0.5 + 0.5 * np.sin(
        2 * np.pi * 4 * np.arange(n) / fs + rng.uniform(0, 6)))
    return (x / np.abs(x).max()).astype(np.float32)


def _pairs(fs, rows=4, seconds=3.0, seed=0):
    """Clean rows and degraded copies at SNRs 30 ... 0 dB."""
    rng = np.random.default_rng(seed)
    n = int(seconds * fs)
    ref = np.stack([_speech_like(n, fs, rng) for _ in range(rows)])
    noise = rng.standard_normal(ref.shape).astype(np.float32)
    snr = np.linspace(30, 0, rows)[:, None]
    noise *= np.sqrt((ref ** 2).mean(-1, keepdims=True)
                     / (noise ** 2).mean(-1, keepdims=True)) \
        * 10 ** (-snr / 20)
    return ref, (ref + noise).astype(np.float32)


@pytest.mark.parametrize("fs", [8000, 16000])
def test_scores_match_jax(fs):
    ref, deg = _pairs(fs)
    want = np.asarray(jax_pesq.pesq_batch(ref, deg, fs))
    got = pesq.pesq_batch(torch.from_numpy(ref), torch.from_numpy(deg),
                          fs).numpy()
    np.testing.assert_allclose(got, want, atol=MOS_LIMIT, rtol=0)
    assert np.all(np.diff(got) < 0)  # worse with every step down in SNR
    # the normalised metric and its valid mask, one silent estimate
    deg[1] = 0.0
    want_v, want_ok = jax_pesq.pesq_norm_batch(deg, ref, fs)
    got_v, got_ok = pesq.pesq_norm_batch(torch.from_numpy(deg),
                                         torch.from_numpy(ref), fs)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert got_ok.tolist() == [True, False, True, True]
    ok = got_ok.numpy()
    np.testing.assert_allclose(got_v.numpy()[ok], np.asarray(want_v)[ok],
                               atol=MOS_LIMIT / 5, rtol=0)


@pytest.mark.parametrize("fs,anchor", [(8000, 4.55), (16000, 4.64)])
def test_clean_anchor_and_silence(fs, anchor):
    ref, _ = _pairs(fs, rows=1, seed=3)
    clean = float(pesq.pesq_batch(torch.from_numpy(ref[0]),
                                  torch.from_numpy(ref[0]), fs))
    assert abs(clean - anchor) < 0.02
    silent = torch.zeros(1, ref.shape[1])
    _, ok = pesq.pesq_norm_batch(silent, torch.from_numpy(ref), fs)
    assert not ok.item()
    _, ok = pesq.pesq_norm_batch(torch.from_numpy(ref), silent, fs)
    assert not ok.item()


def test_smoothing_product_matches_the_scan():
    """The gain smoothing as one product equals the scan s_0 = g_0,
    s_t = 0.2 s_{t-1} + 0.8 g_t, in f32, at 92 frames (3 s at 16 kHz)."""
    rng = np.random.default_rng(5)
    raw = torch.from_numpy(rng.uniform(3e-4, 5.0, (4, 92)).astype(np.float32))
    want = [raw[:, 0]]
    for t in range(1, raw.shape[1]):
        want.append(0.2 * want[-1] + 0.8 * raw[:, t])
    want = torch.stack(want, 1)
    got = raw @ pesq.smoothing_matrix(92).t()
    torch.testing.assert_close(got, want, rtol=2e-6, atol=0)


def test_host_pesq_and_alignment_match_jax():
    """cal_PESQ (in-repo model on the CPU after `_crude_align`) and
    cal_PESQ_norm against the JAX package's; None on silence."""
    fs = 16000
    ref, deg = _pairs(fs, rows=2, seed=7)
    # an estimate 640 samples late: the alignment finds the shift
    late = np.concatenate([np.zeros(640, np.float32), deg[0][:-640]])
    np.testing.assert_array_equal(score._crude_align(ref[0], late, fs=fs),
                                  jax_score._crude_align(ref[0], late, fs=fs))
    for est in (deg[1], late):
        want = jax_score.cal_PESQ(est, ref[1], fs)
        got = score.cal_PESQ(est, ref[1], fs)
        assert abs(got - want) <= MOS_LIMIT
        assert abs(score.cal_PESQ_norm(est, ref[1], fs)
                   - jax_score.cal_PESQ_norm(est, ref[1], fs)) \
            <= MOS_LIMIT / 5
    assert score.cal_PESQ(np.zeros_like(ref[0]), ref[0], fs) is None
    assert score.cal_PESQ_norm(ref[0], np.zeros_like(ref[0]), fs) is None
