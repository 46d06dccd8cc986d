"""BSS-eval source separation metrics (SDR / SIR / SAR) in numpy and scipy.

The port's copy of wesep_tpu/utils/bss_eval.py: bss_eval_sources (Vincent
et al. 2006) as mir_eval computes it, a 512-tap least-squares projection
of each estimate onto the delayed versions of (a) its matching source
(the target with a time-invariant filter) and (b) all sources (the
interference), with the permutation of the best summed SIR.
"""

import itertools
from typing import Tuple

import numpy as np
from scipy.fftpack import fft, ifft
from scipy.linalg import toeplitz

__all__ = ["bss_eval_sources"]


def _autocorr_matrix(sources, flen, n_fft):
    """Block Toeplitz G = correlations of delayed sources, via FFT."""
    nsrc, nsampl = sources.shape
    sf = fft(
        np.hstack([sources, np.zeros((nsrc, flen))]), n=n_fft, axis=1
    )
    g = np.zeros((nsrc * flen, nsrc * flen))
    for i in range(nsrc):
        for j in range(i, nsrc):
            ssf = sf[i] * np.conj(sf[j])
            ssf = np.real(ifft(ssf))
            ss = toeplitz(
                np.hstack((ssf[0], ssf[-1 : -flen : -1])), r=ssf[:flen]
            )
            g[i * flen : (i + 1) * flen, j * flen : (j + 1) * flen] = ss
            g[j * flen : (j + 1) * flen, i * flen : (i + 1) * flen] = ss.T
    return g, sf


def _project(sources, estimate, flen):
    """Least-squares projection of estimate onto delayed sources."""
    nsrc, nsampl = sources.shape
    n_fft = int(2 ** np.ceil(np.log2(nsampl + flen - 1)))
    g, sf = _autocorr_matrix(sources, flen, n_fft)
    sef = fft(np.hstack((estimate, np.zeros(flen))), n=n_fft)
    d = np.zeros(nsrc * flen)
    for i in range(nsrc):
        ssef = np.real(ifft(sf[i] * np.conj(sef)))
        d[i * flen : (i + 1) * flen] = np.hstack(
            (ssef[0], ssef[-1 : -flen : -1])
        )
    try:
        c = np.linalg.solve(g, d).reshape(nsrc, flen)
    except np.linalg.LinAlgError:
        c = np.linalg.lstsq(g, d, rcond=None)[0].reshape(nsrc, flen)
    sproj = np.zeros(nsampl + flen - 1)
    for i in range(nsrc):
        sproj += np.convolve(c[i], sources[i])[: nsampl + flen - 1]
    return sproj


def _bss_decomp_mtifilt(ref_sources, est_source, j, flen):
    nsampl = est_source.shape[0]
    # true source with allowed 512-tap filtering
    s_true = np.hstack((ref_sources[j], np.zeros(flen - 1)))
    e_spat = (
        _project(ref_sources[j : j + 1], est_source, flen) - s_true
    )
    e_interf = _project(ref_sources, est_source, flen) - s_true - e_spat
    e_artif = np.hstack((est_source, np.zeros(flen - 1))) - (
        s_true + e_spat + e_interf
    )
    return s_true, e_spat, e_interf, e_artif


def _ratios(s_true, e_spat, e_interf, e_artif):
    eps = 1e-20
    s_filt = s_true + e_spat
    sdr = 10 * np.log10(
        np.sum(s_filt**2) / max(np.sum((e_interf + e_artif) ** 2), eps)
    )
    sir = 10 * np.log10(
        np.sum(s_filt**2) / max(np.sum(e_interf**2), eps)
    )
    sar = 10 * np.log10(
        np.sum((s_filt + e_interf) ** 2) / max(np.sum(e_artif**2), eps)
    )
    return sdr, sir, sar


def bss_eval_sources(
    reference_sources: np.ndarray,
    estimated_sources: np.ndarray,
    compute_permutation: bool = True,
    filter_length: int = 512,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """-> (sdr [nsrc], sir, sar, perm), as mir_eval.separation gives them."""
    reference_sources = np.atleast_2d(np.asarray(reference_sources, float))
    estimated_sources = np.atleast_2d(np.asarray(estimated_sources, float))
    nsrc = reference_sources.shape[0]

    table = np.zeros((nsrc, nsrc, 3))
    for jest in range(nsrc):
        for jtrue in range(nsrc):
            parts = _bss_decomp_mtifilt(
                reference_sources,
                estimated_sources[jest],
                jtrue,
                filter_length,
            )
            table[jest, jtrue] = _ratios(*parts)

    if compute_permutation:
        best = None
        best_perm = None
        for perm in itertools.permutations(range(nsrc)):
            sir_sum = sum(table[i, p, 1] for i, p in enumerate(perm))
            if best is None or sir_sum > best:
                best = sir_sum
                best_perm = perm
        perm = np.asarray(best_perm)
    else:
        perm = np.arange(nsrc)
    sdr = np.array([table[i, p, 0] for i, p in enumerate(perm)])
    sir = np.array([table[i, p, 1] for i, p in enumerate(perm)])
    sar = np.array([table[i, p, 2] for i, p in enumerate(perm)])
    return sdr, sir, sar, perm
