"""SI-SNR and SI-SNRi in numpy (as wesep_tpu/utils/score.py)."""

import numpy as np

__all__ = ["cal_SISNR", "cal_SISNRi"]

EPS = 1e-8


def cal_SISNR(est: np.ndarray, ref: np.ndarray) -> float:
    """Scale-invariant SNR in dB."""
    est = np.asarray(est, np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    if est.shape != ref.shape:
        raise ValueError(f"shapes differ: {est.shape} vs {ref.shape}")
    est = est - est.mean()
    ref = ref - ref.mean()
    t = np.dot(est, ref) * ref / (np.dot(ref, ref) + EPS)
    return float(
        10 * np.log10((t**2).sum() / (((est - t) ** 2).sum() + EPS) + EPS)
    )


def cal_SISNRi(est: np.ndarray, ref: np.ndarray, mix: np.ndarray):
    """(SI-SNR, SI-SNR improvement over the mixture)."""
    sisnr = cal_SISNR(est, ref)
    return sisnr, sisnr - cal_SISNR(mix, ref)
