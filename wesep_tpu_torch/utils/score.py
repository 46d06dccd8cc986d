"""SI-SNR, SI-SNRi and normalised PESQ in numpy (as wesep_tpu/utils/score.py).

`cal_PESQ` uses the ITU `pesq` package where it is installed; otherwise the
in-repo P.862 model (ops/pesq.py) scores the pair on the CPU after a crude
envelope cross-correlation alignment. Silent inputs give None.
"""

from typing import Optional

import numpy as np

__all__ = ["cal_SISNR", "cal_SISNRi", "cal_PESQ", "cal_PESQ_norm"]

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


def cal_PESQ(est: np.ndarray, ref: np.ndarray, fs: int = 16000
             ) -> Optional[float]:
    """PESQ MOS-LQO of one pair, or None for silent inputs (or a
    non-finite in-repo score). The `pesq` package's errors give None, as
    the JAX package returns them."""
    est = np.asarray(est, np.float32).reshape(-1)
    ref = np.asarray(ref, np.float32).reshape(-1)
    if (ref ** 2).mean() <= 1e-12 or (est ** 2).mean() <= 1e-12:
        return None
    try:
        from pesq import pesq as _pesq
    except ImportError:
        _pesq = None
    if _pesq is not None:
        try:
            return float(_pesq(fs, ref, est, "wb" if fs == 16000 else "nb"))
        except Exception:
            return None
    import torch

    from wesep_tpu_torch.ops.pesq import pesq_batch

    est = _crude_align(ref, est, fs=fs)
    n = min(len(ref), len(est))
    cpu = torch.device("cpu")
    score = float(pesq_batch(torch.from_numpy(ref[None, :n]).to(cpu),
                             torch.from_numpy(est[None, :n]).to(cpu), fs)[0])
    return score if np.isfinite(score) else None


def _crude_align(ref: np.ndarray, est: np.ndarray,
                 max_shift_s: float = 0.5, fs: int = 16000) -> np.ndarray:
    """Shift `est` to the delay that maximises the cross-correlation of
    64-sample envelopes (a stand-in for P.862's utterance alignment;
    separation outputs are normally sample-aligned, giving shift 0)."""
    n = min(len(ref), len(est))
    hop = 64
    n -= n % hop
    env_r = np.abs(ref[:n]).reshape(-1, hop).mean(-1)
    env_e = np.abs(est[:n]).reshape(-1, hop).mean(-1)
    max_lag = int(max_shift_s * fs / hop)
    pad = np.zeros(max_lag, env_r.dtype)
    xr = np.concatenate([pad, env_r - env_r.mean(), pad])
    corr = np.correlate(xr, env_e - env_e.mean(), mode="valid")
    lag = (int(np.argmax(corr)) - max_lag) * hop
    if lag == 0:
        return est
    if lag > 0:  # est is early: delay it
        return np.concatenate([np.zeros(lag, est.dtype), est[:-lag]])
    return np.concatenate([est[-lag:], np.zeros(-lag, est.dtype)])


def cal_PESQ_norm(est: np.ndarray, ref: np.ndarray, fs: int = 16000
                  ) -> Optional[float]:
    """PESQ mapped to (0, 1): (pesq + 0.5) / 5, or None."""
    p = cal_PESQ(est, ref, fs)
    return None if p is None else (p + 0.5) / 5.0
