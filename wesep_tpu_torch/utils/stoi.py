"""STOI / ESTOI speech intelligibility in numpy and scipy.

The port's copy of wesep_tpu/utils/stoi.py: STOI (Taal et al., ICASSP
2011) and ESTOI (Jensen & Taal, TASLP 2016) as the pystoi package computes
them:

  resample to 10 kHz -> remove silent frames (40 dB dynamic range, 256-pt
  frames hop 128) -> STFT (256-pt hann frames zero-padded to 512) ->
  15 one-third-octave bands from 150 Hz -> 30-frame (384 ms) segments ->
  STOI: per-band clipped (-15 dB SDR) envelope correlation;
  ESTOI: per-segment row+column-normalized spectral correlation.
"""

import numpy as np
from scipy import signal as sp_signal

__all__ = ["stoi", "estoi"]

FS = 10000
N_FRAME = 256
NFFT = 512
NUMBAND = 15
MINFREQ = 150
N = 30  # segment length (frames)
BETA = -15.0  # SDR clip (dB)
DYN_RANGE = 40


def _thirdoct(fs, nfft, num_bands, min_freq):
    """One-third octave band matrix [num_bands, nfft//2+1]."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=float)
    cf = 2.0 ** (k / 3.0) * min_freq
    freq_low = min_freq * 2.0 ** ((2 * k - 1) / 6.0)
    freq_high = min_freq * 2.0 ** ((2 * k + 1) / 6.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        l_ii = np.argmin(np.square(f - freq_low[i]))
        h_ii = np.argmin(np.square(f - freq_high[i]))
        obm[i, l_ii:h_ii] = 1
    return obm, cf


def _resample(x, fs):
    if fs == FS:
        return x
    g = np.gcd(int(fs), FS)
    return sp_signal.resample_poly(x, FS // g, fs // g)


def _remove_silent_frames(x, y, dyn_range, framelen, hop):
    w = np.hanning(framelen + 2)[1:-1]
    n_frames = (len(x) - framelen) // hop + 1
    frames = np.array(
        [x[i * hop : i * hop + framelen] * w for i in range(n_frames)]
    )
    energies = 20 * np.log10(
        np.linalg.norm(frames, axis=1) / np.sqrt(framelen) + 1e-20
    )
    mask = energies > (np.max(energies) - dyn_range)
    frames_y = np.array(
        [y[i * hop : i * hop + framelen] * w for i in range(n_frames)]
    )
    x_frames = frames[mask]
    y_frames = frames_y[mask]
    # overlap-add back
    n_keep = x_frames.shape[0]
    out_len = framelen + (n_keep - 1) * hop if n_keep else 0
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    for i in range(n_keep):
        xs[i * hop : i * hop + framelen] += x_frames[i]
        ys[i * hop : i * hop + framelen] += y_frames[i]
    return xs, ys


def _stft_frames(x, framelen=N_FRAME, hop=N_FRAME // 2, nfft=NFFT):
    w = np.hanning(framelen + 2)[1:-1]
    n_frames = (len(x) - framelen) // hop + 1
    if n_frames <= 0:
        return np.zeros((0, nfft // 2 + 1))
    frames = np.array(
        [x[i * hop : i * hop + framelen] * w for i in range(n_frames)]
    )
    return np.fft.rfft(frames, n=nfft, axis=1)


def _band_envelopes(x, obm):
    spec = _stft_frames(x)
    return np.sqrt(np.maximum(obm @ (np.abs(spec.T) ** 2), 1e-20))  # [J, M]


def stoi(ref, est, fs: int = 16000, extended: bool = False) -> float:
    """STOI in [~0, 1]; extended=True computes ESTOI."""
    ref = np.asarray(ref, np.float64).reshape(-1)
    est = np.asarray(est, np.float64).reshape(-1)
    if ref.shape != est.shape:
        raise ValueError(f"shapes differ: {ref.shape} vs {est.shape}")
    x = _resample(ref, fs)
    y = _resample(est, fs)
    x, y = _remove_silent_frames(x, y, DYN_RANGE, N_FRAME, N_FRAME // 2)
    if len(x) < N_FRAME * 2:
        return float("nan")
    obm, _ = _thirdoct(FS, NFFT, NUMBAND, MINFREQ)
    X = _band_envelopes(x, obm)  # [J, M]
    Y = _band_envelopes(y, obm)
    m_frames = X.shape[1]
    if m_frames < N:
        return float("nan")

    if not extended:
        c = 10 ** (-BETA / 20.0)
        d_sum = 0.0
        count = 0
        for m in range(N - 1, m_frames):
            Xseg = X[:, m - N + 1 : m + 1]  # [J, N]
            Yseg = Y[:, m - N + 1 : m + 1]
            alpha = np.sqrt(
                np.sum(Xseg**2, axis=1, keepdims=True)
                / np.maximum(np.sum(Yseg**2, axis=1, keepdims=True), 1e-20)
            )
            Yprime = np.minimum(alpha * Yseg, Xseg * (1 + c))
            xn = Xseg - Xseg.mean(axis=1, keepdims=True)
            yn = Yprime - Yprime.mean(axis=1, keepdims=True)
            num = np.sum(xn * yn, axis=1)
            den = np.linalg.norm(xn, axis=1) * np.linalg.norm(yn, axis=1)
            d_sum += np.sum(num / np.maximum(den, 1e-20))
            count += NUMBAND
        return float(d_sum / count)

    # ESTOI
    d_sum = 0.0
    count = 0
    for m in range(N - 1, m_frames):
        Xseg = X[:, m - N + 1 : m + 1]
        Yseg = Y[:, m - N + 1 : m + 1]
        # row (band) normalization
        Xr = Xseg - Xseg.mean(axis=1, keepdims=True)
        Xr = Xr / np.maximum(np.linalg.norm(Xr, axis=1, keepdims=True), 1e-20)
        Yr = Yseg - Yseg.mean(axis=1, keepdims=True)
        Yr = Yr / np.maximum(np.linalg.norm(Yr, axis=1, keepdims=True), 1e-20)
        # column (frame) normalization
        Xc = Xr - Xr.mean(axis=0, keepdims=True)
        Xc = Xc / np.maximum(np.linalg.norm(Xc, axis=0, keepdims=True), 1e-20)
        Yc = Yr - Yr.mean(axis=0, keepdims=True)
        Yc = Yc / np.maximum(np.linalg.norm(Yc, axis=0, keepdims=True), 1e-20)
        d_sum += np.sum(Xc * Yc) / N
        count += 1
    return float(d_sum / count)


def estoi(ref, est, fs: int = 16000) -> float:
    """ESTOI: stoi(..., extended=True)."""
    return stoi(ref, est, fs, extended=True)
