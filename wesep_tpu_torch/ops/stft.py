"""STFT / iSTFT in the JAX package's layout.

Counterpart of wesep_tpu/ops/stft.py. The JAX package writes the (i)STFT as
framed matmuls against a windowed Fourier basis, outside any Pallas kernel;
here torch.stft / torch.istft compute the same transform (center=True,
reflect padding, periodic Hann or Hamming window). Spectrograms keep the JAX layout:
a (real, imag) pair of [B, T_frames, F] tensors, frequency last.
"""

import math

import torch

__all__ = ["hann_window", "hamming_window", "stft", "istft"]


def hann_window(n: int, dtype=torch.float32, device=None):
    """Periodic Hann window (torch.hann_window(n) semantics)."""
    k = torch.arange(n, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)).to(dtype)


def hamming_window(n: int, dtype=torch.float32, device=None):
    """Periodic Hamming window (torch.hamming_window(n) semantics)."""
    k = torch.arange(n, dtype=torch.float64, device=device)
    return (0.54 - 0.46 * torch.cos(2.0 * math.pi * k / n)).to(dtype)


def stft(x, n_fft: int, hop_length: int, window=None):
    """[B, T] -> (re, im), each [B, n_frames, n_fft // 2 + 1], x's dtype;
    center=True with reflect padding. A window shorter than n_fft is
    zero-padded to n_fft, centred (the left pad is the smaller one). The
    transform and its backward run in f32 whatever x's dtype."""
    if window is None:
        window = hann_window(n_fft, device=x.device)
    if window.shape[0] < n_fft:
        left = (n_fft - window.shape[0]) // 2
        window = torch.nn.functional.pad(
            window, (left, n_fft - window.shape[0] - left))
    spec = torch.stft(
        x.float(), n_fft, hop_length, window=window.float(), center=True,
        pad_mode="reflect", return_complex=True,
    ).transpose(-1, -2)
    return spec.real.to(x.dtype), spec.imag.to(x.dtype)


def istft(re, im, n_fft: int, hop_length: int, window=None,
          length: int | None = None):
    """(re, im) [B, n_frames, F] -> [B, T], inverse of `stft`
    (torch.istft semantics, center=True; `length` crops or pads)."""
    if window is None:
        window = hann_window(n_fft, device=re.device)
    spec = torch.complex(re.float(), im.float()).transpose(-1, -2)
    y = torch.istft(
        spec, n_fft, hop_length, window=window.float(), center=True,
        length=length,
    )
    return y.to(re.dtype)
