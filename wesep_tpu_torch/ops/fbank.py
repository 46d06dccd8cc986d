"""Log-mel filterbank features of waveforms, batched, in torch ops.

Counterpart of wesep_tpu/ops/fbank.py (the port keeps its own copy of the
mel banks, which are numpy there):

  * `kaldi_fbank`: Kaldi's fbank (window_type hamming, use_energy false):
    snip-edges framing (1 + (T - win) // hop frames) -> dither -> DC
    removal -> pre-emphasis 0.97 (the first sample against itself) ->
    the symmetric Hamming window (denominator win - 1) -> zero-pad to the
    next power of two -> power spectrum -> Kaldi's mel triangles (the
    Nyquist bin dropped) -> log, floored at f32 machine eps. What the data
    chain computes for every enrollment wav and the SSA pass for every
    estimate;
  * `melspectrogram`: torchaudio's MelSpectrogram (center/reflect STFT,
    the periodic Hamming window, HTK mel scale, no norm), and
    `speaker_feat`, the joint models' "consistent" speaker frontend on it:
    reflect-padded pre-emphasis -> mel -> log(+1e-8) -> minus the mean
    over time;
  * `apply_cmvn`: per-utterance mean (and variance) normalisation over
    time.

The spectra come from torch.fft / torch.stft (cuFFT on the card), and the
mel products are f32 torch.matmul, which runs without TF32 unless a caller
turns `torch.backends.cuda.matmul.allow_tf32` on: the JAX package computes
them at Precision.HIGHEST. Shapes: wav [B, T] (or [T]) -> feats
[B, n_frames, n_mels] (or [n_frames, n_mels]).
"""

import functools
import math

import numpy as np
import torch

from wesep_tpu_torch.ops.stft import hamming_window, stft

__all__ = ["kaldi_mel_banks", "htk_mel_banks", "kaldi_fbank",
           "melspectrogram", "speaker_feat", "apply_cmvn"]

_EPS_F32 = float(np.finfo(np.float32).eps)


def _mel_kaldi(hz):
    return 1127.0 * np.log(1.0 + np.asarray(hz, np.float64) / 700.0)


def _mel_htk(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, np.float64) / 700.0)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@functools.lru_cache(maxsize=32)
def kaldi_mel_banks(num_bins: int, window_length_padded: int,
                    sample_freq: float, low_freq: float = 20.0,
                    high_freq: float = 0.0) -> np.ndarray:
    """Kaldi's mel triangles, [window_length_padded // 2, num_bins] f64
    (the Nyquist bin excluded); high_freq <= 0 counts down from Nyquist.
    Read only: the cache hands every caller the same array."""
    num_fft_bins = window_length_padded // 2
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    fft_bin_width = sample_freq / window_length_padded
    mel_low, mel_high = _mel_kaldi(low_freq), _mel_kaldi(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    bin_id = np.arange(num_bins, dtype=np.float64)[:, None]
    left = mel_low + bin_id * mel_delta
    center = mel_low + (bin_id + 1.0) * mel_delta
    right = mel_low + (bin_id + 2.0) * mel_delta
    mel = _mel_kaldi(
        fft_bin_width * np.arange(num_fft_bins, dtype=np.float64))[None, :]
    up = (mel - left) / (center - left)
    down = (right - mel) / (right - center)
    bank = np.maximum(0.0, np.minimum(up, down)).T
    bank.flags.writeable = False
    return bank


@functools.lru_cache(maxsize=32)
def htk_mel_banks(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                  sample_rate: float) -> np.ndarray:
    """torchaudio's melscale_fbanks(mel_scale="htk", norm=None),
    [n_freqs, n_mels] f64. Read only, as `kaldi_mel_banks`."""
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_mel_htk(f_min), _mel_htk(f_max), n_mels + 2)
    f_pts = 700.0 * (10.0 ** (m_pts / 2595.0) - 1.0)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    bank = np.maximum(0.0, np.minimum(down, up))
    bank.flags.writeable = False
    return bank


def _bank(bank: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.asarray(bank, np.float32)).to(like.device)


def kaldi_fbank(wav: torch.Tensor, sample_rate: int = 16000,
                num_mel_bins: int = 80, frame_length_ms: float = 25.0,
                frame_shift_ms: float = 10.0, dither: float = 0.0,
                preemphasis: float = 0.97, remove_dc_offset: bool = True,
                low_freq: float = 20.0, high_freq: float = 0.0,
                generator: torch.Generator | None = None,
                input_scale: float = 1.0) -> torch.Tensor:
    """Kaldi log-mel fbank of [B, T] (or [T]) -> [B, n_frames,
    num_mel_bins], f32 whatever wav's dtype.

    `input_scale` multiplies the waveform first (32768: the int16 scale of
    Kaldi's input). Dither adds `dither` times standard normal noise drawn
    from `generator` (which must be on wav's device); without a generator,
    or at dither 0, there is none."""
    squeeze = wav.dim() == 1
    if squeeze:
        wav = wav[None]
    wav = wav.float() * input_scale
    win = int(sample_rate * frame_length_ms / 1000.0)
    hop = int(sample_rate * frame_shift_ms / 1000.0)
    padded = _next_pow2(win)
    frames = wav.unfold(-1, win, hop)  # [B, NF, win], snip edges
    if dither > 0.0 and generator is not None:
        frames = frames + dither * torch.randn(
            frames.shape, generator=generator, device=frames.device)
    if remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis * prev
    n = torch.arange(win, dtype=torch.float64, device=frames.device)
    window = (0.54 - 0.46 * torch.cos(2.0 * math.pi * n / (win - 1))).float()
    spec = torch.fft.rfft(frames * window, n=padded)
    power = spec.real.square() + spec.imag.square()  # [B, NF, padded/2 + 1]
    bank = kaldi_mel_banks(num_mel_bins, padded, float(sample_rate),
                           low_freq, high_freq)
    mel = torch.matmul(power[..., :-1], _bank(bank, power))
    feats = torch.log(mel.clamp_min(_EPS_F32))
    return feats[0] if squeeze else feats


def melspectrogram(wav: torch.Tensor, sample_rate: int = 16000,
                   n_fft: int = 512, hop_length: int = 128,
                   f_min: float = 20.0, f_max: float | None = None,
                   n_mels: int = 80, window: torch.Tensor | None = None,
                   power: float = 2.0) -> torch.Tensor:
    """torchaudio MelSpectrogram (center/reflect, periodic Hamming window
    by default, HTK mel scale, norm None) -> [B, n_frames, n_mels], f32.
    The power spectrum is formed in wav's dtype, as the JAX package's."""
    if window is None:
        window = hamming_window(n_fft, device=wav.device)
    if f_max is None:
        f_max = sample_rate / 2.0
    re, im = stft(wav, n_fft, hop_length, window=window)
    spec = re * re + im * im
    if power != 2.0:
        spec = torch.pow(torch.sqrt(spec), power)
    bank = htk_mel_banks(n_fft // 2 + 1, f_min, f_max, n_mels,
                         float(sample_rate))
    return torch.matmul(spec.float(), _bank(bank, spec))


def speaker_feat(wav: torch.Tensor, sample_rate: int = 16000,
                 n_fft: int = 512, hop_length: int = 128, n_mels: int = 80,
                 preemph_coef: float = 0.97) -> torch.Tensor:
    """The "consistent" speaker-encoder frontend: reflect-padded
    pre-emphasis -> `melspectrogram` -> log(mel + 1e-8) -> minus each mel
    bin's mean over time -> [B, n_frames, n_mels] (or [n_frames, n_mels]).
    The caller decides whether gradients flow through it."""
    squeeze = wav.dim() == 1
    if squeeze:
        wav = wav[None]
    padded = torch.cat([wav[..., 1:2], wav], dim=-1)  # reflect pad by 1
    emph = padded[..., 1:] - preemph_coef * padded[..., :-1]
    mel = melspectrogram(emph, sample_rate=sample_rate, n_fft=n_fft,
                         hop_length=hop_length, n_mels=n_mels)
    logmel = torch.log(mel + 1e-8)
    logmel = logmel - logmel.mean(dim=-2, keepdim=True)
    return logmel[0] if squeeze else logmel


def apply_cmvn(feats: torch.Tensor, norm_mean: bool = True,
               norm_var: bool = False) -> torch.Tensor:
    """Per-utterance mean (and variance) normalisation over time (-2)."""
    if norm_mean:
        feats = feats - feats.mean(dim=-2, keepdim=True)
    if norm_var:
        feats = feats / torch.sqrt(
            feats.var(dim=-2, unbiased=False, keepdim=True) + 1e-8)
    return feats
