"""Energy-based voice activity detection (numpy).

Counterpart of wesep_tpu/data/vad.py: frame energies, a threshold at
their 25 % quantile, runs of speech frames -> segments. The extractor
(cli/extractor.py) trims an enrollment's silence with it.
"""

from typing import List, Tuple

import numpy as np

__all__ = ["VoiceActivityDetection", "energy_vad_segments", "trim_silence"]


def energy_vad_segments(
    wav: np.ndarray,
    sample_rate: int = 16000,
    frame_ms: float = 25.0,
    hop_ms: float = 10.0,
    quantile: float = 0.25,
    min_speech_ms: float = 100.0,
) -> List[Tuple[int, int]]:
    """-> [(start_sample, end_sample)] of the speech segments (the whole
    wav when none is found)."""
    wav = np.asarray(wav, np.float64).reshape(-1)
    frame = int(sample_rate * frame_ms / 1000)
    hop = int(sample_rate * hop_ms / 1000)
    if len(wav) < frame:
        return [(0, len(wav))]
    n = 1 + (len(wav) - frame) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    energies = np.sum(wav[idx] ** 2, axis=1)
    threshold = max(float(np.quantile(energies, quantile)), 1e-8)
    speech = energies > threshold
    segments = []
    start = None
    for i, s in enumerate(speech):
        if s and start is None:
            start = i
        elif not s and start is not None:
            segments.append((start * hop, i * hop + frame))
            start = None
    if start is not None:
        segments.append((start * hop, len(wav)))
    min_len = int(sample_rate * min_speech_ms / 1000)
    return [(a, b) for a, b in segments if b - a >= min_len] or [
        (0, len(wav))]


def trim_silence(wav: np.ndarray, sample_rate: int = 16000) -> np.ndarray:
    """The speech segments of `wav`, concatenated."""
    segs = energy_vad_segments(wav, sample_rate)
    return np.concatenate([wav[a:b] for a, b in segs])


class VoiceActivityDetection:
    """Speech-dominant slices of a waveform."""

    def __init__(self, wave: np.ndarray, sample_rate: int = 16000):
        self.wave = np.asarray(wave).reshape(-1)
        self.sample_rate = sample_rate

    def select(self, slice_len: float = 4.0) -> List[np.ndarray]:
        """The speech, cut into slices of `slice_len` seconds (the last
        zero-padded; one slice of zeros when there is none)."""
        sr = self.sample_rate
        segs = energy_vad_segments(self.wave, sr)
        speech = np.concatenate([self.wave[a:b] for a, b in segs])
        size = int(slice_len * sr)
        out = []
        for start in range(0, max(len(speech), 1), size):
            chunk = speech[start:start + size]
            if len(chunk) == 0:
                continue
            if len(chunk) < size:
                chunk = np.concatenate([chunk, np.zeros(size - len(chunk))])
            out.append(chunk)
        if not out:
            out.append(np.zeros(size))
        return out
