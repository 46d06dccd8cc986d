"""Throughput counters for train loops (the ThroughputMeter of
wesep_tpu/utils/profiling.py; tracing is not ported)."""

import time
from typing import Optional

__all__ = ["ThroughputMeter"]


class ThroughputMeter:
    """Tracks steps and audio-seconds; reports throughput per device."""

    def __init__(self, sample_rate: int = 16000,
                 n_chips: Optional[int] = None):
        self.sample_rate = sample_rate
        self.n_chips = n_chips or 1
        self.reset()

    def reset(self):
        self.steps = 0
        self.audio_sec = 0.0
        self.start = time.perf_counter()

    def update(self, batch):
        """Call once per step with the (host) batch dict."""
        wav = batch.get("wav_mix")
        if wav is not None and hasattr(wav, "shape") and len(wav.shape) == 2:
            self.audio_sec += wav.shape[0] * wav.shape[1] / self.sample_rate
        self.steps += 1

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.start

    def audio_sec_per_sec(self) -> float:
        return self.audio_sec / max(self.elapsed, 1e-9)

    def audio_sec_per_sec_per_chip(self) -> float:
        return self.audio_sec_per_sec() / max(self.n_chips, 1)

    def summary(self) -> str:
        return (
            f"{self.steps} steps, {self.audio_sec:.0f} audio-s in "
            f"{self.elapsed:.1f}s -> {self.audio_sec_per_sec():.1f} "
            f"audio-s/s ({self.audio_sec_per_sec_per_chip():.1f}/chip)"
        )
