"""WAV read/write on numpy with the standard library only (the subset of
wesep_tpu/data/wav_io.py the serving path uses).

Waveforms are float32 in [-1, 1], shaped [channels, T].
"""

import io
import struct
import wave
from typing import Tuple

import numpy as np

__all__ = ["read_wav", "write_wav", "wav_bytes"]


def _pcm_to_float(raw: bytes, width: int) -> np.ndarray:
    if width == 2:
        return np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    if width == 4:
        return np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    if width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        xi = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
              | (b[:, 2].astype(np.int32) << 16))
        return (xi - ((xi & 0x800000) << 1)).astype(np.float32) / 8388608.0
    if width == 1:
        return (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    raise ValueError(f"unsupported sample width {width}")


def _read_riff_float(data: bytes) -> Tuple[np.ndarray, int]:
    """RIFF files the `wave` module rejects (IEEE float, extensible)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos, fmt, raw = 12, None, None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size % 2)
    if fmt is None or raw is None:
        raise ValueError("missing fmt/data chunk")
    audio_fmt, n_ch, sr, _, _, bits = fmt
    if audio_fmt == 3 or (audio_fmt == 0xFFFE and bits == 32):
        x = np.frombuffer(raw, "<f4").astype(np.float32)
    else:
        x = _pcm_to_float(raw, bits // 8)
    return x.reshape(-1, n_ch).T.copy(), sr


def read_wav(src) -> Tuple[np.ndarray, int]:
    """path, bytes or file object -> (waveform [C, T] float32, rate)."""
    if isinstance(src, bytes):
        data = src
    elif isinstance(src, str):
        with open(src, "rb") as f:
            data = f.read()
    else:
        data = src.read()
    try:
        with wave.open(io.BytesIO(data), "rb") as w:
            n_ch, width, sr = w.getnchannels(), w.getsampwidth(), w.getframerate()
            raw = w.readframes(w.getnframes())
    except wave.Error:
        return _read_riff_float(data)
    return _pcm_to_float(raw, width).reshape(-1, n_ch).T.copy(), sr


def _pcm16(wav: np.ndarray) -> np.ndarray:
    wav = np.asarray(wav)
    if wav.ndim == 1:
        wav = wav[None, :]
    if wav.dtype != np.int16:
        wav = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    return wav


def _write(target, wav: np.ndarray, sample_rate: int):
    wav = _pcm16(wav)
    with wave.open(target, "wb") as w:
        w.setnchannels(wav.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(wav.T.tobytes())


def write_wav(path: str, wav: np.ndarray, sample_rate: int):
    """Write float [-1, 1] (or int16) [T] / [C, T] as PCM16."""
    _write(path, wav, sample_rate)


def wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    """Encode as PCM16 wav bytes (for shard writers)."""
    buf = io.BytesIO()
    _write(buf, wav, sample_rate)
    return buf.getvalue()
