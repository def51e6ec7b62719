"""Minimal RIFF WAV I/O, 16-bit PCM and float32 (numpy copy of
``rsrgan_tpu/sim/wavio.py``; the bytes written are the same)."""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (samples float32 in 16-bit PCM scale [-32768, 32767], rate).

    Kaldi reads wavs at this scale; feature parity depends on it.
    """
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 65536.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) * 256.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data, rate


def write_wav(path: str, samples: np.ndarray, rate: int = 16000) -> None:
    """Write float samples (16-bit PCM scale) as 16-bit PCM."""
    clipped = np.clip(np.asarray(samples), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(clipped.tobytes())
