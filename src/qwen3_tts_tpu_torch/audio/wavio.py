"""WAV writing on top of the stdlib ``wave`` module + numpy (copied from
the JAX package's audio/wavio.py). The engine's output contract is mono
16-bit PCM at 24 kHz.
"""

from __future__ import annotations

import wave

import numpy as np


def f32_to_i16(samples: np.ndarray) -> np.ndarray:
    """Float [-1, 1] -> int16: clamp, scale by 32767, round half away from
    zero, truncate (bit-identical to ops.pcm.wav_to_pcm16)."""
    x = np.ascontiguousarray(samples, dtype=np.float32)
    scaled = np.clip(x, -1.0, 1.0) * np.float32(32767.0)
    adj = np.where(scaled >= 0, scaled + np.float32(0.5), scaled - np.float32(0.5))
    return adj.astype(np.int16)


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write float samples in [-1, 1] (or int16) as mono/multi-channel 16-bit
    PCM WAV."""
    arr = np.asarray(samples)
    if arr.ndim == 1:
        ch = 1
    elif arr.ndim == 2:
        ch = arr.shape[1]
    else:
        raise ValueError(f"samples must be 1-D or 2-D, got shape {arr.shape}")
    pcm = arr if arr.dtype == np.int16 else f32_to_i16(arr.reshape(-1)).reshape(arr.shape)
    with wave.open(path, "wb") as w:
        w.setnchannels(ch)
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(pcm.tobytes())
