"""WAV reading and writing on top of the stdlib ``wave`` module + numpy
(copied from the JAX package's audio/wavio.py, its numpy paths). The
engine's output contract is mono 16-bit PCM at 24 kHz; a cloning reference
may be any 8/16/24/32-bit PCM WAV.
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


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a PCM WAV file -> (float32 samples in [-1, 1] shaped [n] or
    [n, ch], sample_rate). 8/16/24/32-bit integer PCM; 16-bit input scales
    by 1/32768 (the writer's 32767 is the decode side's)."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 1:  # unsigned 8-bit
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        as32 = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        as32 = np.where(as32 >= 1 << 23, as32 - (1 << 24), as32)
        data = as32.astype(np.float32) / float(1 << 23)
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / float(1 << 31)
    else:
        raise ValueError(f"unsupported WAV sample width: {width} bytes")
    if ch > 1:
        data = data.reshape(-1, ch)
    return data, rate


def to_mono(samples: np.ndarray) -> np.ndarray:
    """Average channels down to mono float32."""
    arr = np.asarray(samples, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr.mean(axis=1).astype(np.float32)
    return arr
