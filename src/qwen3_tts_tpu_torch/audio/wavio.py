"""WAV reading and writing on top of the stdlib ``wave`` module + numpy
(the JAX package's audio/wavio.py). The engine's output contract is mono
16-bit PCM at 24 kHz; a cloning reference may be any 8/16/24/32-bit PCM
WAV. 16-bit decode, the float -> int16 quantizer and the downmix run in
the native library (``native/``) when it is built, in numpy otherwise.
"""

from __future__ import annotations

import wave
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class WavInfo:
    sample_rate: int
    channels: int
    sampwidth: int          # bytes per sample
    num_frames: int

    @property
    def duration_s(self) -> float:
        return self.num_frames / float(self.sample_rate)


def wav_info(path: str) -> WavInfo:
    with wave.open(path, "rb") as w:
        return WavInfo(
            sample_rate=w.getframerate(),
            channels=w.getnchannels(),
            sampwidth=w.getsampwidth(),
            num_frames=w.getnframes(),
        )


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
    if arr.dtype == np.int16:
        pcm = arr
    else:
        from ..native import f32_to_i16

        pcm = f32_to_i16(arr.reshape(-1)).reshape(arr.shape)
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
        from ..native import i16_to_f32

        data = i16_to_f32(np.frombuffer(raw, dtype="<i2"))
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
        from ..native import downmix_mono

        arr = downmix_mono(arr)
    return arr
