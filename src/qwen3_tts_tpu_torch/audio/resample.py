"""Sample-rate conversion of a cloning reference (the JAX package's
audio/resample.py ``resample``, its scipy path): a windowed-sinc polyphase
resampler."""

from __future__ import annotations

import math

import numpy as np


def resample(samples: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Polyphase resample float32 mono audio from src_rate to dst_rate."""
    if src_rate == dst_rate:
        return np.asarray(samples, dtype=np.float32)
    from scipy.signal import resample_poly  # only when rates differ

    g = math.gcd(int(src_rate), int(dst_rate))
    up, down = dst_rate // g, src_rate // g
    out = resample_poly(np.asarray(samples, dtype=np.float64), up, down)
    return out.astype(np.float32)
