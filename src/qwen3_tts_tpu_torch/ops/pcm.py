"""Device-side 16-bit PCM quantization.

``wav_to_pcm16`` matches the JAX package's ops/pcm.py bit for bit: clamp to
[-1, 1], scale by 32767, round half away from zero, truncate-cast, all in
float32.
"""

from __future__ import annotations

import numpy as np
import torch


def wav_to_pcm16(x: torch.Tensor) -> torch.Tensor:
    """Float waveform in [-1, 1] -> int16 PCM."""
    scaled = torch.clamp(x.float(), -1.0, 1.0) * 32767.0
    adj = torch.where(scaled >= 0, scaled + 0.5, scaled - 0.5)
    return adj.to(torch.int16)  # float->int converts toward zero (as C)


def pcm16_to_f32(x) -> np.ndarray:
    """Host-side int16 PCM -> float32 in [-1, 1], the exact inverse of
    ``wav_to_pcm16`` (divides by 32767)."""
    return np.asarray(x, np.float32) / np.float32(32767.0)
