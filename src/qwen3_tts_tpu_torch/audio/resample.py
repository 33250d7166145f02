"""Sample-rate conversion and audio-format normalisation (the JAX
package's audio/resample.py).

``resample`` runs the native windowed-sinc kernel (``native/``) when it is
built and scipy's polyphase ``resample_poly`` otherwise, as the JAX
package's does; ``QWEN3_TTS_NATIVE=never`` forces scipy. ``convert_to_wav``
prefers ffmpeg where the host has it, then decodes a WAV itself.
"""

from __future__ import annotations

import math
import os
import shutil
import subprocess
import tempfile
import wave

import numpy as np

from .wavio import read_wav, to_mono, wav_info, write_wav

#: extensions the built-in WAV path can read directly
_WAV_EXTS = {".wav", ".wave"}


def resample(samples: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Polyphase resample float32 mono audio from src_rate to dst_rate."""
    if src_rate == dst_rate:
        return np.asarray(samples, dtype=np.float32)
    from ..native import resample_native

    out = resample_native(samples, int(src_rate), int(dst_rate))
    if out is not None:
        return out
    from scipy.signal import resample_poly  # only when rates differ

    g = math.gcd(int(src_rate), int(dst_rate))
    up, down = dst_rate // g, src_rate // g
    out = resample_poly(np.asarray(samples, dtype=np.float64), up, down)
    return out.astype(np.float32)


def _convert_with_ffmpeg(input_path: str, out_path: str, sample_rate: int) -> bool:
    """ffmpeg -> mono 16-bit PCM WAV at sample_rate. Returns success."""
    try:
        proc = subprocess.run(
            [
                "ffmpeg", "-y", "-v", "error",
                "-i", input_path,
                "-ar", str(sample_rate),
                "-ac", "1",
                "-c:a", "pcm_s16le",
                out_path,
            ],
            capture_output=True,
            timeout=120,
        )
        return proc.returncode == 0 and os.path.exists(out_path)
    except (OSError, subprocess.SubprocessError):
        return False


def convert_to_wav(input_path: str, sample_rate: int = 24_000) -> str | None:
    """Normalise an audio file to mono 16-bit PCM WAV at ``sample_rate``.

    - a WAV already in that format is passed through: its own path comes
      back, and the caller must NOT delete it;
    - otherwise a new temp file is written and its path returned (the
      caller owns and deletes it);
    - ``None`` on failure.
    """
    if not os.path.exists(input_path):
        return None

    ext = os.path.splitext(input_path)[1].lower()

    if ext in _WAV_EXTS:
        try:
            info = wav_info(input_path)
        except (OSError, EOFError, wave.Error):  # malformed: convert it
            info = None
        if (
            info is not None
            and info.sample_rate == sample_rate
            and info.channels == 1
            and info.sampwidth == 2
        ):
            return input_path

    fd, out_path = tempfile.mkstemp(prefix="q3tts_conv_", suffix=".wav")
    os.close(fd)

    # 1) ffmpeg first, for container formats and as the generic path
    if shutil.which("ffmpeg") is not None and _convert_with_ffmpeg(
            input_path, out_path, sample_rate):
        return out_path

    # 2) built-in: stdlib WAV decode, downmix, resample
    if ext in _WAV_EXTS:
        try:
            data, rate = read_wav(input_path)
            write_wav(out_path, resample(to_mono(data), rate, sample_rate),
                      sample_rate)
            return out_path
        except (OSError, EOFError, ValueError, wave.Error):
            pass

    try:
        os.remove(out_path)
    except OSError:
        pass
    return None
