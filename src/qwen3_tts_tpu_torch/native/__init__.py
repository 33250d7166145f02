"""ctypes bindings for the native C++ audio library (``audio_kernels.cpp``,
the JAX package's native/ library): a windowed-sinc resampler, f32 <-> i16
PCM, downmix and peak, on the host CPU.

The library builds at first use (``build.py``). Where the host has no C++
compiler, ``native_available()`` is False and every wrapper takes its
numpy path, as in the JAX package; a compile that fails raises.
``QWEN3_TTS_NATIVE=never`` sends every wrapper to its numpy path together
(read at each call). The numpy paths of f32_to_i16, i16_to_f32 and peak
are bit-identical to the kernels, and so is downmix's on two channels (on
more, numpy's float32 sum rounds more often than the kernel's double one).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

ABI_VERSION = 1

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_NO_COMPILER = False

_F32P = ctypes.POINTER(ctypes.c_float)
_I16P = ctypes.POINTER(ctypes.c_int16)
_LL, _INT = ctypes.c_longlong, ctypes.c_int
# symbol -> (restype, argtypes)
_SIGNATURES = {
    "q3tts_resample_out_len": (_LL, [_LL, _INT, _INT]),
    "q3tts_resample": (_LL, [_F32P, _LL, _INT, _INT, _F32P, _LL]),
    "q3tts_f32_to_i16": (None, [_F32P, _LL, _I16P]),
    "q3tts_i16_to_f32": (None, [_I16P, _LL, _F32P]),
    "q3tts_downmix_mono": (None, [_F32P, _LL, _INT, _F32P]),
    "q3tts_peak": (ctypes.c_float, [_F32P, _LL]),
}


def _load() -> ctypes.CDLL | None:
    """The bound library, built at the first call; None under
    QWEN3_TTS_NATIVE=never or on a host without a C++ compiler."""
    global _LIB, _NO_COMPILER
    if os.environ.get("QWEN3_TTS_NATIVE", "auto") == "never":
        return None
    with _LOCK:
        if _LIB is not None or _NO_COMPILER:
            return _LIB
        from .build import ensure_built

        path = ensure_built()
        if path is None:
            _NO_COMPILER = True
            return None
        lib = ctypes.CDLL(str(path))
        lib.q3tts_abi_version.restype = ctypes.c_int
        if lib.q3tts_abi_version() != ABI_VERSION:
            raise RuntimeError(
                f"{path}: ABI version {lib.q3tts_abi_version()}, "
                f"bindings expect {ABI_VERSION}")
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _i16ptr(a: np.ndarray):
    return a.ctypes.data_as(_I16P)


def resample_native(
    samples: np.ndarray, src_rate: int, dst_rate: int
) -> np.ndarray | None:
    """Windowed-sinc polyphase resample (float32 mono). None if unavailable
    or if the kernel refuses the arguments."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(samples, dtype=np.float32)
    n_out = lib.q3tts_resample_out_len(len(x), src_rate, dst_rate)
    out = np.empty(int(n_out), dtype=np.float32)
    written = lib.q3tts_resample(
        _fptr(x), len(x), src_rate, dst_rate, _fptr(out), len(out)
    )
    if written < 0:
        return None
    return out[: int(written)]


def f32_to_i16(samples: np.ndarray) -> np.ndarray:
    """Float [-1, 1] -> int16: clamp, scale by 32767, round half away from
    zero, truncate."""
    lib = _load()
    x = np.ascontiguousarray(samples, dtype=np.float32)
    if lib is None:
        scaled = np.clip(x, -1.0, 1.0) * np.float32(32767.0)
        adj = np.where(
            scaled >= 0, scaled + np.float32(0.5), scaled - np.float32(0.5)
        )
        return adj.astype(np.int16)
    out = np.empty(len(x), dtype=np.int16)
    lib.q3tts_f32_to_i16(_fptr(x), len(x), _i16ptr(out))
    return out


def i16_to_f32(samples: np.ndarray) -> np.ndarray:
    """int16 -> float32 scaled by 1/32768."""
    lib = _load()
    x = np.ascontiguousarray(samples, dtype=np.int16)
    if lib is None:
        return x.astype(np.float32) / 32768.0
    out = np.empty(len(x), dtype=np.float32)
    lib.q3tts_i16_to_f32(_i16ptr(x), len(x), _fptr(out))
    return out


def downmix_mono(samples: np.ndarray) -> np.ndarray:
    """Interleaved [frames, channels] (or [n]) float32 -> mono [frames]."""
    x = np.ascontiguousarray(samples, dtype=np.float32)
    if x.ndim == 1:
        return x
    frames, channels = x.shape
    lib = _load()
    if lib is None:
        return x.mean(axis=1).astype(np.float32)
    out = np.empty(frames, dtype=np.float32)
    lib.q3tts_downmix_mono(_fptr(x), frames, channels, _fptr(out))
    return out


def peak(samples: np.ndarray) -> float:
    """max |x| of a float32 buffer (0.0 when empty)."""
    x = np.ascontiguousarray(samples, dtype=np.float32)
    lib = _load()
    if lib is None:
        return float(np.max(np.abs(x))) if len(x) else 0.0
    return float(lib.q3tts_peak(_fptr(x), len(x)))
