"""Optional automatic transcription of reference audio (ASR providers),
the JAX package's transcription.py.

A provider takes the path of a mono 16-bit WAV and returns text or None.
Registered providers are tried first, in registration order; then, when a
Whisper checkpoint directory is on disk (QWEN3_TTS_ASR_MODEL, or
``models/asr/``), the backend that QWEN3_TTS_ASR_BACKEND names:

- unset or ``jax`` (the JAX package's value for its own Whisper): this
  package's Whisper (``models/whisper.py``), the model cached per
  directory;
- ``torch``: the ``transformers`` ASR pipeline.

Unlike the JAX package, a failure of the package's own Whisper does not
fall through to the transformers pipeline: the pipeline runs only when the
knob asks for it. With no provider available, ``asr_available()`` is False
and every call returns None.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

# A provider takes a path to a mono 16-bit WAV and returns text or None.
Provider = Callable[[str], Optional[str]]

_providers: dict[str, Provider] = {}


def register_provider(name: str, fn: Provider) -> None:
    """Register an ASR provider (an application can plug in its own)."""
    _providers[name] = fn


_asr_cache: dict[str, object] = {}


def _whisper_provider(wav_path: str) -> str | None:
    """Transcribe with this package's Whisper (models/whisper.py), loaded
    once per checkpoint directory; None when it fails."""
    model_dir = _whisper_model_dir()
    if model_dir is None:
        return None
    try:
        asr = _asr_cache.get(model_dir)
        if asr is None:
            from .models.whisper import WhisperASR

            asr = _asr_cache[model_dir] = WhisperASR(model_dir)
        return asr.transcribe_wav(wav_path) or None
    except Exception:
        return None


def _whisper_transformers_provider(wav_path: str) -> str | None:
    """Transcribe with the local checkpoint through the transformers ASR
    pipeline on the CPU (QWEN3_TTS_ASR_BACKEND=torch); None when it fails,
    as where transformers is not installed."""
    model_dir = _whisper_model_dir()
    if model_dir is None:
        return None
    try:
        import numpy as np
        from transformers import pipeline

        from .audio import read_wav, resample, to_mono

        data, rate = read_wav(wav_path)
        audio16k = resample(to_mono(data), rate, 16_000).astype(np.float32)
        asr = pipeline(
            "automatic-speech-recognition", model=model_dir, device="cpu"
        )
        out = asr({"array": audio16k, "sampling_rate": 16_000})
        text = (out or {}).get("text", "").strip()
        return text or None
    except Exception:
        return None


def _whisper_model_dir() -> str | None:
    """A local ASR checkpoint directory, if the user provided one via
    QWEN3_TTS_ASR_MODEL or dropped one into models/asr/."""
    env = os.environ.get("QWEN3_TTS_ASR_MODEL")
    if env and os.path.isdir(env):
        return env
    from . import config

    local = os.path.join(config.MODELS_DIR, "asr")
    if os.path.isdir(local) and os.listdir(local):
        return local
    return None


def available_providers() -> list[str]:
    names = list(_providers)
    if _whisper_model_dir() is not None:
        names.append("whisper-local")
    return names


def asr_available() -> bool:
    """Whether any provider can run (evaluated on each call: providers can
    be registered after import)."""
    return bool(available_providers())


ASR_AVAILABLE = asr_available()  # import-time snapshot


def transcribe_wav(wav_path: str) -> str | None:
    """Transcribe ``wav_path`` with the first working provider, or None."""
    if not os.path.exists(wav_path):
        return None
    for fn in _providers.values():
        text = fn(wav_path)
        if text:
            return text
    if _whisper_model_dir() is None:
        return None
    if os.environ.get("QWEN3_TTS_ASR_BACKEND", "jax") == "torch":
        return _whisper_transformers_provider(wav_path)
    return _whisper_provider(wav_path)


def offer_transcribe(wav_path: str) -> str | None:
    """Ask the user whether to auto-transcribe; returns the transcript or
    None (None at once when no provider is available). The terminal UI is
    imported here, so this module stays free of it."""
    if not asr_available():
        return None
    from .ui import console, safe_line_input

    console.print(
        "[accent]Auto-transcribe this audio with the local ASR model? "
        "(y/n)[/accent]"
    )
    try:
        if safe_line_input("> ").strip().lower() not in ("y", "yes"):
            return None
    except (EOFError, KeyboardInterrupt):
        return None
    with console.status("[accent]Transcribing…[/accent]"):
        text = transcribe_wav(wav_path)
    if text:
        console.print(f"[ok]Transcript:[/ok] {text}")
    else:
        console.print("[warn]Transcription produced no text.[/warn]")
    return text
