"""I/O + model management of the terminal app: paths, downloads, model
load, audio save, text input (the JAX package's io.py).

The engine and ``huggingface_hub`` are imported inside the functions that
use them, so this module, and everything above it, imports without torch
being initialised or the hub installed.
"""

from __future__ import annotations

import contextlib
import datetime as _dt
import os
import re
import shutil
import tempfile
import time

from . import config
from .audio import convert_to_wav, play_wav
from .ui import clear_screen, console

# Bound at import so tests can monkeypatch module globals.
MODELS_DIR = config.MODELS_DIR
BASE_OUTPUT_DIR = config.BASE_OUTPUT_DIR
AUTO_PLAY = config.AUTO_PLAY
FILENAME_MAX_LEN = config.FILENAME_MAX_LEN
MAX_TEXT_LENGTH = config.MAX_TEXT_LENGTH
ENGINE_AUDIO_NAME = "audio_000.wav"  # generate_audio's output file


def clean_path(raw: str) -> str:
    """Sanitise a (possibly drag-and-dropped) path: strip whitespace,
    quotes and shell escapes."""
    p = raw.strip().strip("'\"")
    p = p.replace("\\ ", " ")
    return os.path.expanduser(p)


def get_smart_path(folder_name: str) -> str | None:
    """Resolve a model folder under MODELS_DIR, in a flat layout or the
    Hugging Face snapshot layout ``<folder>/snapshots/<hash>/``.

    Returns the directory that actually contains model files, or None.
    """
    base = os.path.join(MODELS_DIR, folder_name)
    if not os.path.isdir(base):
        return None
    snap_root = os.path.join(base, "snapshots")
    if os.path.isdir(snap_root):
        for entry in sorted(os.listdir(snap_root)):
            if entry.startswith("."):
                continue
            candidate = os.path.join(snap_root, entry)
            if os.path.isdir(candidate):
                return candidate
        return None
    return base


def ensure_model(spec: "config.ModelSpec") -> str | None:
    """Return a local path for ``spec``, downloading from Hugging Face on
    first use. Ctrl-C during download removes the partial snapshot; any
    other failure returns None with an error message."""
    local = get_smart_path(spec.folder)
    if local is not None:
        return local

    target = os.path.join(MODELS_DIR, spec.folder)
    console.print(
        f"[accent]Model '{spec.name}' not found locally — downloading[/accent] "
        f"[dim]{spec.repo_id}[/dim]"
    )
    try:
        from huggingface_hub import snapshot_download

        snapshot_download(repo_id=spec.repo_id, local_dir=target)
    except KeyboardInterrupt:
        console.print("[warn]Download cancelled — removing partial files.[/warn]")
        shutil.rmtree(target, ignore_errors=True)
        return None
    except Exception as exc:  # offline, auth, disk, hub not installed
        console.print(f"[err]Download failed:[/err] {exc}")
        return None

    local = get_smart_path(spec.folder)
    if local is not None:
        console.print(f"[ok]Model ready:[/ok] [dim]{local}[/dim]")
    return local


def load_model_with_progress(model_path: str, display_name: str):
    """Load the engine's model with a spinner and quiet logs, on the CUDA
    device (the CPU under QWEN3_TTS_CPU=1). Returns the model, or None
    after an error line on the console."""
    from .engine import load_model
    from .server import model_device

    try:
        with console.status(f"[accent]Loading {display_name}…[/accent]"):
            with open(os.devnull, "w") as devnull, contextlib.redirect_stderr(devnull):
                model = load_model(model_path, device=model_device())
        console.print(f"[ok]{display_name} loaded.[/ok]")
        return model
    except FileNotFoundError as exc:
        console.print(f"[err]Model files missing:[/err] {exc}")
    except Exception as exc:  # the session reports it and returns
        console.print(f"[err]Failed to load {display_name}:[/err] {exc}")
    return None


def make_temp_dir() -> str:
    """Create a scratch dir for one generation."""
    return tempfile.mkdtemp(prefix="q3tts_gen_")


def cleanup_temp_dir(path: str) -> None:
    """Best-effort removal of a generation scratch dir."""
    shutil.rmtree(path, ignore_errors=True)


def _sanitize_snippet(text: str) -> str:
    snippet = re.sub(r"[^A-Za-z0-9 _-]", "", text).strip()
    snippet = re.sub(r"\s+", "_", snippet)
    return snippet[:FILENAME_MAX_LEN] or "audio"


def save_audio_file(temp_folder: str, subfolder: str, text_snippet: str) -> str | None:
    """Move the engine's ``audio_000.wav`` out of ``temp_folder`` into
    ``BASE_OUTPUT_DIR/subfolder`` under a timestamped, collision-safe name,
    optionally auto-playing it.

    Returns the final path, or None when the engine produced no audio.
    """
    produced = os.path.join(temp_folder, ENGINE_AUDIO_NAME)
    if not os.path.exists(produced):
        console.print("[err]No audio was generated.[/err]")
        return None

    out_dir = os.path.join(BASE_OUTPUT_DIR, subfolder)
    os.makedirs(out_dir, exist_ok=True)

    stamp = _dt.datetime.now().strftime("%H-%M-%S")
    base = f"{stamp}_{_sanitize_snippet(text_snippet)}"
    final = os.path.join(out_dir, base + ".wav")
    counter = 0
    while os.path.exists(final):
        counter += 1
        final = os.path.join(out_dir, f"{base}_{counter}.wav")

    shutil.move(produced, final)
    console.print(f"[ok]Saved:[/ok] [dim]{final}[/dim]")

    if AUTO_PLAY:
        play_wav(final)

    time.sleep(1)  # the saved line stays readable before the screen clears
    clear_screen()
    cleanup_temp_dir(temp_folder)
    return final


def get_text_input(prompt: str = "Enter text (or drag a .txt file)") -> str | None:
    """Read the text to synthesise: typed directly, or a drag-and-dropped
    ``.txt`` file path; enforces MAX_TEXT_LENGTH.

    Returns None when the user backs out (empty input / EOF).
    """
    from .ui import safe_line_input

    console.print(f"[accent]{prompt}[/accent] [dim](empty = back)[/dim]")
    try:
        raw = safe_line_input("> ")
    except (EOFError, KeyboardInterrupt):
        return None
    raw = raw.strip()
    if not raw:
        return None

    candidate = clean_path(raw)
    if candidate.lower().endswith(".txt") and os.path.exists(candidate):
        try:
            with open(candidate, "r", encoding="utf-8", errors="replace") as fh:
                raw = fh.read().strip()
            console.print(f"[dim]Loaded {len(raw)} characters from file.[/dim]")
        except OSError as exc:
            console.print(f"[err]Could not read file:[/err] {exc}")
            return None

    if len(raw) > MAX_TEXT_LENGTH:
        console.print(
            f"[warn]Text is {len(raw)} characters — truncating to "
            f"{MAX_TEXT_LENGTH}.[/warn]"
        )
        raw = raw[:MAX_TEXT_LENGTH]
    return raw or None


def convert_audio_if_needed(input_path: str, sample_rate: int = config.SAMPLE_RATE):
    """Normalise a user-supplied audio file to the engine's required format
    (mono 16-bit 24 kHz WAV), returning ``(path, is_temp)``; ``is_temp``
    tells the caller whether it owns (and must delete) the file."""
    result = convert_to_wav(input_path, sample_rate=sample_rate)
    if result is None:
        console.print(f"[err]Could not convert audio:[/err] {input_path}")
        return None, False
    return result, result != input_path
