"""Persistent voice library: enroll / list / pick / delete / update (the
JAX package's voices.py).

A saved voice is a ``<name>.wav`` + optional ``<name>.txt`` transcript pair
under VOICES_DIR. The HTTP daemon's voice endpoints call
``sanitize_voice_name``; the interactive flows print through the terminal
UI's console, which needs ``rich`` only when it first prints.
"""

from __future__ import annotations

import os
import re
import shutil

from . import config
from .io import clean_path, convert_audio_if_needed
from .transcription import asr_available, offer_transcribe
from .ui import confirm_overwrite, console, safe_line_input

VOICES_DIR = config.VOICES_DIR  # module global: tests point it elsewhere


def get_saved_voices() -> list[str]:
    """Sorted names of enrolled voices (wav files only)."""
    if not os.path.isdir(VOICES_DIR):
        return []
    names = [
        os.path.splitext(f)[0]
        for f in os.listdir(VOICES_DIR)
        if f.lower().endswith(".wav") and not f.startswith(".")
    ]
    return sorted(names)


def voice_paths(name: str) -> tuple[str, str]:
    """(wav_path, txt_path) for a voice name."""
    return (
        os.path.join(VOICES_DIR, f"{name}.wav"),
        os.path.join(VOICES_DIR, f"{name}.txt"),
    )


def load_voice_transcript(name: str) -> str | None:
    _, txt = voice_paths(name)
    if os.path.exists(txt):
        try:
            with open(txt, "r", encoding="utf-8", errors="replace") as fh:
                content = fh.read().strip()
            return content or None
        except OSError:
            return None
    return None


def sanitize_voice_name(raw: str) -> str:
    """Keep letters/digits/underscore/dash; collapse the rest. No path
    separator survives, so a name stays inside the library directory."""
    name = re.sub(r"[^\w-]", "_", raw.strip())
    name = re.sub(r"_+", "_", name).strip("_")
    return name


def pick_saved_voice() -> str | None:
    """Numbered pick-table over saved voices; returns a name or None."""
    voices = get_saved_voices()
    if not voices:
        console.print("[warn]No saved voices yet — enroll one first.[/warn]")
        return None
    console.print("[accent]Saved voices:[/accent]")
    for i, name in enumerate(voices, start=1):
        has_txt = "[dim](transcript)[/dim]" if load_voice_transcript(name) else ""
        console.print(f"  [key]{i}[/key]. {name} {has_txt}")
    try:
        raw = safe_line_input("[dim]number (empty = back)[/dim] > ").strip()
    except (EOFError, KeyboardInterrupt):
        return None
    if not raw:
        return None
    try:
        idx = int(raw)
    except ValueError:
        # allow picking by name too
        return raw if raw in voices else None
    if 1 <= idx <= len(voices):
        return voices[idx - 1]
    return None


def _acquire_transcript(wav_path: str) -> str | None:
    """Transcript via typing, .txt drag-and-drop, or local ASR offer."""
    console.print(
        "[accent]Transcript of the reference audio[/accent] "
        "[dim](type it, drag a .txt, or leave empty"
        + (" to auto-transcribe" if asr_available() else "")
        + ")[/dim]"
    )
    try:
        raw = safe_line_input("> ").strip()
    except (EOFError, KeyboardInterrupt):
        return None
    if raw:
        candidate = clean_path(raw)
        if candidate.lower().endswith(".txt") and os.path.exists(candidate):
            try:
                with open(candidate, "r", encoding="utf-8", errors="replace") as fh:
                    return fh.read().strip() or None
            except OSError:
                return None
        return raw
    if asr_available():
        return offer_transcribe(wav_path)
    return None


def enroll_new_voice() -> str | None:
    """Interactive enrollment: name -> audio file -> convert -> transcript ->
    save. Returns the saved voice name."""
    console.print("[accent]Name for the new voice[/accent] [dim](empty = back)[/dim]")
    try:
        raw_name = safe_line_input("> ").strip()
    except (EOFError, KeyboardInterrupt):
        return None
    if not raw_name:
        return None
    name = sanitize_voice_name(raw_name)
    if not name:
        console.print("[err]Invalid name.[/err]")
        return None

    console.print("[accent]Drag in the reference audio file[/accent]")
    try:
        audio_raw = safe_line_input("> ").strip()
    except (EOFError, KeyboardInterrupt):
        return None
    audio_path = clean_path(audio_raw)
    if not os.path.exists(audio_path):
        console.print(f"[err]File not found:[/err] {audio_path}")
        return None

    converted, is_temp = convert_audio_if_needed(audio_path)
    if converted is None:
        return None

    try:
        transcript = _acquire_transcript(converted)

        wav_dst, txt_dst = voice_paths(name)
        if os.path.exists(wav_dst) and not confirm_overwrite(name):
            console.print("[warn]Enrollment cancelled.[/warn]")
            return None

        os.makedirs(VOICES_DIR, exist_ok=True)
        shutil.copyfile(converted, wav_dst)
        if transcript:
            with open(txt_dst, "w", encoding="utf-8") as fh:
                fh.write(transcript)
        elif os.path.exists(txt_dst):
            os.remove(txt_dst)
        console.print(f"[ok]Voice '{name}' enrolled.[/ok]")
        return name
    finally:
        if is_temp:
            try:
                os.remove(converted)
            except OSError:
                pass


def delete_voice() -> bool:
    """Pick a voice and delete its wav/txt pair after confirmation."""
    name = pick_saved_voice()
    if name is None:
        return False
    console.print(f"[warn]Delete voice '{name}'? (y/n)[/warn]")
    try:
        if safe_line_input("> ").strip().lower() not in ("y", "yes"):
            return False
    except (EOFError, KeyboardInterrupt):
        return False
    wav, txt = voice_paths(name)
    for path in (wav, txt):
        try:
            os.remove(path)
        except OSError:
            pass
    console.print(f"[ok]Deleted '{name}'.[/ok]")
    return True


def update_voice() -> str | None:
    """Re-enroll an existing voice: replace audio and/or transcript."""
    name = pick_saved_voice()
    if name is None:
        return None
    wav_dst, txt_dst = voice_paths(name)

    console.print(
        "[accent]New audio file[/accent] [dim](empty = keep current audio)[/dim]"
    )
    try:
        audio_raw = safe_line_input("> ").strip()
    except (EOFError, KeyboardInterrupt):
        return None

    if audio_raw:
        audio_path = clean_path(audio_raw)
        if not os.path.exists(audio_path):
            console.print(f"[err]File not found:[/err] {audio_path}")
            return None
        converted, is_temp = convert_audio_if_needed(audio_path)
        if converted is None:
            return None
        try:
            shutil.copyfile(converted, wav_dst)
        finally:
            if is_temp:
                try:
                    os.remove(converted)
                except OSError:
                    pass

    transcript = _acquire_transcript(wav_dst)
    if transcript:
        with open(txt_dst, "w", encoding="utf-8") as fh:
            fh.write(transcript)
    console.print(f"[ok]Voice '{name}' updated.[/ok]")
    return name
