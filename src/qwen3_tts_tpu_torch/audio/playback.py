"""Audio playback with player probing and a headless no-op fallback (the
JAX package's audio/playback.py). The first CLI player found is used;
where none exists (a headless host) playback does nothing: generation
never fails because the host has no speakers."""

from __future__ import annotations

import shutil
import subprocess

_PLAYERS: tuple[tuple[str, list[str]], ...] = (
    ("afplay", []),                       # macOS
    ("paplay", []),                       # PulseAudio
    ("aplay", ["-q"]),                    # ALSA
    ("ffplay", ["-nodisp", "-autoexit", "-loglevel", "quiet"]),
    ("play", ["-q"]),                     # sox
)

_cached: tuple[str, list[str]] | None | str = "unprobed"


def _find_player() -> tuple[str, list[str]] | None:
    global _cached
    if _cached == "unprobed":
        _cached = None
        for name, args in _PLAYERS:
            if shutil.which(name):
                _cached = (name, args)
                break
    return _cached  # type: ignore[return-value]


def play_wav(path: str, *, blocking: bool = True) -> bool:
    """Play a WAV file if a player exists; a player's failure is ignored.
    Returns True iff playback was attempted."""
    player = _find_player()
    if player is None:
        return False
    name, args = player
    try:
        if blocking:
            subprocess.run([name, *args, path], capture_output=True, timeout=600)
        else:
            subprocess.Popen(
                [name, *args, path],
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
        return True
    except (OSError, subprocess.SubprocessError):
        return False
