"""The voice library's naming rule (the JAX package's voices.py, the part
that the HTTP daemon's voice endpoints call). A saved voice is a
``<name>.wav`` + optional ``<name>.txt`` transcript pair under the
library directory (``config.VOICES_DIR`` by default).

Nothing here imports the terminal UI: the interactive enroll, pick,
delete and update flows come with the terminal app.
"""

from __future__ import annotations

import re


def sanitize_voice_name(raw: str) -> str:
    """Keep letters/digits/underscore/dash; collapse the rest. No path
    separator survives, so a name stays inside the library directory."""
    name = re.sub(r"[^\w-]", "_", raw.strip())
    name = re.sub(r"_+", "_", name).strip("_")
    return name
