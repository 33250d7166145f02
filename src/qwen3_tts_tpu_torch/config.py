"""Paths the serving surfaces read (the JAX package's config.py, its
paths; the app's model registry and presets come with the terminal app).

Paths resolve against the working directory at import; tests override
them through the module globals.
"""

from __future__ import annotations

import os

MODELS_DIR = os.path.join(os.getcwd(), "models")   # models/asr: a Whisper
VOICES_DIR = os.path.join(os.getcwd(), "voices")   # <name>.wav + <name>.txt
