"""The import guard: no JAX and no JAX package in the process that reports.

Top-level names are compared whole (the part before the first dot): the
program's package name begins with the JAX package's, so a prefix test
would flag the program itself."""

from __future__ import annotations

import sys

BANNED = ("jax", "jaxlib", "flax", "qwen3_tts_tpu")


def banned_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of ``BANNED``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in BANNED)
