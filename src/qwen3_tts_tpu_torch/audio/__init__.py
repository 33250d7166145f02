"""Audio I/O for the port: the 16-bit PCM WAV writer."""

from .wavio import write_wav  # noqa: F401
