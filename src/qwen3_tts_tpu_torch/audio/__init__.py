"""Audio I/O for the port: 16-bit PCM WAV reading and writing, the
downmix and the resampler of a cloning reference."""

from .resample import resample  # noqa: F401
from .wavio import read_wav, to_mono, write_wav  # noqa: F401
