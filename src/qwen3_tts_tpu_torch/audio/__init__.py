"""Audio I/O for the port: PCM WAV reading and writing, the downmix,
resampling and format conversion of a reference, and playback."""

from .playback import play_wav  # noqa: F401
from .resample import convert_to_wav, resample  # noqa: F401
from .wavio import read_wav, to_mono, wav_info, write_wav  # noqa: F401
