"""Engine surface of the port: ``load_model`` and ``generate_audio``."""

from .api import (  # noqa: F401
    Qwen3TTSModel,
    compute_format,
    generate_audio,
    load_model,
    prepare_segments,
)
from .weights import save_model  # noqa: F401
