"""App configuration, model registry and generation presets (the JAX
package's config.py).

Paths resolve against the working directory at import; tests override
them through the module globals. The registry, speakers, emotion and
speed presets are the JAX package's, so the terminal app offers the same
choices. ``EngineSettings`` is the JAX package's record of engine knobs,
which no loader reads there either; model geometry, quantization and
dtype live in ``engine/configs.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

# --- paths --------------------------------------------------------------------
BASE_OUTPUT_DIR = os.path.join(os.getcwd(), "outputs")  # the app's WAVs
MODELS_DIR = os.path.join(os.getcwd(), "models")   # models/asr: a Whisper
VOICES_DIR = os.path.join(os.getcwd(), "voices")   # <name>.wav + <name>.txt

# --- global knobs -------------------------------------------------------------
AUTO_PLAY = True                 # play each generated WAV
SAMPLE_RATE = 24_000             # output sample rate
FILENAME_MAX_LEN = 20            # snippet length in saved filenames
MAX_TEXT_LENGTH = 10_000         # max input characters


@dataclass(frozen=True)
class ModelSpec:
    """One entry of the model registry."""

    key: str                     # menu key: "1" | "2" | "3"
    name: str                    # human name shown in the menu
    repo_id: str                 # Hugging Face repo id
    folder: str                  # local folder name under MODELS_DIR
    mode: str                    # session dispatch: custom | design | clone_manager
    output_subfolder: str        # subfolder of BASE_OUTPUT_DIR for generated WAVs
    description: str
    icon: str = ""


_REGISTRY: tuple[ModelSpec, ...] = (
    ModelSpec(
        key="1",
        name="Custom Voice",
        repo_id="mlx-community/Qwen3-TTS-12Hz-1.7B-CustomVoice-8bit",
        folder="Qwen3-TTS-12Hz-1.7B-CustomVoice-8bit",
        mode="custom",
        output_subfolder="CustomVoice",
        description="Preset speakers with emotion & speed control",
        icon="\U0001f399",
    ),
    ModelSpec(
        key="2",
        name="Voice Design",
        repo_id="mlx-community/Qwen3-TTS-12Hz-1.7B-VoiceDesign-8bit",
        folder="Qwen3-TTS-12Hz-1.7B-VoiceDesign-8bit",
        mode="design",
        output_subfolder="VoiceDesign",
        description="Design a voice from a text description",
        icon="\U0001f3a8",
    ),
    ModelSpec(
        key="3",
        name="Voice Cloning",
        repo_id="mlx-community/Qwen3-TTS-12Hz-1.7B-Base-8bit",
        folder="Qwen3-TTS-12Hz-1.7B-Base-8bit",
        mode="clone_manager",
        output_subfolder="Clones",
        description="Clone any voice from a reference audio sample",
        icon="\U0001f9ec",
    ),
)

MODELS: dict[str, ModelSpec] = {spec.key: spec for spec in _REGISTRY}

SPEAKER_MAP: dict[str, list[str]] = {
    "English": ["Ryan", "Aiden", "Serena", "Vivian"],
    "Chinese": ["Vivian", "Serena", "Uncle_Fu", "Dylan", "Eric"],
    "Japanese": ["Ono_Anna"],
    "Korean": ["Sohee"],
}


def all_speakers() -> list[str]:
    """Flattened, order-preserving, de-duplicated speaker list."""
    seen: dict[str, None] = {}
    for names in SPEAKER_MAP.values():
        for n in names:
            seen.setdefault(n, None)
    return list(seen)


# key -> (label, instruct text); a None instruct means "prompt the user".
EMOTION_PRESETS: dict[str, tuple[str, str | None]] = {
    "1": ("Normal", "Normal tone"),
    "2": ("Sad", "Sad and crying, speaking slowly"),
    "3": ("Excited", "Excited and happy, speaking very fast"),
    "4": ("Angry", "Angry and shouting"),
    "5": ("Whisper", "Whispering quietly"),
    "6": ("Custom", None),
}

SPEED_PRESETS: dict[str, tuple[str, float]] = {
    "1": ("Normal", 1.0),
    "2": ("Fast", 1.3),
    "3": ("Slow", 0.8),
}


@dataclass
class EngineSettings:
    """Engine-level knobs (the JAX package's record; the reference has no
    engine configuration)."""

    dtype: str = "bfloat16"          # activation dtype
    quant: str = "int8"              # weight quant: int8 | none (bf16)
    max_decode_frames: int = 2048    # KV-cache length budget for one chunk
    decode_chunk: int = 8            # frames decoded per chunk
    mesh_shape: dict[str, int] = field(default_factory=lambda: {"dp": 1, "tp": 1})
    use_pallas: str = "auto"         # the JAX package's kernel switch
