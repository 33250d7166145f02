"""Text tokenization for the talker (the JAX package's engine/tokenizer.py).

Real checkpoints ship a Qwen3 tokenizer (tokenizer.json etc.), loaded
through ``transformers`` when it is installed. Synthetic models, and
directories without tokenizer files, use the deterministic byte-level
tokenizer. Where tokenizer files are present but the tokenizer cannot be
built (no ``transformers``, as on the GPU machine), ``load_tokenizer``
warns before it falls back to bytes: the JAX package falls back silently,
which would hide a real-vocabulary model conditioned on byte ids.
"""

from __future__ import annotations

import os
import warnings

TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.json")


class ByteTokenizer:
    """UTF-8 byte fallback: ids 0..255, deterministic, vocab-safe."""

    vocab_size = 256

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")


class HFTokenizer:
    """transformers-backed tokenizer (Qwen3 BPE for real checkpoints)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, trust_remote_code=False)
        self.vocab_size = len(self._tok)

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids) -> str:
        return self._tok.decode(list(ids))


def load_tokenizer(model_path: str | None, vocab_size: int):
    """The tokenizer of a model directory, by the JAX package's rule: bytes
    for a text vocabulary under 256 (tiny configs clamp byte ids with
    ``clamp_ids``) or a directory without tokenizer files, else the HF
    tokenizer; bytes with a warning when that cannot be built."""
    if vocab_size < 256 or model_path is None:
        return ByteTokenizer()
    if any(os.path.exists(os.path.join(model_path, f)) for f in TOKENIZER_FILES):
        try:
            return HFTokenizer(model_path)
        except Exception as e:  # no transformers, or files it cannot read
            warnings.warn(
                f"{model_path} ships tokenizer files but its tokenizer could "
                f"not be built ({type(e).__name__}: {e}); falling back to "
                "the byte tokenizer, so the model is conditioned on byte ids, "
                "not on its own vocabulary")
    return ByteTokenizer()


def clamp_ids(ids, vocab_size: int) -> list[int]:
    """Map token ids into [0, vocab_size) — ONLY legal for tiny synthetic
    configs whose embedding tables are smaller than the byte tokenizer's 256
    ids. For real-sized configs an out-of-range id means the tokenizer does
    not belong to the checkpoint, so this raises instead."""
    ids = [int(i) for i in ids]
    if not ids:
        return ids
    if (max(ids) >= vocab_size or min(ids) < 0) and vocab_size >= 512:
        raise ValueError(
            f"token id {max(ids)} out of range for vocab_size {vocab_size}: "
            f"tokenizer/config mismatch"
        )
    return [i % vocab_size for i in ids]
