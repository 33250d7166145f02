"""Text tokenization for the talker (copied from the JAX package's
engine/tokenizer.py). Synthetic models use the deterministic byte-level
tokenizer; the Qwen3 BPE tokenizer of real checkpoints waits for checkpoint
import (ROADMAP queue A).
"""

from __future__ import annotations


class ByteTokenizer:
    """UTF-8 byte fallback: ids 0..255, deterministic, vocab-safe."""

    vocab_size = 256

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")


def load_tokenizer(model_path: str | None, vocab_size: int):
    """The tokenizer of a model directory; ``None`` (synthetic models) gives
    the byte tokenizer."""
    if model_path is not None:
        raise NotImplementedError(
            "checkpoint tokenizers (HFTokenizer) wait for checkpoint import "
            "(ROADMAP queue A, item 10)"
        )
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
