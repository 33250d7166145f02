"""Prompt construction (copied from the JAX package's runtime/prompts.py,
default template path only).

A prompt becomes an embedding sequence for the talker:

    [speaker vector]? [text-token embeddings] [acoustic-context]? [codec BOS]

The text half is rendered with the built-in control tags
(``render_template``, the JAX package's ``SYNTHETIC_TEMPLATE`` path).
Templates read from checkpoint files (tts_prompts.json, chat templates)
wait for checkpoint import (ROADMAP queue A, item 10).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PromptSpec:
    """Host-side description of one prompt, ready to embed on device."""

    text_tokens: np.ndarray            # [T_text] int32
    speaker_id: int | None = None      # index into the talker spk_emb table
    # speaker as a CODEC-vocab control token (checkpoints whose talker
    # config carries a speaker name -> id map); mutually exclusive with
    # the learned spk_emb row above
    speaker_token: int | None = None
    # cloning extras:
    acoustic_codes: np.ndarray | None = None   # [Q, T_ref] codec codes
    speaker_vector: np.ndarray | None = None   # [D_talker] from codec encoder
    rendered: str | None = None        # the rendered text prompt


def speed_bucket(speed: float) -> str:
    """Quantise a speed multiplier into a coarse control tag."""
    if speed <= 0.85:
        return "slow"
    if speed >= 1.15:
        return "fast"
    return "normal"


def render_template(
    mode: str,
    text: str,
    *,
    instruct: str | None = None,
    speed: float = 1.0,
    ref_text: str | None = None,
) -> str:
    """Render the text half of the prompt for ``mode`` with the built-in
    control tags."""
    if mode == "custom":
        parts = []
        if instruct:
            parts.append(f"<|instruct|>{instruct}<|/instruct|>")
        parts.append(f"<|speed:{speed_bucket(speed)}|>")
        parts.append(text)
        return "".join(parts)
    if mode == "design":
        desc = instruct or ""
        return f"<|voice|>{desc}<|/voice|>{text}"
    if mode == "base":  # cloning: ref transcript then target text
        ref = (ref_text or "").strip()
        if ref and ref != ".":
            return f"<|ref|>{ref}<|/ref|>{text}"
        return text
    raise ValueError(f"unknown mode: {mode}")


def build_prompt(
    tokenizer,
    mode: str,
    text: str,
    *,
    voice: str | None = None,
    speakers: tuple[str, ...] = (),
    instruct: str | None = None,
    speed: float = 1.0,
    ref_text: str | None = None,
    acoustic_codes: np.ndarray | None = None,
    speaker_vector: np.ndarray | None = None,
    speaker_tokens: dict[str, int] | None = None,
) -> PromptSpec:
    """Render (built-in tags), tokenize and attach the speaker.
    ``speaker_tokens``: a checkpoint's name -> codec-token-id map; when it
    covers the voice, the speaker conditions as a codec control token
    instead of the spk_emb row."""
    rendered = render_template(
        mode, text, instruct=instruct, speed=speed, ref_text=ref_text)
    tokens = np.asarray(tokenizer.encode(rendered), dtype=np.int32)

    speaker_id: int | None = None
    speaker_token: int | None = None
    if mode == "custom" and voice:
        name = voice.lower()
        if speaker_tokens and name in speaker_tokens:
            speaker_token = int(speaker_tokens[name])
        elif name in speakers:
            speaker_id = speakers.index(name)
        else:
            valid = sorted(set(speakers) | set(speaker_tokens or ()))
            raise ValueError(
                f"unknown speaker {voice!r}; valid speakers: {valid}"
            )

    return PromptSpec(
        text_tokens=tokens,
        speaker_id=speaker_id,
        speaker_token=speaker_token,
        acoustic_codes=acoustic_codes,
        speaker_vector=speaker_vector,
        rendered=rendered,
    )
