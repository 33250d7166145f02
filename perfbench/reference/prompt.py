"""The served request's text tokens, worked out from its text alone.

A frozen copy of the program's plain prompt path for a preset-voice
request: the built-in control tags (the synthetic model has no chat
template) and UTF-8 bytes as token ids (the synthetic model's tokenizer).
A family's ``reference.py`` assembles the talker's prompt rows from them.
"""

from __future__ import annotations


def speed_bucket(speed: float) -> str:
    if speed <= 0.85:
        return "slow"
    if speed >= 1.15:
        return "fast"
    return "normal"


def render_custom(text: str, instruct: str | None, speed: float = 1.0) -> str:
    """The preset-voice prompt text with the built-in control tags."""
    parts = []
    if instruct:
        parts.append(f"<|instruct|>{instruct}<|/instruct|>")
    parts.append(f"<|speed:{speed_bucket(speed)}|>")
    parts.append(text)
    return "".join(parts)


def text_tokens(text: str, instruct: str | None, speed: float = 1.0) -> list[int]:
    """Token ids of a one-segment request (its text stripped, as the
    daemon's segmenter leaves it): the rendered prompt's UTF-8 bytes."""
    return list(render_custom(text.strip(), instruct, speed).encode("utf-8"))
