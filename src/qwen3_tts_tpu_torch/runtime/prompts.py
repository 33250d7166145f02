"""Prompt construction (the JAX package's runtime/prompts.py).

A prompt becomes an embedding sequence for the talker:

    [speaker vector]? [text-token embeddings] [acoustic-context]? [codec BOS]

The text half is rendered from the checkpoint's own templates, found by
``load_prompt_template`` in priority order:

1. ``tts_prompts.json`` (or a ``tts_prompts`` section of
   ``generation_config.json``): per-mode format strings over {text}
   {instruct} {speed} {speed_bucket} {ref_text} {voice};
2. the tokenizer's Jinja ``chat_template`` (tokenizer_config.json), with
   the instruct text or voice description as the system turn and the
   target text as the user turn;
3. nothing found: the built-in control tags of ``render_template``
   (synthetic models).
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Any

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
    """The built-in control tags (synthetic models): the text half of the
    prompt for ``mode``."""
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


class _Defaulting(dict):
    def __missing__(self, key):  # tolerate unused placeholders
        return ""


@dataclass(frozen=True)
class PromptTemplate:
    """Per-mode prompt templates loaded from a checkpoint directory."""

    custom: str | None = None
    design: str | None = None
    base: str | None = None          # cloning with a reference transcript
    base_noref: str | None = None    # cloning with the "." no-transcript
    chat_template: str | None = None  # Jinja source (tokenizer_config.json)
    source: str = "synthetic"

    def render(
        self,
        mode: str,
        text: str,
        *,
        instruct: str | None = None,
        speed: float = 1.0,
        ref_text: str | None = None,
        voice: str | None = None,
    ) -> str:
        ref = (ref_text or "").strip()
        has_ref = bool(ref) and ref != "."
        values = _Defaulting(
            text=text,
            instruct=instruct or "",
            speed=f"{speed:g}",
            speed_bucket=speed_bucket(speed),
            ref_text=ref if has_ref else "",
            voice=(voice or "").lower(),
        )
        if mode not in ("custom", "design", "base"):
            raise ValueError(f"unknown mode: {mode}")
        tpl = {
            "custom": self.custom,
            "design": self.design,
            "base": self.base if has_ref else (self.base_noref or self.base),
        }[mode]
        if tpl is not None:
            return tpl.format_map(values)
        if self.chat_template is not None:
            return self._render_chat(mode, text, values, has_ref)
        return render_template(
            mode, text, instruct=instruct, speed=speed, ref_text=ref_text)

    def _render_chat(self, mode, text, values, has_ref) -> str:
        """The reference call shapes as chat messages, rendered with the
        checkpoint's Jinja chat template (what transformers'
        apply_chat_template does)."""
        import jinja2

        system = {
            "custom": values["instruct"],
            "design": values["instruct"],
            "base": values["ref_text"] if has_ref else "",
        }[mode]
        messages = []
        if system:
            messages.append({"role": "system", "content": system})
        messages.append({"role": "user", "content": text})
        env = jinja2.Environment(
            trim_blocks=True, lstrip_blocks=True,
            undefined=jinja2.ChainableUndefined,
        )
        return env.from_string(self.chat_template).render(
            messages=messages,
            add_generation_prompt=True,
            voice=values["voice"],
            speed=values["speed"],
            speed_bucket=values["speed_bucket"],
            instruct=values["instruct"],
            ref_text=values["ref_text"],
        )


SYNTHETIC_TEMPLATE = PromptTemplate()

_MARKER_RE = re.compile(r"<\|[^|<>]+\|>")


def validate_special_tokens(rendered: str, tokenizer) -> None:
    """Every ``<|...|>`` control marker in a rendered prompt must be ONE
    token of the checkpoint's tokenizer; a marker that splits means the
    chat template does not belong to this tokenizer, so this raises."""
    bad = []
    for marker in sorted(set(_MARKER_RE.findall(rendered))):
        ids = tokenizer.encode(marker)
        if len(ids) != 1:
            bad.append(f"{marker!r} -> {len(ids)} tokens")
    if bad:
        raise ValueError(
            "chat-template render produced control markers the tokenizer "
            f"does not know as special tokens: {', '.join(bad)}. The "
            "template/tokenizer pairing (or the engine's role mapping — "
            "runtime/prompts.py _render_chat) is wrong for this "
            "checkpoint; refusing to condition the talker on split "
            "markers. Override with a tts_prompts.json template file."
        )


def load_prompt_template(model_path: str | None) -> PromptTemplate:
    """The prompt templates of a checkpoint directory (module docstring
    priority order); the synthetic fallback when nothing is found."""
    if not model_path or not os.path.isdir(model_path):
        return SYNTHETIC_TEMPLATE

    def read_json(name) -> Any:
        p = os.path.join(model_path, name)
        if os.path.exists(p):
            try:
                with open(p) as f:
                    return json.load(f)
            except (OSError, ValueError):
                return None
        return None

    spec = read_json("tts_prompts.json")
    if spec is None:
        gen = read_json("generation_config.json")
        if isinstance(gen, dict):
            spec = gen.get("tts_prompts")
    if isinstance(spec, dict):
        return PromptTemplate(
            custom=spec.get("custom"),
            design=spec.get("design"),
            base=spec.get("base", spec.get("clone")),
            base_noref=spec.get("base_noref", spec.get("clone_noref")),
            source="file",
        )
    tok_cfg = read_json("tokenizer_config.json")
    if isinstance(tok_cfg, dict) and isinstance(tok_cfg.get("chat_template"), str):
        return PromptTemplate(chat_template=tok_cfg["chat_template"],
                              source="chat_template")
    return SYNTHETIC_TEMPLATE


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
    template: PromptTemplate | None = None,
    speaker_tokens: dict[str, int] | None = None,
) -> PromptSpec:
    """Render (``template``, default the built-in tags), tokenize and attach
    the speaker. ``speaker_tokens``: a checkpoint's name -> codec-token-id
    map; when it covers the voice, the speaker conditions as a codec
    control token instead of the spk_emb row."""
    template = template or SYNTHETIC_TEMPLATE
    rendered = template.render(
        mode, text, instruct=instruct, speed=speed, ref_text=ref_text,
        voice=voice)
    if (template.source == "chat_template"
            and getattr(tokenizer, "vocab_size", 0) >= 512):
        # a real tokenizer and its own chat template: each control marker
        # must tokenize as one special token
        validate_special_tokens(rendered, tokenizer)
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
