"""The served request's prompt, worked out from its text alone.

A frozen copy of the program's plain prompt path for a preset-voice
request of the published residual-sum protocol: the built-in control tags
(the synthetic model has no chat template), UTF-8 bytes as token ids (the
synthetic model's tokenizer), and the dual-stream prompt of the published
talker (``Qwen3OmniMoeForConditionalGeneration._get_talker_assistant_parts``)
with the text after its fourth token in a trailing buffer, one row a
frame. No padding: RoPE is relative, so the program's left padding to a
bucket changes nothing that is compared.
"""

from __future__ import annotations

import torch


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


def assemble(tables: dict, talker: dict, tokens: list[int],
             speaker_id: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(prompt rows [L, D], trailing-text buffer [Tb, D]) of one request.

    ``tables``: ``text_emb``, ``codec_emb`` and ``spk_emb`` as the run
    computes them; ``talker``: the configuration's talker section. The
    rows are the three chat-head text rows, the codec think head under
    tts_pad, the speaker row under tts_pad, codec_pad under tts_bos, and
    the fourth text token over codec_bos. The buffer holds the text rows
    after the fourth, cut to Tb - 2, then tts_eos unless cut, then
    tts_pad to the end."""
    text_emb, codec_emb = tables["text_emb"], tables["codec_emb"]
    dev = text_emb.device
    ids = torch.tensor([talker["tts_pad_id"], talker["tts_bos_id"],
                        talker["tts_eos_id"]], device=dev)
    pad_e, bos_e, eos_e = text_emb[ids]
    txt = text_emb[torch.tensor(tokens, dtype=torch.long, device=dev)]
    T = txt.shape[0]
    if T < 4:
        raise ValueError("a request renders to at least four tokens")
    rows = [txt[:3]]
    for tok in (talker["codec_nothink"], talker["codec_think_bos"],
                talker["codec_think_eos"]):
        rows.append((pad_e + codec_emb[tok])[None])
    rows.append((pad_e + tables["spk_emb"][speaker_id])[None])
    rows.append((bos_e + codec_emb[talker["codec_pad"]])[None])
    rows.append((txt[3] + codec_emb[talker["codec_bos"]])[None])
    Tb = talker["trailing_bucket"]
    rest = txt[4:]
    kept = rest[:Tb - 2]
    buf = pad_e[None].repeat(Tb, 1)
    if rest.shape[0] == kept.shape[0]:
        buf[kept.shape[0]] = eos_e
    buf[:kept.shape[0]] = kept
    return torch.cat(rows), buf
