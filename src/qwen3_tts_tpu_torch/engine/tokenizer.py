"""Text tokenization for the talker (the JAX package's engine/tokenizer.py).

Real checkpoints ship a Qwen3 tokenizer (tokenizer.json etc.), loaded
through ``transformers`` when it is installed. Synthetic models, and
directories without tokenizer files, use the deterministic byte-level
tokenizer. Where tokenizer files are present but the tokenizer cannot be
built (no ``transformers``, as on the GPU machine), ``load_tokenizer``
warns before it falls back to bytes: the JAX package falls back silently,
which would hide a real-vocabulary model conditioned on byte ids.

``WhisperTokenizer`` reads a Whisper checkpoint's byte-level BPE
vocabulary with json alone and decodes ids as transformers' Whisper
tokenizers do (the ASR transcript). Encoding text with a real vocabulary
without ``transformers`` is not ported yet.
"""

from __future__ import annotations

import json
import os
import re
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


# --------------------------------------------------------------------------
# Whisper's byte-level BPE vocabulary (decoding), without transformers
# --------------------------------------------------------------------------

_TIMESTAMP = re.compile(r"<\|(\d+\.\d+)\|>")


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte -> printable character map of byte-level BPE
    vocabularies: printable Latin-1 bytes map to themselves, the other 68
    bytes to the characters from U+0100 up, in byte order."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def clean_up_tokenization(text: str) -> str:
    """transformers' clean-up of spaces before punctuation and English
    contractions (``clean_up_tokenization_spaces``)."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                 (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"),
                 (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


def _read_json(path: str):
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def _content(tok) -> str:
    return tok["content"] if isinstance(tok, dict) else tok


class WhisperTokenizer:
    """A Whisper checkpoint's vocabulary, for decoding: ``tokenizer.json``,
    or ``vocab.json`` plus ``added_tokens.json`` (and the special tokens of
    ``special_tokens_map.json``/``tokenizer_config.json``), read with json
    alone.

    ``decode`` follows transformers' Whisper tokenizers: with
    ``skip_special_tokens`` a leading ``<|startofprev|>`` prompt is cut up
    to ``<|startoftranscript|>`` and special ids are dropped; byte-level
    tokens are mapped back to bytes and read as UTF-8 with
    ``errors="replace"``, added tokens verbatim; spaces are cleaned up when
    the tokenizer config asks for it; timestamp tokens (``<|1.23|>``) are
    removed from the text."""

    def __init__(self, path: str):
        tj = _read_json(os.path.join(path, "tokenizer.json"))
        cfg = _read_json(os.path.join(path, "tokenizer_config.json")) or {}
        if tj is not None:
            vocab = dict(tj["model"]["vocab"])
            added = {t["id"]: t["content"] for t in tj.get("added_tokens", [])}
            special = {t["id"] for t in tj.get("added_tokens", [])
                       if t.get("special")}
        else:
            vocab = _read_json(os.path.join(path, "vocab.json"))
            if vocab is None:
                raise FileNotFoundError(
                    f"{path}: no tokenizer.json or vocab.json")
            added = {int(i): c for c, i in (_read_json(
                os.path.join(path, "added_tokens.json")) or {}).items()}
            for i, t in cfg.get("added_tokens_decoder", {}).items():
                added[int(i)] = t["content"]
            names = set()
            for src in (_read_json(os.path.join(
                    path, "special_tokens_map.json")) or {}, cfg):
                for key in ("bos_token", "eos_token", "unk_token",
                            "pad_token"):
                    if src.get(key):
                        names.add(_content(src[key]))
                names.update(_content(t) for t in
                             src.get("additional_special_tokens", []))
            # transformers' WhisperTokenizer defaults bos/eos/unk to this
            names.add("<|endoftext|>")
            special = {i for i, c in added.items() if c in names}
            special |= {vocab[c] for c in names if c in vocab}
            special |= {int(i) for i, t in
                        cfg.get("added_tokens_decoder", {}).items()
                        if t.get("special")}
        self.ids = {**vocab, **{c: i for i, c in added.items()}}
        self.tokens = {i: c for c, i in vocab.items()}
        self.added = added
        self.special = special
        self.clean_up = bool(cfg.get("clean_up_tokenization_spaces", False))
        self._bytes = {c: b for b, c in bytes_to_unicode().items()}

    def token_to_id(self, token: str) -> int | None:
        """The id of ``token`` (an added token or a vocabulary entry), or
        None when the vocabulary has no such token."""
        return self.ids.get(token)

    def _text(self, run: list[str]) -> str:
        return bytes(self._bytes[c] for c in "".join(run)).decode(
            "utf-8", errors="replace")

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        ids = [int(i) for i in ids]
        if skip_special_tokens and ids and \
                ids[0] == self.ids.get("<|startofprev|>"):
            sot = self.ids.get("<|startoftranscript|>")
            ids = ids[ids.index(sot):] if sot in ids else []
        parts: list[str] = []
        run: list[str] = []
        for i in ids:
            if skip_special_tokens and i in self.special:
                continue
            if i in self.added:
                if run:
                    parts.append(self._text(run))
                    run = []
                parts.append(self.added[i])
            elif i in self.tokens:
                run.append(self.tokens[i])
        if run:
            parts.append(self._text(run))
        text = "".join(parts)
        if self.clean_up:
            text = clean_up_tokenization(text)
        return _TIMESTAMP.sub("", text)
