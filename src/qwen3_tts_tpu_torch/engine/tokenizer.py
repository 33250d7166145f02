"""Text tokenization for the talker (the JAX package's engine/tokenizer.py).

Real checkpoints ship a Qwen3 tokenizer (``tokenizer.json``, or
``vocab.json`` + ``merges.txt`` + ``tokenizer_config.json``).
``QwenBPETokenizer`` encodes with it in plain Python, giving the ids of
``transformers.AutoTokenizer`` (the JAX package's ``HFTokenizer``) with
neither ``transformers``, ``tokenizers`` nor ``regex`` installed, as on the
GPU machine: added and special tokens first, then the NFC normalizer, the
Qwen2 Split pre-tokenizer, ByteLevel and the BPE merges. A tokenizer whose
components it does not implement raises rather than mis-splits.

``load_tokenizer`` picks it whenever tokenizer files exist;
``QWEN3_TTS_TOKENIZER=hf`` picks ``HFTokenizer`` instead (never as a
fallback). Synthetic models, and directories without tokenizer files, use
the deterministic byte-level tokenizer.

``WhisperTokenizer`` reads a Whisper checkpoint's byte-level BPE
vocabulary with json alone and decodes ids as transformers' Whisper
tokenizers do (the ASR transcript).
"""

from __future__ import annotations

import functools
import json
import os
import re
import unicodedata

# the files that carry a text vocabulary (a tokenizer_config.json alone,
# say a chat template, carries none)
TOKENIZER_FILES = ("tokenizer.json", "vocab.json")


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


def tokenizer_backend() -> str:
    """QWEN3_TTS_TOKENIZER: ``bpe`` (default, ``QwenBPETokenizer``) or
    ``hf`` (``HFTokenizer``, which needs ``transformers``)."""
    name = os.environ.get("QWEN3_TTS_TOKENIZER", "bpe") or "bpe"
    if name not in ("bpe", "hf"):
        raise ValueError(
            f"QWEN3_TTS_TOKENIZER={name!r}: expected 'bpe' or 'hf'")
    return name


def load_tokenizer(model_path: str | None, vocab_size: int):
    """The tokenizer of a model directory: bytes for a text vocabulary
    under 256 (tiny configs clamp byte ids with ``clamp_ids``) or a
    directory without tokenizer files, as in the JAX package; otherwise
    the checkpoint's own vocabulary through ``tokenizer_backend()``. Files
    that the backend cannot read raise: nothing falls back to bytes."""
    if vocab_size < 256 or model_path is None:
        return ByteTokenizer()
    if not any(os.path.exists(os.path.join(model_path, f))
               for f in TOKENIZER_FILES):
        return ByteTokenizer()
    if tokenizer_backend() == "hf":
        return HFTokenizer(model_path)
    return QwenBPETokenizer(model_path)


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


# --------------------------------------------------------------------------
# Qwen2/Qwen3 byte-level BPE (encoding and decoding), without transformers
# --------------------------------------------------------------------------

# the Split pre-tokenizer pattern of every Qwen2/Qwen3 tokenizer.json
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                 r"\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
_BYTE_LEVEL = {"type": "ByteLevel", "add_prefix_space": False,
               "use_regex": False}
_ADDED_FLAGS = ("single_word", "lstrip", "rstrip", "normalized", "special")
_QWEN_CLASSES = ("Qwen2Tokenizer", "Qwen2TokenizerFast")


def _ranges(pred) -> str:
    """A ``re`` character-class body of every code point with ``pred``."""
    out, start, prev = [], None, None
    for c in range(0x110000):
        if pred(c):
            if start is None:
                start = c
            prev = c
        elif start is not None:
            out.append(re.escape(chr(start)) if start == prev else
                       f"{re.escape(chr(start))}-{re.escape(chr(prev))}")
            start = None
    if start is not None:
        out.append(f"{re.escape(chr(start))}-{re.escape(chr(prev))}")
    return "".join(out)


@functools.cache
def qwen2_pretokenizer() -> re.Pattern:
    r"""QWEN2_PATTERN in stdlib ``re``, built once at first use: ``\p{L}``
    and ``\p{N}`` become range classes of the general categories L* and
    N*, and ``\s`` the Unicode whitespace of Oniguruma's ``\s`` (the
    tokenizers library's engine): tab to carriage return, NEL and the Z*
    separators."""
    cat = unicodedata.category
    L = _ranges(lambda c: cat(chr(c)).startswith("L"))
    N = _ranges(lambda c: cat(chr(c)).startswith("N"))
    S = _ranges(lambda c: 9 <= c <= 13 or c == 0x85
                or cat(chr(c)) in ("Zs", "Zl", "Zp"))
    return re.compile(
        rf"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n{L}{N}]?[{L}]+|[{N}]"
        rf"| ?[^{S}{L}{N}]+[\r\n]*|[{S}]*[\r\n]+|[{S}]+(?![^{S}])"
        rf"|[{S}]+")


def _is_word(c: str) -> bool:
    """Rust's ``char::is_alphanumeric`` (single_word boundaries)."""
    return unicodedata.category(c)[0] in "LN"


def _byte_decode(token: str, byte_of: dict) -> bytes:
    """The ByteLevel decoder on one token: its byte characters' bytes, or
    its own UTF-8 when a character is not a byte character."""
    try:
        return bytes(byte_of[c] for c in token)
    except KeyError:
        return token.encode("utf-8")


class QwenBPETokenizer:
    """A Qwen2/Qwen3 checkpoint's byte-level BPE in plain Python.

    Reads ``tokenizer.json`` (model BPE, normalizer NFC, pre-tokenizer
    Sequence[Split(QWEN2_PATTERN, Isolated), ByteLevel], decoder
    ByteLevel), or else ``vocab.json`` + ``merges.txt`` with the added
    tokens of ``tokenizer_config.json`` (``added_tokens_decoder``), the
    layout of transformers' Qwen2Tokenizer. ``encode`` splits the text on
    the added tokens (longest match first, with their ``lstrip``,
    ``rstrip``, ``single_word`` and ``normalized`` flags), normalizes the
    rest with NFC, pre-tokenizes it with the Qwen2 pattern (digits one by
    one), maps bytes to characters and merges by rank (per pre-token,
    cached; ``ignore_merges`` honoured). ``vocab_size`` counts the added
    tokens (``len(AutoTokenizer)``); ``decode`` inverts the byte map, added
    tokens as transformers decodes them."""

    _CACHE_MAX = 100_000

    def __init__(self, path: str):
        tj = _read_json(os.path.join(path, "tokenizer.json"))
        cfg = _read_json(os.path.join(path, "tokenizer_config.json")) or {}
        if tj is not None:
            vocab, merges, ignore, added = self._from_tokenizer_json(tj)
        else:
            vocab = _read_json(os.path.join(path, "vocab.json"))
            merges_p = os.path.join(path, "merges.txt")
            if vocab is None or not os.path.exists(merges_p):
                raise FileNotFoundError(
                    f"{path}: no tokenizer.json, and no vocab.json with "
                    "merges.txt")
            cls = cfg.get("tokenizer_class")
            if cls is not None and cls not in _QWEN_CLASSES:
                raise ValueError(
                    f"{path}: tokenizer_class {cls!r} is not a Qwen2 "
                    "byte-level BPE tokenizer")
            with open(merges_p, encoding="utf-8") as fh:
                merges = [ln.split(" ") for ln in fh.read().split("\n")
                          if ln and not ln.startswith("#version")]
            ignore = False
            added = [{"id": int(i), **t} for i, t in
                     cfg.get("added_tokens_decoder", {}).items()]
        for i, m in enumerate(merges):
            if isinstance(m, str):
                merges[i] = m.split(" ")
            if len(merges[i]) != 2:
                raise ValueError(f"{path}: malformed merge {m!r}")
        self.vocab = vocab
        self.ranks = {(a, b): r for r, (a, b) in enumerate(merges)}
        self.ignore_merges = ignore
        self.added: dict[str, dict] = {}
        for tok in added:
            for flag in _ADDED_FLAGS:
                if not isinstance(tok.get(flag, False), bool):
                    raise ValueError(
                        f"{path}: added token {tok.get('content')!r} has "
                        f"{flag}={tok.get(flag)!r}, which the encoder does "
                        "not implement")
            self.added[tok["content"]] = tok
        self.added_ids = {t["id"]: c for c, t in self.added.items()}
        self.tokens = {i: t for t, i in vocab.items()}
        self.vocab_size = len(set(vocab) | set(self.added))
        self.clean_up = bool(cfg.get("clean_up_tokenization_spaces", False))
        self._char_of = bytes_to_unicode()
        self._byte_of = {c: b for b, c in self._char_of.items()}
        self._raw = self._matcher([c for c, t in self.added.items()
                                   if not t.get("normalized", False)])
        self._norm = self._matcher([unicodedata.normalize("NFC", c)
                                    for c, t in self.added.items()
                                    if t.get("normalized", False)])
        self._norm_tok = {unicodedata.normalize("NFC", c): c
                          for c, t in self.added.items()
                          if t.get("normalized", False)}
        self._cache: dict[str, list[int]] = {}

    @staticmethod
    def _from_tokenizer_json(tj: dict):
        model = tj.get("model") or {}
        if model.get("type") != "BPE":
            raise ValueError(f"tokenizer model {model.get('type')!r}: "
                             "only byte-level BPE is implemented")
        for key, ok in (("dropout", (None,)), ("unk_token", (None,)),
                        ("continuing_subword_prefix", (None, "")),
                        ("end_of_word_suffix", (None, "")),
                        ("byte_fallback", (False, None))):
            if model.get(key) not in ok:
                raise ValueError(f"BPE {key}={model.get(key)!r} is not "
                                 "implemented")
        norm = tj.get("normalizer")
        if norm != {"type": "NFC"}:
            raise ValueError(f"normalizer {norm!r}: only NFC is implemented")
        pre = tj.get("pre_tokenizer") or {}
        steps = pre.get("pretokenizers") if pre.get("type") == "Sequence" \
            else None
        if (not steps or len(steps) != 2 or steps[0].get("type") != "Split"
                or steps[0].get("pattern") != {"Regex": QWEN2_PATTERN}
                or steps[0].get("behavior") != "Isolated"
                or steps[0].get("invert", False)
                or {k: steps[1].get(k) for k in _BYTE_LEVEL} != _BYTE_LEVEL):
            raise ValueError(
                f"pre-tokenizer {pre!r}: only Sequence[Split(the Qwen2 "
                "pattern, Isolated), ByteLevel(no prefix space, no regex)] "
                "is implemented")
        dec = tj.get("decoder") or {}
        if dec.get("type") != "ByteLevel":
            raise ValueError(f"decoder {dec!r}: only ByteLevel is implemented")
        return (dict(model["vocab"]), list(model["merges"]),
                bool(model.get("ignore_merges", False)),
                list(tj.get("added_tokens", [])))

    @staticmethod
    def _matcher(contents: list[str]):
        """Leftmost-longest matching of ``contents``: an alternation in
        decreasing length (``re`` takes the first alternative that matches
        at the leftmost position)."""
        if not contents:
            return None
        return re.compile("|".join(
            re.escape(c) for c in sorted(contents, key=lambda c: (-len(c), c))))

    def _split_added(self, text: str, matcher, lookup) -> list:
        """[(added token content or None, piece)]: the added tokens that
        ``matcher`` finds in ``text``, their strip and single-word flags
        applied as the tokenizers library's AddedVocabulary does."""
        if matcher is None:
            return [(None, text)]
        out, done = [], 0
        for m in matcher.finditer(text):
            start, stop = m.span()
            tok = self.added[lookup(m.group())]
            if tok.get("single_word", False) and (
                    (start > 0 and _is_word(text[start - 1]))
                    or (stop < len(text) and _is_word(text[stop]))):
                continue
            if tok.get("lstrip", False):
                left = start
                while left > 0 and text[left - 1].isspace():
                    left -= 1
                start = max(left, done)
            if tok.get("rstrip", False):
                while stop < len(text) and text[stop].isspace():
                    stop += 1
            if done < start:
                out.append((None, text[done:start]))
            out.append((tok["content"], text[start:stop]))
            done = stop
        if done < len(text):
            out.append((None, text[done:]))
        return out

    def _bpe(self, piece: str) -> list[int]:
        ids = self._cache.get(piece)
        if ids is not None:
            return ids
        word = "".join(self._char_of[b] for b in piece.encode("utf-8"))
        if self.ignore_merges and word in self.vocab:
            parts = [word]
        else:
            parts = list(word)
            while len(parts) > 1:
                rank, best = min(
                    (self.ranks.get(pair, len(self.ranks)), i)
                    for i, pair in enumerate(zip(parts, parts[1:])))
                if rank == len(self.ranks):
                    break
                a, b = parts[best], parts[best + 1]
                merged, i = [], 0
                while i < len(parts):
                    if i + 1 < len(parts) and parts[i] == a and parts[i + 1] == b:
                        merged.append(a + b)
                        i += 2
                    else:
                        merged.append(parts[i])
                        i += 1
                parts = merged
        try:
            ids = [self.vocab[p] for p in parts]
        except KeyError as e:
            raise ValueError(f"the vocabulary has no entry {e.args[0]!r} "
                             "(no byte fallback, no unk token)") from None
        if len(self._cache) >= self._CACHE_MAX:
            self._cache.clear()
        self._cache[piece] = ids
        return ids

    def encode(self, text: str) -> list[int]:
        pre = qwen2_pretokenizer()
        ids: list[int] = []
        for tok, raw in self._split_added(text, self._raw, lambda c: c):
            if tok is not None:
                ids.append(self.added[tok]["id"])
                continue
            norm = unicodedata.normalize("NFC", raw)
            for tok, piece in self._split_added(norm, self._norm,
                                                self._norm_tok.__getitem__):
                if tok is not None:
                    ids.append(self.added[tok]["id"])
                    continue
                done = 0
                for m in pre.finditer(piece):
                    if m.start() > done:  # Isolated keeps unmatched gaps
                        ids += self._bpe(piece[done:m.start()])
                    ids += self._bpe(m.group())
                    done = m.end()
                if done < len(piece):
                    ids += self._bpe(piece[done:])
        return ids

    def decode(self, ids) -> str:
        out = bytearray()
        for i in ids:
            i = int(i)
            token = self.added_ids.get(i, self.tokens.get(i))
            if token is not None:
                out += _byte_decode(token, self._byte_of)
        text = out.decode("utf-8", errors="replace")
        return clean_up_tokenization(text) if self.clean_up else text


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
