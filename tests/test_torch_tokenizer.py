"""The port's Qwen byte-level BPE encoder (``QwenBPETokenizer``) against
transformers' AutoTokenizer, the JAX package's ``HFTokenizer``, on the
fabricated Qwen2-style tokenizer files (``fabricate.write_qwen_tokenizer``):
equal ids on every golden text (ASCII, digits, CJK, emoji, contractions,
runs of spaces, CR LF, tabs, a string NFC changes, the ChatML prompts of
all three modes), equal vocabulary sizes, decode round trips, the added
tokens' flags, the vocab.json + merges.txt layout, encoding with
transformers, tokenizers and regex blocked, and the refusal of components
the encoder does not implement.

The golden ids (qwen_bpe_golden.json, beside this file) are transformers'
ids on the fabricated files; chip_smoke.py holds the GPU machine's encoder
against them. ``PYTHONPATH=src:tests python tests/test_torch_tokenizer.py``
rewrites them."""

import json
import os
import shutil
import subprocess
import sys
import unicodedata
import warnings
from pathlib import Path

import pytest

from qwen3_tts_tpu.engine.tokenizer import HFTokenizer, load_tokenizer as jax_load
from qwen3_tts_tpu.runtime.prompts import validate_special_tokens
from qwen3_tts_tpu_torch.engine.fabricate import (
    QWEN_CHATML,
    QWEN_SPECIAL_TOKENS,
    write_qwen_tokenizer,
)
from qwen3_tts_tpu_torch.engine.tokenizer import QwenBPETokenizer, load_tokenizer
from qwen3_tts_tpu_torch.runtime.prompts import PromptTemplate

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = Path(__file__).resolve().parent / "qwen_bpe_golden.json"


def golden_texts() -> dict:
    """{case: text} of the golden file."""
    chat = PromptTemplate(chat_template=QWEN_CHATML, source="chat_template")
    return {
        "ascii": "Hello there, general. The quick brown fox!",
        "digits": "Call 555-0199 at 10:45, or pay $3.14 in 2026.",
        "cjk": "你好，世界。今天天气很好。こんにちは、안녕하세요",
        "emoji": "Great job 🙂👍🏽 — see you 🚀!",
        "contractions": "He'S here; we'll go, they'RE sure, I'd say 'tis.",
        "spaces": "a  b   c    d     end  ",
        "crlf": "first line\r\nsecond line\r\n\r\nthird",
        "tabs": "\tcol1\tcol2\t\tcol4\n\t indented",
        "nfc": "Café naïve Å Å",
        "chatml_custom": chat.render("custom", "Hello there.",
                                     instruct="Speak happily."),
        "chatml_design": chat.render("design", "Read this.",
                                     instruct="A deep calm narrator voice."),
        "chatml_base": chat.render("base", "Target text.",
                                   ref_text="The reference transcript."),
        "tts_markers": "<|instruct|>Warm.<|/instruct|>Hi <|voice|>x<|/voice|>",
    }


def _golden() -> dict:
    with open(GOLDEN, encoding="utf-8") as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("qwen_tok"))
    write_qwen_tokenizer(path)
    return path


@pytest.fixture(scope="module")
def pair(tok_dir):
    """(the JAX package's HFTokenizer, the port's QwenBPETokenizer), both
    picked by each package's load_tokenizer."""
    hf = jax_load(tok_dir, 151_936)
    assert isinstance(hf, HFTokenizer)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port = load_tokenizer(tok_dir, 151_936)
    assert isinstance(port, QwenBPETokenizer)
    return hf, port


@pytest.mark.parametrize("case", sorted(golden_texts()))
def test_ids_equal_transformers_and_the_golden(pair, case):
    hf, port = pair
    text = golden_texts()[case]
    want = hf.encode(text)
    assert port.encode(text) == want
    assert _golden()["cases"][case] == {"text": text, "ids": want}
    assert port.decode(want) == hf.decode(want) == unicodedata.normalize(
        "NFC", text)
    if case.startswith("chatml"):
        validate_special_tokens(text, port)
        assert want != list(text.encode("utf-8"))


def test_vocab_size_and_added_tokens(pair):
    hf, port = pair
    assert port.vocab_size == hf.vocab_size == _golden()["vocab_size"] >= 512
    for marker in QWEN_SPECIAL_TOKENS:
        assert port.encode(marker) == hf.encode(marker)
        assert len(port.encode(marker)) == 1
    assert port.decode([10**9]) == hf.decode([]) == ""


def _with_added_flags(src: str, dst: str, **flags) -> None:
    """A copy of the files with ``flags`` set on two added tokens, in
    tokenizer.json and in tokenizer_config.json alike."""
    shutil.copytree(src, dst)
    for name in ("tokenizer.json", "tokenizer_config.json"):
        p = os.path.join(dst, name)
        with open(p, encoding="utf-8") as fh:
            tj = json.load(fh)
        toks = (tj["added_tokens"] if name == "tokenizer.json"
                else tj["added_tokens_decoder"].values())
        for tok in toks:
            if tok["content"] in ("<|instruct|>", "<|voice|>"):
                tok.update(flags)
        with open(p, "w", encoding="utf-8") as fh:
            json.dump(tj, fh, ensure_ascii=False)


@pytest.mark.parametrize("flags", [
    {"lstrip": True}, {"rstrip": True}, {"single_word": True},
    {"normalized": True}, {"lstrip": True, "rstrip": True}],
    ids=["lstrip", "rstrip", "single_word", "normalized", "both_strips"])
def test_added_token_flags_match_transformers(tok_dir, tmp_path, flags):
    d = str(tmp_path / "flags")
    _with_added_flags(tok_dir, d, **flags)
    hf, port = HFTokenizer(d), QwenBPETokenizer(d)
    for text in ("a  <|instruct|>  b", "x<|instruct|>y <|voice|> z",
                 "<|voice|>\n\n<|instruct|>", "Café<|voice|>é",
                 " <|instruct|>", "word<|voice|> word"):
        assert port.encode(text) == hf.encode(text), text


def test_vocab_json_and_merges_txt_layout(tok_dir, tmp_path, pair):
    """Without tokenizer.json the encoder reads vocab.json, merges.txt and
    the added tokens of tokenizer_config.json, as transformers'
    Qwen2Tokenizer does."""
    d = str(tmp_path / "slow")
    shutil.copytree(tok_dir, d)
    os.remove(os.path.join(d, "tokenizer.json"))
    hf = pair[0]
    port = QwenBPETokenizer(d)
    assert port.vocab_size == hf.vocab_size
    for text in golden_texts().values():
        assert port.encode(text) == hf.encode(text)


@pytest.mark.parametrize("part,value", [
    ("normalizer", {"type": "NFKC"}),
    ("normalizer", None),
    ("pre_tokenizer", {"type": "ByteLevel", "add_prefix_space": False}),
    ("pattern", r"\s+|\S+"),
    ("model_type", "WordPiece"),
    ("decoder", {"type": "WordPiece"}),
    ("flag", "yes"),
], ids=["nfkc", "no_normalizer", "bytelevel_only", "other_pattern",
        "wordpiece", "decoder", "flag_value"])
def test_unknown_components_raise(tok_dir, tmp_path, part, value):
    d = str(tmp_path / "bad")
    shutil.copytree(tok_dir, d)
    p = os.path.join(d, "tokenizer.json")
    with open(p, encoding="utf-8") as fh:
        tj = json.load(fh)
    if part == "pattern":
        tj["pre_tokenizer"]["pretokenizers"][0]["pattern"] = {"Regex": value}
    elif part == "model_type":
        tj["model"]["type"] = value
    elif part == "flag":
        tj["added_tokens"][0]["lstrip"] = value
    else:
        tj[part] = value
    with open(p, "w", encoding="utf-8") as fh:
        json.dump(tj, fh, ensure_ascii=False)
    with pytest.raises(ValueError):
        load_tokenizer(d, 151_936)


BLOCKED = """
import json, sys, warnings
for name in ("transformers", "tokenizers", "regex", "jax", "jaxlib"):
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1] + "/src")
from qwen3_tts_tpu_torch.engine.tokenizer import load_tokenizer
with warnings.catch_warnings():
    warnings.simplefilter("error")
    tok = load_tokenizer(sys.argv[2], 151_936)
    golden = json.load(open(sys.argv[3], encoding="utf-8"))
    assert type(tok).__name__ == "QwenBPETokenizer", type(tok)
    for case in golden["cases"].values():
        assert tok.encode(case["text"]) == case["ids"], case["text"]
print("OK")
"""


def test_encodes_with_transformers_tokenizers_and_regex_blocked(tok_dir):
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED, str(ROOT), tok_dir, str(GOLDEN)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "OK"


def write_golden(path: Path = GOLDEN) -> None:
    """transformers' ids of every golden text on freshly fabricated files."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        write_qwen_tokenizer(d)
        hf = HFTokenizer(d)
        out = {"vocab_size": hf.vocab_size,
               "cases": {k: {"text": t, "ids": hf.encode(t)}
                         for k, t in sorted(golden_texts().items())}}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(out, fh, ensure_ascii=False, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    write_golden()
