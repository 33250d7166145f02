"""The port's Whisper (qwen3_tts_tpu_torch.models.whisper) and its
detokenizer (engine/tokenizer.py::WhisperTokenizer) against the JAX
package's Whisper and, where tests/test_whisper.py uses it, transformers,
on one fabricated tiny snapshot (engine/fabricate.py::
write_whisper_snapshot: config.json, model.safetensors, the tokenizer
files over the whole vocabulary)."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.models import whisper as jw
from qwen3_tts_tpu_torch.audio import write_wav
from qwen3_tts_tpu_torch.engine.fabricate import (
    whisper_config_dict,
    whisper_tensors,
    write_whisper_snapshot,
    write_whisper_tokenizer,
)
from qwen3_tts_tpu_torch.engine.safetensors_io import save_file
from qwen3_tts_tpu_torch.engine.tokenizer import WhisperTokenizer
from qwen3_tts_tpu_torch.models import whisper as tw
from torch_port_helpers import assert_trees_equal, one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

transformers = pytest.importorskip("transformers")

# tests/test_whisper.py's tiny widths; 448 target positions, so that
# WhisperASR's 224 new tokens fit the position table
TINY = whisper_config_dict(32, (2, 2), 4, 64, 8, 51_000)
MEL_ATOL = 1e-5      # float32 log-mel: two FFT implementations
ENC_ATOL = 1e-5      # float32 encoder states (|x| ~ 3): summation order
LOGIT_ATOL = 1e-5    # float32 teacher-forced logits: summation order
HF_ATOL = 3e-4       # against transformers, as tests/test_whisper.py


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    return write_whisper_snapshot(str(tmp_path_factory.mktemp("whisper")),
                                  TINY, seed=0)


@pytest.fixture(scope="module")
def trees(snap):
    """(JAX params, JAX cfg, port params, port cfg) of the snapshot."""
    jp, jc = jw.import_hf_whisper(snap)
    tp, tc = tw.import_hf_whisper(snap)
    return jp, jc, tp, tc


def _features(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal(3 * tw.SAMPLE_RATE).astype(np.float32) * 0.2
    return np.array(jw.log_mel_spectrogram(
        jnp.asarray(jw.pad_or_trim(audio)), TINY["num_mel_bins"]))


# -- frontend ----------------------------------------------------------------

def test_mel_filters_equal_jax_and_match_transformers():
    from transformers.audio_utils import mel_filter_bank

    for n_mels in (80, 128):
        np.testing.assert_array_equal(tw.mel_filters(n_mels),
                                      jw.mel_filters(n_mels))
    theirs = mel_filter_bank(
        num_frequency_bins=201, num_mel_filters=80, min_frequency=0.0,
        max_frequency=8000.0, sampling_rate=16_000, norm="slaney",
        mel_scale="slaney")
    np.testing.assert_allclose(tw.mel_filters(80), theirs, atol=1e-6)


@pytest.mark.parametrize("seconds", [2.0, 31.0])
def test_log_mel_matches_jax_and_the_feature_extractor(seconds):
    from transformers import WhisperFeatureExtractor

    rng = np.random.default_rng(0)
    audio = rng.standard_normal(int(seconds * tw.SAMPLE_RATE)).astype(
        np.float32) * 0.3
    window = tw.pad_or_trim(audio)
    np.testing.assert_array_equal(window, jw.pad_or_trim(audio))
    ours = tw.log_mel_spectrogram(torch.from_numpy(window), 8).numpy()
    assert ours.shape == (3000, 8) and ours.dtype == np.float32
    jax_f = np.asarray(jw.log_mel_spectrogram(jnp.asarray(window), 8))
    np.testing.assert_allclose(ours, jax_f, atol=MEL_ATOL)
    theirs = WhisperFeatureExtractor(feature_size=8)(
        window, sampling_rate=16_000, return_tensors="np")["input_features"][0]
    np.testing.assert_allclose(ours.T, theirs, atol=2e-4)


# -- weights -----------------------------------------------------------------

@pytest.mark.parametrize("layout", ["f32", "f16", "bf16", "pytorch_bin"])
def test_imported_trees_are_bit_equal_to_jax(layout, tmp_path):
    """One snapshot per storage: both importers give the same float32
    leaves (the JAX package's stacked layers as stacked tensors)."""
    d = str(tmp_path)
    with open(os.path.join(d, "config.json"), "w") as fh:
        json.dump(TINY, fh)
    tensors = {k: torch.from_numpy(v)
               for k, v in whisper_tensors(TINY, seed=1).items()}
    if layout == "pytorch_bin":
        torch.save(tensors, os.path.join(d, "pytorch_model.bin"))
    else:
        dt = {"f32": torch.float32, "f16": torch.float16,
              "bf16": torch.bfloat16}[layout]
        save_file({k: v.to(dt) for k, v in tensors.items()},
                  os.path.join(d, "model.safetensors"))
    jp, jc = jw.import_hf_whisper(d)
    tp, tc = tw.import_hf_whisper(d)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert_trees_equal(tp, jax.tree.map(np.asarray, jp))
    assert tp["enc_layers"]["fc1"]["w"].shape == (2, 64, 32)


def test_import_raises_on_what_it_cannot_map(tmp_path, snap):
    d = str(tmp_path)
    shutil.copy(os.path.join(snap, "config.json"), d)
    with pytest.raises(FileNotFoundError):
        tw.import_hf_whisper(d)
    tensors = whisper_tensors(TINY, seed=0)
    del tensors["model.decoder.layers.1.fc2.weight"]
    save_file(tensors, os.path.join(d, "model.safetensors"))
    with pytest.raises(KeyError):
        tw.import_hf_whisper(d)


# -- model ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def hf_model(snap):
    from transformers import WhisperForConditionalGeneration

    return WhisperForConditionalGeneration.from_pretrained(snap).eval()


def test_encoder_matches_jax_and_transformers(trees, hf_model):
    jp, jc, tp, tc = trees
    feats = _features(1)
    ours = tw.encode(tp, tc, torch.from_numpy(feats)).numpy()
    assert ours.shape == (1500, 32)
    np.testing.assert_allclose(
        ours, np.asarray(jw.encode(jp, jc, jnp.asarray(feats))), atol=ENC_ATOL)
    with torch.no_grad():
        theirs = hf_model.model.encoder(
            torch.from_numpy(feats.T[None])).last_hidden_state[0].numpy()
    np.testing.assert_allclose(ours, theirs, atol=HF_ATOL)


def test_teacher_forced_decoder_logits_match(trees, hf_model):
    jp, jc, tp, tc = trees
    feats = _features(2)
    ids = [tc.decoder_start_token_id, 11, 7, 42, 3]
    T = len(ids)
    enc = tw.encode(tp, tc, torch.from_numpy(feats))
    ck_x, cv_x = tw.cross_kv(tp, tc, enc)
    cache = torch.zeros((tc.decoder_layers, T, tc.n_heads, tc.head_dim))
    cache_v = torch.zeros_like(cache)
    ours = np.stack([tw.decoder_step(tp, tc, tok, pos, cache, cache_v,
                                     ck_x, cv_x).numpy()
                     for pos, tok in enumerate(ids)])
    jenc = jw.encode(jp, jc, jnp.asarray(feats))
    jk, jv = jw._cross_kv(jp, jc, jenc)
    ck = jnp.zeros((jc.decoder_layers, T, jc.n_heads, jc.head_dim))
    cv = jnp.zeros_like(ck)
    want = []
    for pos, tok in enumerate(ids):
        logits, ck, cv = jw._decoder_step(jp, jc, jnp.int32(tok),
                                          jnp.int32(pos), ck, cv, jk, jv)
        want.append(np.asarray(logits))
    np.testing.assert_allclose(ours, np.stack(want), atol=LOGIT_ATOL)
    with torch.no_grad():
        theirs = hf_model(input_features=torch.from_numpy(feats.T[None]),
                          decoder_input_ids=torch.tensor([ids])).logits[0]
    np.testing.assert_allclose(ours, theirs.numpy(), atol=HF_ATOL)


@pytest.mark.parametrize("case", ["no_eos", "eos_first", "short_prefix"])
def test_greedy_tokens_and_n_valid_equal_jax(case, trees, tmp_path, snap):
    """Exact tokens and n_valid: a window that never reaches EOS, one whose
    first sampled token is made the EOS id (the port stops at once, the
    JAX scan runs on), and a one-token prefix."""
    jp, jc, tp, tc = trees
    feats = _features(3)
    prefix = np.asarray([50258, 50259, 50360, 50364], np.int32)
    if case == "short_prefix":
        prefix = prefix[:1]
    if case == "eos_first":
        first, _ = tw.greedy_decode(tp, tc, torch.from_numpy(feats), prefix,
                                    max_new=1)
        jc = dataclasses.replace(jc, eos_token_id=int(first[0]))
        tc = dataclasses.replace(tc, eos_token_id=int(first[0]))
    got, n = tw.greedy_decode(tp, tc, torch.from_numpy(feats), prefix,
                              max_new=12)
    want, wn = jw.greedy_decode(jp, jc, jnp.asarray(feats),
                                jnp.asarray(prefix), max_new=12)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    assert n == int(wn) == (0 if case == "eos_first" else 12)


# -- detokenizer ---------------------------------------------------------------

def _byte_ids(text: str) -> list[int]:
    """The byte-level vocabulary's single-byte ids of ``text``'s UTF-8."""
    from qwen3_tts_tpu_torch.engine.tokenizer import bytes_to_unicode

    order = list(bytes_to_unicode())  # ids 0..255 in the vocabulary
    return [order.index(b) for b in text.encode("utf-8")]


def _cases(tok) -> list[list[int]]:
    sot, en, tr, nots = (tok.token_to_id(t) for t in (
        "<|startoftranscript|>", "<|en|>", "<|transcribe|>",
        "<|notimestamps|>"))
    eot, prev = tok.token_to_id("<|endoftext|>"), tok.token_to_id(
        "<|startofprev|>")
    stamp = tok.token_to_id("<|1.00|>")
    text = _byte_ids(" Héllo , wörld ! it 's 日本語 . ") + [300, 4000, 50000]
    return [
        [sot, en, tr, nots] + text + [eot],
        [sot, stamp] + text[:9] + [stamp + 3] + text[9:] + [eot],
        [prev] + _byte_ids(" earlier words") + [sot, en] + text,
        [prev] + text,                                  # prompt, no sot
        _byte_ids("caf") + _byte_ids("é")[:1] + _byte_ids(" x"),  # torn UTF-8
        [],
    ]


def test_detokenizer_matches_transformers(snap):
    """Specials, the prompt cut, timestamps, multi-byte and torn UTF-8,
    with and without skipping: as transformers' fast Whisper tokenizer
    (the JAX WhisperASR's AutoTokenizer; spaces cleaned up, as the
    snapshot's config asks) and its slow WhisperTokenizer (which cleans up
    nothing)."""
    from transformers import AutoTokenizer
    from transformers import WhisperTokenizer as HFSlow

    ours = WhisperTokenizer(snap)
    fast, slow = AutoTokenizer.from_pretrained(snap), HFSlow.from_pretrained(snap)
    assert ours.clean_up
    for tok_str in ("<|en|>", "<|transcribe|>", "<|notimestamps|>",
                    "<|endoftext|>", "<|0.00|>", "Ā"):
        assert ours.token_to_id(tok_str) == fast.convert_tokens_to_ids(tok_str)
    assert ours.token_to_id("<|xx|>") is None
    for ids in _cases(ours):
        for skip in (True, False):
            assert ours.decode(ids, skip_special_tokens=skip) == fast.decode(
                ids, skip_special_tokens=skip), (ids, skip)
    ours.clean_up = False
    for ids in _cases(ours):
        for skip in (True, False):
            assert ours.decode(ids, skip_special_tokens=skip) == slow.decode(
                ids, skip_special_tokens=skip), (ids, skip)


def test_detokenizer_reads_tokenizer_json(snap, tmp_path):
    """A snapshot that ships only tokenizer.json (as transformers saves
    it) decodes as the vocab.json + added_tokens.json one."""
    from transformers import AutoTokenizer

    d = str(tmp_path)
    AutoTokenizer.from_pretrained(snap).save_pretrained(d)
    for name in ("vocab.json", "added_tokens.json", "merges.txt",
                 "special_tokens_map.json"):
        if os.path.exists(os.path.join(d, name)):
            os.remove(os.path.join(d, name))
    assert os.path.exists(os.path.join(d, "tokenizer.json"))
    a, b = WhisperTokenizer(d), WhisperTokenizer(snap)
    assert a.ids == b.ids and a.special == b.special
    for ids in _cases(b):
        assert a.decode(ids, True) == b.decode(ids, True)
    with pytest.raises(FileNotFoundError):
        WhisperTokenizer(str(tmp_path / "absent"))


def test_tokenizer_files_cover_the_published_vocabulary(tmp_path):
    """large-v3's 51,866 ids: the base entries, <|endoftext|> at 50257,
    the 100 languages, the task tokens and 1,501 timestamps to 30.00."""
    write_whisper_tokenizer(str(tmp_path), 51_866)
    tok = WhisperTokenizer(str(tmp_path))
    assert len(tok.ids) == 51_866 and max(tok.ids.values()) == 51_865
    assert tok.token_to_id("<|endoftext|>") == 50257
    assert tok.token_to_id("<|startoftranscript|>") == 50258
    assert tok.token_to_id("<|en|>") == 50259
    assert tok.token_to_id("<|yue|>") == 50358
    assert tok.token_to_id("<|notimestamps|>") == 50364
    assert tok.token_to_id("<|0.00|>") == 50365
    assert tok.token_to_id("<|30.00|>") == 51865
    assert len(tok.special) == 108  # the timestamps are not special


# -- WhisperASR ----------------------------------------------------------------

def test_transcript_equals_the_jax_whisper_asr(snap, tmp_path, monkeypatch):
    """WhisperASR on the same directory and WAV (16 kHz and 24 kHz, the
    latter resampled): the port's text is the JAX package's."""
    rng = np.random.default_rng(4)
    jasr = jw.WhisperASR(snap)
    monkeypatch.setenv("QWEN3_TTS_ASR_DEVICE", "cpu")
    asr = tw.WhisperASR(snap)
    assert asr.device.type == "cpu"
    np.testing.assert_array_equal(asr.prefix, jasr.prefix)
    for sr in (16_000, 24_000):
        path = str(tmp_path / f"speech_{sr}.wav")
        write_wav(path, (0.2 * rng.standard_normal(sr)).astype(np.float32), sr)
        text = asr.transcribe_wav(path)
        assert isinstance(text, str) and text
        assert text == jasr.transcribe_wav(path)
    assert set(asr.load_times) == {"import_s", "to_device_s"}


def test_whisper_asr_runs_on_cuda_unless_asked(snap, monkeypatch):
    monkeypatch.delenv("QWEN3_TTS_ASR_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tw.WhisperASR(snap)
    assert tw.WhisperASR(snap, device="cpu").device.type == "cpu"
    monkeypatch.setenv("QWEN3_TTS_ASR_DEVICE", "cpu")
    assert tw.asr_device().type == "cpu"
    with pytest.raises(ValueError, match="positions"):
        tw.greedy_decode(*tw.import_hf_whisper(snap),
                         torch.zeros(3000, 8), [50258], max_new=448)
