"""The checkpoint-import slice end to end on the CPU: one tiny snapshot in
the published layout (talker, two-position code predictor, code2wav, tts
and think ids) through both packages' ``load_model(dir)``; and the port's
import, cache and synthesis with ``jax``, ``safetensors``, ``transformers``
and ``ml_dtypes`` blocked, as on the GPU machine."""

import ast
import dataclasses
import os
import subprocess
import sys
import textwrap
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.engine import api as japi
from qwen3_tts_tpu.runtime.sampling import SamplingConfig as JaxSampling
from qwen3_tts_tpu_torch.engine import api as tapi
from qwen3_tts_tpu_torch.engine import configs as tcfgs
from qwen3_tts_tpu_torch.engine.fabricate import write_published_snapshot
from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig

ROOT = Path(__file__).resolve().parent.parent
TEXT = "Hello there, general."
PCM_LSB = 2          # int16 PCM: float32 summation order in the decoders
BF16_LOGITS = 5e-2   # bf16 prefill logits: max error over max |logit|


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A tiny published-layout snapshot with float32 tables, as the JAX
    package's fixtures write them; the tests load it with the cache off."""
    cfg = tcfgs.with_code2wav(tcfgs.tiny_feedback(),
                              tcfgs.tiny_code2wav().code2wav)
    cfg = dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant,
                                                             enabled=True))
    path = tmp_path_factory.mktemp("published")
    write_published_snapshot(str(path), cfg, seed=9, fast=False)
    return str(path)


def _load_both(path):
    jm = japi.load_model(path, cache=False)
    tm = tapi.load_model(path, device="cpu", cache=False)
    for m in (jm, tm):
        assert m.cfg.talker.feedback == "residual_sum"
        assert m.cfg.codec_arch == "code2wav"
        assert m.import_report.unmapped == [] and m.import_report.synthetic == ()
    return jm, tm


def _widen(jm, tm):
    """Both models at float32: the config's dtype replaced and every bf16
    leaf widened (exact)."""
    for m in (jm, tm):
        m.cfg = dataclasses.replace(m.cfg, dtype="float32")
        m._generator = None
    for comp in ("params", "cp_params", "codec_params"):
        setattr(jm, comp, jax.tree.map(
            lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x,
            getattr(jm, comp)))

        def widen(node):
            if isinstance(node, dict):
                return {k: widen(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(widen(v) for v in node)
            return node.float() if node.dtype == torch.bfloat16 else node

        setattr(tm, comp, widen(getattr(tm, comp)))


def _prompt(pkg, model):
    prompts, _ = pkg.prepare_segments(model, TEXT, voice="ryan")
    assert len(prompts) == 1
    return prompts[0]


def test_float32_greedy_codes_equal_the_jax_package(snapshot):
    jm, tm = _load_both(snapshot)
    _widen(jm, tm)
    jm.sampling, tm.sampling = JaxSampling(greedy=True), SamplingConfig(greedy=True)
    jp, tp = _prompt(japi, jm), _prompt(tapi, tm)
    np.testing.assert_array_equal(tp.text_tokens, jp.text_tokens)
    assert tp.rendered == jp.rendered and tp.speaker_token == jp.speaker_token
    ref = jm.generator.synthesize(jp, max_frames=12, collect_codes=True)
    got = tm.generator.synthesize(tp, max_frames=12, collect_codes=True)
    assert got.frames == ref.frames > 4
    np.testing.assert_array_equal(got.codes, ref.codes)
    assert got.wav.shape == ref.wav.shape
    diff = np.abs(got.wav.astype(np.int32) - ref.wav.astype(np.int32))
    assert diff.max() <= PCM_LSB
    assert np.abs(ref.wav).max() > 0


def test_imported_bf16_prefill_logits_agree_and_both_synthesize(snapshot,
                                                                temp_dir):
    jm, tm = _load_both(snapshot)
    logits = {}
    for name, m, pkg in (("jax", jm, japi), ("torch", tm, tapi)):
        gen = m.generator
        emb, pad, _ = gen.assemble_prompt_full(_prompt(pkg, m))
        ck, cv = gen._alloc_cache()
        _, lg, _, _ = gen._prefill_fn()(gen.params, emb, pad, ck, cv)
        logits[name] = np.asarray(
            lg.float() if name == "torch" else lg.astype(jnp.float32))
    err = np.abs(logits["torch"] - logits["jax"]).max()
    assert err <= BF16_LOGITS * np.abs(logits["jax"]).max(), err
    for name, m, pkg in (("jax", jm, japi), ("torch", tm, tapi)):
        out = os.path.join(temp_dir, name)
        metrics = pkg.generate_audio(model=m, text=TEXT, voice="ryan",
                                     output_path=out, max_frames=8)
        with wave.open(os.path.join(out, "audio_000.wav"), "rb") as w:
            skip = m.cfg.code2wav.startup_samples
            assert w.getnframes() == metrics["frames"] * m.cfg.codec.hop - skip


BLOCKED = textwrap.dedent("""
    import os, sys, tempfile, warnings
    for name in ("jax", "jaxlib", "safetensors", "transformers", "ml_dtypes",
                 "tokenizers", "regex"):
        sys.modules[name] = None
    sys.path.insert(0, os.path.join(sys.argv[1], "src"))
    import torch
    from qwen3_tts_tpu_torch.engine import configs, generate_audio, load_model
    from qwen3_tts_tpu_torch.engine.fabricate import write_published_snapshot
    from qwen3_tts_tpu_torch.engine.weights import NATIVE_DIR

    cfg = configs.with_code2wav(configs.tiny_feedback(),
                                configs.tiny_code2wav().code2wav)
    cfg = configs.with_quant(cfg, True)
    tmp = tempfile.TemporaryDirectory()
    snap = tmp.name
    write_published_snapshot(snap, cfg, seed=1, fast=True)
    # a 256-entry text vocabulary: no tokenizer files, the byte tokenizer
    assert not os.path.exists(os.path.join(snap, "tokenizer.json"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        first = load_model(snap, device="cpu")
    assert not [w for w in caught if "tokenizer" in str(w.message)], caught
    assert type(first.tokenizer).__name__ == "ByteTokenizer"
    assert first.import_report.unmapped == []
    assert os.path.exists(os.path.join(snap, NATIVE_DIR, "tts_config.json"))
    again = load_model(snap, device="cpu")
    assert set(again.load_times) == {"native_load_s", "to_device_s"}
    for comp in ("params", "cp_params", "codec_params"):
        a, b = getattr(first, comp), getattr(again, comp)
        def same(x, y):
            if isinstance(x, dict):
                return all(same(x[k], y[k]) for k in x)
            if isinstance(x, (list, tuple)):
                return all(same(u, v) for u, v in zip(x, y))
            return x.dtype == y.dtype and torch.equal(x, y)
        assert same(a, b), comp
    m = generate_audio(model=again, text="hi there", voice="ryan",
                       output_path=snap, max_frames=6)
    assert m["frames"] > 0
    assert not [n for n in ("jax", "safetensors", "transformers", "ml_dtypes",
                            "tokenizers", "regex")
                if sys.modules.get(n) is not None]
    tmp.cleanup()
    print("OK")
""")


def test_port_imports_caches_and_synthesizes_without_jax_or_safetensors():
    proc = subprocess.run([sys.executable, "-c", BLOCKED, str(ROOT)],
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


def test_no_port_module_imports_the_missing_packages_at_top_level():
    """The GPU machine has no safetensors, transformers, ml_dtypes, rich or
    prompt_toolkit: the port and chip_smoke.py import them nowhere at
    module level (the HF tokenizer imports transformers inside its
    constructor, offer_transcribe the terminal UI inside its body)."""
    files = sorted((ROOT / "src" / "qwen3_tts_tpu_torch").rglob("*.py"))
    for path in files + [ROOT / "chip_smoke.py"]:
        for node in ast.parse(path.read_text()).body:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "safetensors", "transformers", "ml_dtypes", "jax", "rich",
                    "prompt_toolkit"), (path, name)
