"""Cloning in the port (``generate_audio(ref_audio=..., ref_text=...)``)
against the JAX package on the CPU: the synthetic codec encoder, both RVQ
branches and the speaker vector; the Mimi speech tokenizer
(``models/speech_tokenizer.py``) against the JAX package's and the
transformers ``MimiModel``; its import, native round trips across packages,
``encode_reference``'s buckets; greedy float32 cloning on
``synthetic:tiny:base`` and on an imported Mimi snapshot, single-stream and
through the serving engine; and the port cloning with ``jax``,
``safetensors``, ``transformers`` and ``ml_dtypes`` blocked.

The reference clips are seeded so that every RVQ argmin has a margin far
above float32 summation-order noise: ``_clip(seed=3)`` leaves the tiny
float32 synthetic encoder's argmins a relative margin of 3.5e-3 (measured
with the expanded |c|^2 - 2 r.c distances), against ~1e-6 of noise."""

import dataclasses
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.engine import api as japi
from qwen3_tts_tpu.engine import configs as jcfgs
from qwen3_tts_tpu.engine import weights as jweights
from qwen3_tts_tpu.models import codec as jcodec
from qwen3_tts_tpu.models import speech_tokenizer as JST
from qwen3_tts_tpu.runtime.prompts import PromptSpec as JaxPrompt
from qwen3_tts_tpu.runtime.sampling import SamplingConfig as JaxSampling
from qwen3_tts_tpu.runtime.serving import ServingEngine as JaxEngine
from qwen3_tts_tpu_torch.audio import read_wav, resample, to_mono, write_wav
from qwen3_tts_tpu_torch.engine import api as tapi
from qwen3_tts_tpu_torch.engine import configs as tcfgs
from qwen3_tts_tpu_torch.engine import weights as tweights
from qwen3_tts_tpu_torch.engine.fabricate import write_published_snapshot
from qwen3_tts_tpu_torch.models import codec as tcodec
from qwen3_tts_tpu_torch.models import speech_tokenizer as TST
from qwen3_tts_tpu_torch.runtime.prompts import PromptSpec
from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig
from qwen3_tts_tpu_torch.runtime.serving import ServingEngine
from torch_port_helpers import assert_trees_equal

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-5  # float32 latents and speaker vectors: summation order only
TEXT = "Hello there, general."
REF_TEXT = "A reference transcript."


def _clip(seconds: float = 1.0, sr: int = 24000, seed: int = 3) -> np.ndarray:
    """A gliding tone with a little noise (chip_smoke.py's reference)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f = 110 + 40 * np.sin(2 * np.pi * 0.7 * t)
    return (0.3 * np.sin(2 * np.pi * np.cumsum(f) / sr)
            + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


def _base_f32(cfgmod):
    return dataclasses.replace(cfgmod.tiny("base", quant=True), dtype="float32")


@pytest.fixture(scope="module")
def synthetic():
    """(JAX model, port model): synthetic:tiny:base at float32, one numpy
    draw (the port's host initialisers draw the JAX package's values)."""
    jm = japi.Qwen3TTSModel.synthetic(_base_f32(jcfgs), seed=0)
    tm = tapi.Qwen3TTSModel.synthetic(_base_f32(tcfgs), seed=0, device="cpu")
    jm.sampling, tm.sampling = JaxSampling(greedy=True), SamplingConfig(greedy=True)
    return jm, tm


def _codec_pair(cfg_name: str):
    """(JAX config, port config, numpy codec tree with the encoder, port
    tree). A code2wav JAX tree gets a stand-in ``dec.cb0_emb`` of the
    encoder's dtype: the only leaf JAX encode_waveform reads there."""
    build = {"rvq": lambda m: m.tiny("base"),
             "code2wav": lambda m: m.tiny_code2wav("base")}[cfg_name]
    jc = dataclasses.replace(build(jcfgs), dtype="float32")
    tc = dataclasses.replace(build(tcfgs), dtype="float32")
    tree = jcodec.init_codec(jc, 2)
    port = tweights.tree_to(tree, "cpu")
    if cfg_name == "code2wav":
        tree = {**tree, "dec": {"cb0_emb": np.zeros((1, 1), np.float32)}}
    return jc, tc, tree, port


@pytest.mark.parametrize("cfg_name", ["rvq", "code2wav"])
def test_encoder_rvq_and_speaker_vector_match_jax(cfg_name):
    """encode_waveform, rvq_quantize (its rvq or code2wav branch) and
    speaker_embedding on the same waveform and tree: latents and speaker
    vectors within ATOL, codes equal."""
    jc, tc, jtree, ttree = _codec_pair(cfg_name)
    T = 6
    wav = _clip()[:T * tc.codec.hop][None]
    j_lat = np.array(jcodec.encode_waveform(jtree, jc, jnp.asarray(wav)))
    t_lat = tcodec.encode_waveform(ttree, tc, torch.from_numpy(wav))
    assert t_lat.shape == (1, T, tc.codec.latent_dim) and t_lat.dtype == torch.float32
    np.testing.assert_allclose(t_lat.numpy(), j_lat, atol=ATOL)
    # the same latent into both quantizers: integer codes, equal
    j_codes = np.asarray(jcodec.rvq_quantize(jtree, jc, jnp.asarray(j_lat)))
    t_codes = tcodec.rvq_quantize(ttree, tc, torch.from_numpy(j_lat))
    np.testing.assert_array_equal(t_codes.numpy(), j_codes)
    Q = tc.code2wav.num_quantizers if cfg_name == "code2wav" \
        else tc.codec.num_codebooks
    assert t_codes.shape == (1, Q, T)
    for n_frames in (None, 4):
        j_spk = np.asarray(jcodec.speaker_embedding(jtree, jc, jnp.asarray(j_lat),
                                                    n_frames=n_frames))
        t_spk = tcodec.speaker_embedding(ttree, tc, torch.from_numpy(j_lat),
                                         n_frames=n_frames)
        np.testing.assert_allclose(t_spk.numpy(), j_spk, atol=ATOL)


# -- the Mimi speech tokenizer --------------------------------------------------

_HF_ST_CFG = {"head_dim": 16, "num_attention_heads": 2,
              "num_key_value_heads": 2, "sampling_rate": 1000}


@pytest.fixture(scope="module")
def tiny_mimi():
    """The tiny transformers MimiModel of tests/test_speech_tokenizer.py,
    by seed (its codebooks and layer scales given real values)."""
    pytest.importorskip("transformers")
    from transformers.models.mimi.configuration_mimi import MimiConfig
    from transformers.models.mimi.modeling_mimi import MimiModel

    def build(seed):
        torch.manual_seed(seed)
        cfg = MimiConfig(
            hidden_size=32, num_filters=8, num_residual_layers=1,
            upsampling_ratios=[4, 2], codebook_size=64, codebook_dim=16,
            num_quantizers=4, num_semantic_quantizers=1,
            sliding_window=8, num_hidden_layers=2, num_attention_heads=2,
            num_key_value_heads=2, head_dim=16, intermediate_size=64,
            vector_quantization_hidden_dimension=16,
            sampling_rate=1000, frame_rate=62.5, upsample_groups=8,
        )
        m = MimiModel(cfg).eval()
        with torch.no_grad():
            for rvq in (m.quantizer.semantic_residual_vector_quantizer,
                        m.quantizer.acoustic_residual_vector_quantizer):
                for layer in rvq.layers:
                    layer.codebook.embed_sum.normal_(0, 1.0)
                    layer.codebook.cluster_usage.fill_(1.0)
            for lyr in m.encoder_transformer.layers:
                lyr.self_attn_layer_scale.scale.normal_(0, 0.1)
                lyr.mlp_layer_scale.scale.normal_(0, 0.1)
        return m

    return build


def _import_both(tensors: dict):
    """(port config, port tree, JAX config, JAX tree, port count) from
    prefix-free Mimi tensors (torch tensors for the port, numpy for JAX)."""
    tcfg = TST.st_config_from_tensors(tensors, _HF_ST_CFG)
    jcfg = JST.st_config_from_tensors(
        {k: v.numpy() for k, v in tensors.items()}, _HF_ST_CFG)
    t_unmapped, j_unmapped = [], []
    tparams, tn = TST.import_speech_tokenizer(tensors, tcfg, t_unmapped)
    jparams, jn = JST.import_speech_tokenizer(
        {k: v.numpy() for k, v in tensors.items()}, jcfg, j_unmapped)
    assert (tn, t_unmapped) == (jn, j_unmapped) and tn > 0 and not t_unmapped
    return tcfg, tparams, jcfg, jparams


@pytest.mark.parametrize("seed,n_samples", [(0, 321), (1, 400), (2, 97)])
def test_st_encode_equals_jax_and_transformers_mimi(tiny_mimi, seed, n_samples):
    """The imported tree is bit-equal to the JAX importer's and its config
    equal; st_encode's codes equal the JAX package's and the transformers
    MimiModel's (integer outputs: exact)."""
    m = tiny_mimi(seed)
    tcfg, tparams, jcfg, jparams = _import_both(dict(m.state_dict()))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert_trees_equal(tparams, jparams)
    wav = (np.random.default_rng(seed).standard_normal(n_samples) * 0.3
           ).astype(np.float32)
    with torch.no_grad():
        want = np.asarray(m.encode(torch.tensor(wav)[None, None, :]).audio_codes)
    got = TST.st_encode(tparams, tcfg, torch.from_numpy(wav)[None]).numpy()
    ref = np.asarray(JST.st_encode(jparams, jcfg, jnp.asarray(wav)[None]))
    assert got.shape == want.shape
    assert got.shape[2] == TST.st_frames(tcfg, n_samples) \
        == JST.st_frames(jcfg, n_samples)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, want)


def test_trailing_zeros_keep_whole_frames(tiny_mimi, synthetic):
    """encode_reference pads a clip to a frame bucket: every whole frame's
    codes equal the unpadded encode's, for the Mimi speech tokenizer and
    for the synthetic codec encoder."""
    tcfg, tparams, _, _ = _import_both(dict(tiny_mimi(0).state_dict()))
    wav = (np.random.default_rng(3).standard_normal(5 * tcfg.hop + 3) * 0.3
           ).astype(np.float32)
    whole = len(wav) // tcfg.hop
    codes = TST.st_encode(tparams, tcfg, torch.from_numpy(wav)[None])
    padded = np.zeros(16 * tcfg.hop, np.float32)
    padded[:len(wav)] = wav
    codes_p = TST.st_encode(tparams, tcfg, torch.from_numpy(padded)[None])
    np.testing.assert_array_equal(codes_p[:, :, :whole], codes[:, :, :whole])

    _, tm = synthetic
    hop = tm.cfg.codec.hop
    clip = _clip()[:5 * hop]
    direct = tcodec.rvq_quantize(tm.codec_params, tm.cfg, tcodec.encode_waveform(
        tm.codec_params, tm.cfg, torch.from_numpy(clip)[None]))
    bucketed, _ = tm.encode_reference(clip)
    np.testing.assert_array_equal(bucketed, direct[0].numpy())


@pytest.mark.parametrize("n_seconds,frames,bucket", [(1.0, 12, 64),
                                                     (6.0, 72, 128)])
def test_encode_reference_buckets_trims_and_matches_jax(synthetic, monkeypatch,
                                                        n_seconds, frames,
                                                        bucket):
    """The synthetic route pads to the frame bucket, trims back to the
    clip's frames, and returns int32 codes equal to the JAX package's and a
    float32 speaker vector within ATOL of it."""
    jm, tm = synthetic
    seen = []
    real = tcodec.encode_waveform
    monkeypatch.setattr(tcodec, "encode_waveform",
                        lambda p, c, w: seen.append(w.shape) or real(p, c, w))
    clip = _clip(n_seconds)
    codes, spk = tm.encode_reference(clip)
    assert seen == [(1, bucket * tm.cfg.codec.hop)]
    assert codes.shape == (tm.cfg.codec.num_codebooks, frames)
    assert codes.dtype == np.int32 and spk.dtype == np.float32
    j_codes, j_spk = jm.encode_reference(clip)
    np.testing.assert_array_equal(codes, np.asarray(j_codes))
    np.testing.assert_allclose(spk, np.asarray(j_spk, np.float32), atol=ATOL)


# -- imported Mimi snapshots ---------------------------------------------------

def _widen(jm, tm):
    """Both models at float32 (every bf16 leaf widened, exact)."""
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
    jm.sampling, tm.sampling = JaxSampling(greedy=True), SamplingConfig(greedy=True)


@pytest.fixture(scope="module")
def mimi_snapshot(tmp_path_factory):
    """A tiny published-layout snapshot (residual_sum + code2wav) carrying
    the scaled-down Mimi speech tokenizer, float32 tables."""
    cfg = tcfgs.with_quant(tcfgs.with_code2wav(
        tcfgs.tiny_feedback(), tcfgs.tiny_code2wav().code2wav), True)
    path = str(tmp_path_factory.mktemp("mimi_snapshot"))
    write_published_snapshot(path, cfg, seed=9, fast=False,
                             speech_tokenizer=True)
    return path


def _load_both(path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a Mimi layout maps: nothing to warn
        tm = tapi.load_model(path, device="cpu", mode="base", cache=False)
    jm = japi.load_model(path, mode="base", cache=False)
    return jm, tm


def test_imported_speech_tokenizer_equals_the_jax_importers(mimi_snapshot):
    jm, tm = _load_both(mimi_snapshot)
    for m in (jm, tm):
        rep = m.import_report.speech_tokenizer
        assert rep["family"] == "mimi" and not rep["preserved"]
        assert rep["mapped"] == rep["tensors"] > 0
        assert m.cfg.mode == "base" and m.st_raw is None
    assert tm.import_report.speech_tokenizer == jm.import_report.speech_tokenizer
    assert tm.import_report.assigned == jm.import_report.assigned
    assert dataclasses.asdict(tm.st_cfg) == dataclasses.asdict(jm.st_cfg)
    assert_trees_equal(tm.st_params, jm.st_params)


def _odd_speech_tokenizer(cfg) -> dict:
    rng = np.random.default_rng(5)
    return {"speech_tokenizer.encoder.layers.0.weight":
            rng.normal(0, 0.05, (8, 8)).astype(np.float32),
            "speech_tokenizer.quantizer.codebook":
            rng.normal(0, 0.05, (16, 8)).astype(np.float32)}, {}


def _other_code_space(cfg) -> dict:
    from qwen3_tts_tpu_torch.engine.fabricate import speech_tokenizer_tensors

    st = TST.SpeechTokenizerConfig(
        num_filters=4, hidden=32, n_layers=1, n_heads=2, n_kv_heads=2,
        head_dim=16, ffn=64, codebook_size=32, codebook_dim=8,
        num_quantizers=3)
    tensors, section = speech_tokenizer_tensors(cfg, st=st)
    return tensors, {"speech_tokenizer_config": section}


@pytest.mark.parametrize("extra,family", [(_odd_speech_tokenizer, "unknown"),
                                          (_other_code_space, "mimi")],
                         ids=["unknown_layout", "other_code_space"])
def test_unmappable_speech_tokenizers_are_preserved_and_reported(
        extra, family, temp_dir):
    """An unknown layout, or a Mimi whose code space is not the codec's,
    is kept verbatim (st_raw, the native cache's
    speech_tokenizer_raw.safetensors) and reported as the JAX importer
    reports it, with a warning; cloning then takes the codec encoder."""
    from qwen3_tts_tpu_torch.engine.fabricate import write_mlx_style_checkpoint

    cfg = tcfgs.tiny(quant=True)
    tensors, config_extra = extra(cfg)
    snap = os.path.join(temp_dir, "snap")
    write_mlx_style_checkpoint(snap, cfg, full=True, extra_tensors=tensors,
                               config_extra=config_extra)
    with pytest.warns(UserWarning, match="speech_tokenizer"):
        tm = tweights.import_hf_checkpoint(snap)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = jweights.import_hf_checkpoint(snap)
    rep = tm.import_report.speech_tokenizer
    assert rep == jm.import_report.speech_tokenizer
    assert rep["family"] == family and rep["preserved"] and rep["mapped"] == 0
    assert tm.st_params is None and tm.st_cfg is None
    assert sorted(tm.st_raw) == sorted(jm.st_raw) == sorted(
        k.split(".", 1)[1] for k in tensors)
    tweights.save_model(tm, os.path.join(temp_dir, "native"))
    again = tweights.load_native(os.path.join(temp_dir, "native"))
    assert_trees_equal(again.st_raw, tm.st_raw)
    codes, spk = tm.encode_reference(_clip())
    assert codes.shape == (cfg.codec.num_codebooks, 12) and spk is not None


def test_native_round_trips_across_packages(mimi_snapshot, temp_dir):
    """The port's native cache loads in the JAX package and the JAX
    package's in the port, speech tokenizer tree and config included."""
    jm, tm = _load_both(mimi_snapshot)
    tdir, jdir = os.path.join(temp_dir, "port"), os.path.join(temp_dir, "jax")
    tweights.save_model(tm, tdir)
    jweights.save_model(jm, jdir)
    from_port = jweights.load_native(tdir)
    from_jax = tweights.load_native(jdir)
    for got, want in ((from_port, tm), (from_jax, jm), (from_jax, from_port)):
        assert dataclasses.asdict(got.st_cfg) == dataclasses.asdict(want.st_cfg)
        assert_trees_equal(got.st_params, want.st_params)
    assert isinstance(from_jax.st_cfg, TST.SpeechTokenizerConfig)


def _write_ref(path: str) -> str:
    write_wav(path, _clip(), 24000)
    return path


def _clone_codes(pkg, model, ref: str, max_frames: int = 12):
    """Greedy codes of the prompt generate_audio builds for a clone."""
    prompts, _ = pkg.prepare_segments(model, TEXT, ref_audio=ref,
                                      ref_text=REF_TEXT)
    assert len(prompts) == 1 and prompts[0].acoustic_codes is not None
    res = model.generator.synthesize(prompts[0], max_frames=max_frames,
                                     collect_codes=True)
    return prompts[0], res


@pytest.mark.parametrize("which", ["synthetic:tiny:base", "mimi_snapshot"])
def test_float32_clone_greedy_codes_equal_jax(which, synthetic, mimi_snapshot,
                                              temp_dir):
    """generate_audio(ref_audio=..., ref_text=...)'s prompt (reference codes,
    speaker vector, transcript) and its greedy float32 codes equal the JAX
    package's; the WAV is written."""
    if which == "mimi_snapshot":
        jm, tm = _load_both(mimi_snapshot)
        _widen(jm, tm)
    else:
        jm, tm = synthetic
    ref = _write_ref(os.path.join(temp_dir, "ref.wav"))
    jp, jres = _clone_codes(japi, jm, ref)
    tp, tres = _clone_codes(tapi, tm, ref)
    np.testing.assert_array_equal(tp.acoustic_codes, np.asarray(jp.acoustic_codes))
    np.testing.assert_array_equal(tp.text_tokens, jp.text_tokens)
    assert (tp.speaker_vector is None) == (jp.speaker_vector is None) \
        == (which == "mimi_snapshot")
    if tp.speaker_vector is not None:
        np.testing.assert_allclose(tp.speaker_vector,
                                   np.asarray(jp.speaker_vector, np.float32),
                                   atol=ATOL)
    assert tres.frames == jres.frames > 4
    np.testing.assert_array_equal(tres.codes, jres.codes)
    m = tapi.generate_audio(model=tm, text=TEXT, ref_audio=ref,
                            ref_text=REF_TEXT, output_path=temp_dir,
                            max_frames=8)
    skip = tm.cfg.code2wav.startup_samples if tm.cfg.codec_arch == "code2wav" \
        else 0
    wav, sr = read_wav(os.path.join(temp_dir, "audio_000.wav"))
    assert sr == 24000 and len(wav) == m["frames"] * tm.cfg.codec.hop - skip > 0


def test_serving_engine_clones_like_single_stream_and_jax(synthetic, temp_dir):
    """Base-mode prompts (reference codes and speaker vector) go through
    ServingEngine.submit like any other: two clones and one preset voice,
    greedy, equal to single-stream synthesis and to the JAX engine; then a
    two-segment clone through generate_audio's serving default."""
    jm, tm = synthetic
    ref = _write_ref(os.path.join(temp_dir, "ref.wav"))
    texts = (TEXT, "Another line to clone.")
    tprompts = [tapi.prepare_segments(tm, t, ref_audio=ref,
                                      ref_text=REF_TEXT)[0][0] for t in texts]
    jprompts = [japi.prepare_segments(jm, t, ref_audio=ref,
                                      ref_text=REF_TEXT)[0][0] for t in texts]
    plain = PromptSpec(text_tokens=np.arange(5, 15, dtype=np.int32))
    budgets = [10, 7, 6]
    teng = ServingEngine(tm, max_streams=4, chunk=4,
                         sampling=SamplingConfig(greedy=True))
    jeng = JaxEngine(jm, max_streams=4, chunk=4,
                     sampling=JaxSampling(greedy=True))
    got = teng.run(tprompts + [plain], max_frames=budgets)
    ref_runs = jeng.run(jprompts + [JaxPrompt(text_tokens=plain.text_tokens)],
                        max_frames=budgets)
    for p, b, (_, st), (_, jst) in zip(tprompts + [plain], budgets, got,
                                       ref_runs):
        codes = np.concatenate(st.codes, axis=1)
        np.testing.assert_array_equal(codes, np.concatenate(jst.codes, axis=1))
        single = tm.generator.synthesize(p, max_frames=b, collect_codes=True)
        np.testing.assert_array_equal(codes, single.codes)
    m = tapi.generate_audio(model=tm, text="A long first sentence. " * 30
                            + "The second segment begins.", ref_audio=ref,
                            ref_text=REF_TEXT, output_path=temp_dir,
                            max_frames=4)
    assert m["segments"] == 2 and tm._serving is not None


@pytest.mark.parametrize("native", ["auto", "never"])
def test_reference_audio_is_mixed_down_and_resampled(temp_dir, monkeypatch,
                                                     native):
    """A stereo 16 kHz reference reads, mixes down and resamples to 24 kHz
    as the JAX package's does under the same QWEN3_TTS_NATIVE: the native
    windowed-sinc kernel by default, scipy under ``never``."""
    from qwen3_tts_tpu import native as jax_native
    from qwen3_tts_tpu.audio import resample as jax_resample

    monkeypatch.setenv("QWEN3_TTS_NATIVE", native)
    # the JAX package reads the knob once, at its library's first load
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_TRIED", False)
    left = _clip(0.5, 16000)
    stereo = np.stack([left, 0.5 * left], axis=1)
    path = os.path.join(temp_dir, "stereo.wav")
    write_wav(path, stereo, 16000)
    data, rate = read_wav(path)
    assert data.shape == (8000, 2) and rate == 16000
    mono = to_mono(data)
    np.testing.assert_allclose(mono, data.mean(axis=1), atol=0)
    got = resample(mono, 16000, 24000)
    want = jax_resample(mono, 16000, 24000)
    assert got.shape == (12000,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


BLOCKED = textwrap.dedent("""
    import os, sys, tempfile, warnings
    MISSING = ("jax", "jaxlib", "safetensors", "transformers", "ml_dtypes")

    class Missing:  # as absent as on the GPU machine (scipy probes jax)
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in MISSING:
                raise ImportError(f"no module named {name}")

    sys.meta_path.insert(0, Missing())
    sys.path.insert(0, os.path.join(sys.argv[1], "src"))
    import numpy as np
    from qwen3_tts_tpu_torch.audio import write_wav
    from qwen3_tts_tpu_torch.engine import configs, generate_audio, load_model
    from qwen3_tts_tpu_torch.engine.fabricate import write_published_snapshot

    tmp = tempfile.TemporaryDirectory()
    t = np.arange(16000) / 16000
    write_wav(os.path.join(tmp.name, "ref.wav"),
              np.stack([0.3 * np.sin(2 * np.pi * 140 * t)] * 2, axis=1), 16000)
    cfg = configs.with_quant(configs.with_code2wav(
        configs.tiny_feedback(), configs.tiny_code2wav().code2wav), True)
    snap = os.path.join(tmp.name, "snap")
    write_published_snapshot(snap, cfg, seed=1, fast=True,
                             speech_tokenizer=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        imported = load_model(snap, device="cpu", mode="base")
    for model in (load_model("synthetic:tiny:base", device="cpu"), imported,
                  load_model(snap, device="cpu", mode="base")):
        m = generate_audio(model=model, text="hi there",
                           ref_audio=os.path.join(tmp.name, "ref.wav"),
                           ref_text="a reference", output_path=tmp.name,
                           max_frames=6)
        assert m["frames"] > 0
    assert imported.st_params is not None
    assert not [n for n in MISSING if n in sys.modules]
    tmp.cleanup()
    print("OK")
""")


def test_port_clones_without_jax_safetensors_transformers_or_ml_dtypes():
    """Cloning from a synthetic model, an imported Mimi snapshot and its
    native cache, with a stereo 16 kHz reference, as on the GPU machine."""
    proc = subprocess.run([sys.executable, "-c", BLOCKED, str(ROOT)],
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
