"""The port's published decode protocol (feedback="residual_sum", one frame
per step) and its code2wav wiring against the JAX package, on tiny float32
trees: the predictor's feedback sum, the dual-stream prompt and trailing
buffer, and greedy synthesis end to end."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu.engine import configs as jcfgs
from qwen3_tts_tpu.models import code_predictor as jcp
from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.models.codec import init_codec
from qwen3_tts_tpu.models.code_predictor import init_code_predictor
from qwen3_tts_tpu.models.talker import init_talker
from qwen3_tts_tpu.runtime.generate import Generator as JaxGenerator
from qwen3_tts_tpu.runtime.prompts import PromptSpec as JaxPrompt
from qwen3_tts_tpu.runtime.sampling import SamplingConfig as JaxSampling
from qwen3_tts_tpu_torch.engine import configs as tcfgs
from qwen3_tts_tpu_torch.engine.weights import params_from_numpy, tree_to
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.runtime.generate import Generator, trailing_lookup
from qwen3_tts_tpu_torch.runtime.prompts import PromptSpec
from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig
from torch_port_helpers import tame_codec

ATOL = 1e-5  # float32 parity: same arithmetic, different summation order
PCM_LSB = 2  # int16 PCM tolerance: float32 summation order in the codec


def _f32(cfg, quant: bool):
    return dataclasses.replace(cfg, dtype="float32",
                               quant=dataclasses.replace(cfg.quant,
                                                         enabled=quant))


def _feedback_code2wav(mod):
    return mod.with_code2wav(mod.tiny_feedback(), mod.tiny_code2wav().code2wav)


# (name, the preset made from either package's configs module, int8)
CONFIGS = {
    "tiny_feedback": (lambda m: m.tiny_feedback(), True),
    "tiny_code2wav": (lambda m: m.tiny_code2wav(), False),
    "tiny_feedback_code2wav": (_feedback_code2wav, True),
}


def _generators(name: str, chunk_schedule=(4,)):
    """(JAX Generator, port Generator) on one numpy tree, greedy."""
    build, quant = CONFIGS[name]
    jc, tc = _f32(build(jcfgs), quant), _f32(build(tcfgs), quant)
    codec = init_codec(jc, 2)
    if jc.codec_arch == "rvq":
        codec = tame_codec(codec)
    trees = (init_talker(jc, 0), init_code_predictor(jc, 1), codec)
    jgen = JaxGenerator(cfg=jc, params=trees[0], cp_params=trees[1],
                        codec_params=trees[2],
                        sampling=JaxSampling(greedy=True),
                        chunk_schedule=chunk_schedule)
    params, cp_params, codec_params = params_from_numpy(*trees, device="cpu")
    tgen = Generator(cfg=tc, params=params, cp_params=cp_params,
                     codec_params=codec_params,
                     sampling=SamplingConfig(greedy=True),
                     chunk_schedule=chunk_schedule)
    return jgen, tgen


def test_residual_feedback_sum_and_return_feedback_match_jax():
    jc = _f32(jcfgs.tiny_feedback(), True)
    tc = _f32(tcfgs.tiny_feedback(), True)
    cp_np = init_code_predictor(jc, 1)
    _, cp, _ = params_from_numpy({}, cp_np, {}, device="cpu")
    rng = np.random.default_rng(3)
    B = 6
    hidden = rng.normal(0, 1.0, (B, jc.talker.hidden)).astype(np.float32)
    cb0 = rng.integers(0, jc.codec.codebook_size, B)
    ref_codes, ref_sum = jcp.predict_residuals(
        cp_np, jc, jnp.asarray(hidden), jnp.asarray(cb0, jnp.int32),
        return_feedback=True)
    codes, fb = tcp.predict_residuals(cp, tc, torch.from_numpy(hidden),
                                      torch.from_numpy(cb0),
                                      return_feedback=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    np.testing.assert_allclose(fb.numpy(), np.asarray(ref_sum), atol=ATOL)
    table = cp_np["res_emb"]
    want = sum(table[d][np.asarray(ref_codes)[:, d]]
               for d in range(table.shape[0]))
    np.testing.assert_allclose(
        tcp.residual_feedback_sum(cp, codes).numpy(), want, atol=ATOL)


def test_text_projection_and_merge_step_embs_match_jax():
    """A checkpoint's text-projection MLP (biased fc1 -> silu -> biased
    fc2), identity without one; one frame a step passes its embedding."""
    rng = np.random.default_rng(5)
    tp = {f"fc{i}": {"w": rng.normal(0, 0.2, shape).astype(np.float32),
                     "b": rng.normal(0, 0.1, shape[:1]).astype(np.float32)}
          for i, shape in ((1, (24, 16)), (2, (32, 24)))}
    x = rng.normal(0, 1.0, (5, 16)).astype(np.float32)
    want = np.asarray(jtalker.text_projection({"text_proj": tp},
                                              jnp.asarray(x)))
    got = ttalker.text_projection({"text_proj": tree_to(tp, "cpu")},
                                  torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (5, 32)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(
        ttalker.text_projection({}, torch.from_numpy(x)).numpy(), x)
    t = tcfgs.tiny_feedback().talker
    embs = rng.normal(0, 1.0, (3, 1, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        ttalker.merge_step_embs({}, t, torch.from_numpy(embs)).numpy(),
        np.asarray(jtalker.merge_step_embs({}, jcfgs.tiny_feedback().talker,
                                           jnp.asarray(embs))))


def _prompts(cfg):
    Tb = cfg.talker.trailing_bucket
    Q = cfg.codec.num_codebooks

    def toks(n):
        return (np.arange(n, dtype=np.int32) * 7 + 5) % 200

    acoustic = np.random.default_rng(4).integers(
        0, cfg.codec.residual_codebook_size, (Q, 5)).astype(np.int32)
    return {
        "no_speaker": dict(text_tokens=toks(10)),
        "speaker_row": dict(text_tokens=toks(8), speaker_id=1),
        "speaker_token": dict(text_tokens=toks(9), speaker_token=3),
        "two_tokens": dict(text_tokens=toks(2), speaker_id=0),
        "text_cut": dict(text_tokens=toks(Tb + 6), speaker_id=2),
        "fits_bucket": dict(text_tokens=toks(Tb + 2), speaker_id=2),
        "acoustic": dict(text_tokens=toks(8), speaker_id=1,
                         acoustic_codes=acoustic),
    }


def test_published_prompt_and_trailing_buffer_match_jax():
    """The dual-stream prompt rows and the trailing buffer, including a text
    longer than the buffer (cut, no tts_eos row, last row tts_pad) and one
    that just fits (tts_eos then tts_pad)."""
    jgen, tgen = _generators("tiny_feedback")
    t = tgen.cfg.talker
    text_emb = tgen.params["text_emb"].numpy()
    for name, kw in _prompts(tgen.cfg).items():
        jemb, jpad, jtrail = jgen.assemble_prompt_full(JaxPrompt(**kw))
        emb, pad, trail = tgen.assemble_prompt_full(PromptSpec(**kw))
        assert pad == jpad, name
        np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(trail.numpy(), np.asarray(jtrail),
                                   atol=ATOL, err_msg=name)
        rows = trail[0].numpy()
        np.testing.assert_array_equal(rows[-1], text_emb[t.tts_pad_id])
        has_eos = any(np.array_equal(r, text_emb[t.tts_eos_id]) for r in rows)
        assert has_eos == (name != "text_cut"), name
        # past the buffer, the lookup repeats its last row: tts_pad
        np.testing.assert_array_equal(
            trailing_lookup(trail, 10 * t.trailing_bucket)[0].numpy(),
            text_emb[t.tts_pad_id])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_synthesis_matches_jax_generator(name):
    """Same tree, same prompt, greedy float32: identical codec codes across
    several chunks and int16 PCM within 2 LSB, the code2wav startup samples
    dropped in both."""
    jgen, tgen = _generators(name)
    cfg = tgen.cfg
    kw = dict(text_tokens=(np.arange(14, dtype=np.int32) * 11 + 3) % 200,
              speaker_id=1)
    ref = jgen.synthesize(JaxPrompt(**kw), max_frames=12, collect_codes=True)
    got = tgen.synthesize(PromptSpec(**kw), max_frames=12, collect_codes=True)
    assert got.frames == ref.frames > 4
    np.testing.assert_array_equal(got.codes, ref.codes)
    skip = cfg.code2wav.startup_samples if cfg.codec_arch == "code2wav" else 0
    assert got.wav.dtype == np.int16
    assert got.wav.shape == ref.wav.shape == (got.frames * cfg.codec.hop - skip,)
    diff = np.abs(got.wav.astype(np.int32) - ref.wav.astype(np.int32))
    assert diff.max() <= PCM_LSB
    assert np.abs(ref.wav).max() > 50  # a live waveform, not silence
