"""The port's serving engine against the JAX package's, on tiny float32
trees: per-row attention (vector positions, per-group windows, clamped
cache writes), ServingEngine.run under the cb0/rvq, code2wav and
residual_sum + code2wav configurations, and multi-segment generate_audio
on both packages' serving default."""

import dataclasses
import os
import wave

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu.engine import configs as jcfgs
from qwen3_tts_tpu.engine.api import Qwen3TTSModel as JaxModel
from qwen3_tts_tpu.engine.api import generate_audio as jax_generate_audio
from qwen3_tts_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from qwen3_tts_tpu.models import layers as jlayers
from qwen3_tts_tpu.models.code_predictor import init_code_predictor
from qwen3_tts_tpu.models.codec import init_codec
from qwen3_tts_tpu.models.talker import init_talker
from qwen3_tts_tpu.runtime.prompts import PromptSpec as JaxPrompt
from qwen3_tts_tpu.runtime.sampling import SamplingConfig as JaxSampling
from qwen3_tts_tpu.runtime.serving import ServingEngine as JaxEngine
from qwen3_tts_tpu_torch.engine import configs as tcfgs
from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
from qwen3_tts_tpu_torch.engine.api import generate_audio
from qwen3_tts_tpu_torch.engine.tokenizer import ByteTokenizer
from qwen3_tts_tpu_torch.engine.weights import params_from_numpy, tree_to
from qwen3_tts_tpu_torch.models import layers as tlayers
from qwen3_tts_tpu_torch.runtime.prompts import PromptSpec
from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig
from qwen3_tts_tpu_torch.runtime.serving import ServingEngine
from torch_port_helpers import tame_codec

ATOL = 1e-5  # float32 parity: same arithmetic, different summation order
PCM_LSB = 2  # int16 PCM tolerance: float32 summation order in the codec
BUDGETS = [4, 10, 7]


def _f32(cfg, quant: bool):
    return dataclasses.replace(cfg, dtype="float32",
                               quant=dataclasses.replace(cfg.quant,
                                                         enabled=quant))


# (preset from either package's configs module, int8 weights)
CONFIGS = {
    "rvq": (lambda m: m.tiny(), True),
    "code2wav": (lambda m: m.tiny_code2wav(), False),
    "residual_sum_code2wav": (
        lambda m: m.with_code2wav(m.tiny_feedback(), m.tiny_code2wav().code2wav),
        True),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    """(JAX model, port model) on one numpy tree (seeds 0, 1, 2; the rvq
    decoder's convs tamed as in the other port tests), greedy."""
    build, quant = CONFIGS[request.param]
    jc, tc = _f32(build(jcfgs), quant), _f32(build(tcfgs), quant)
    codec = init_codec(jc, 2)
    if jc.codec_arch == "rvq":
        codec = tame_codec(codec)
    trees = (init_talker(jc, 0), init_code_predictor(jc, 1), codec)
    jmodel = JaxModel(cfg=jc, params=trees[0], cp_params=trees[1],
                      codec_params=trees[2],
                      tokenizer=JaxByteTokenizer(),
                      sampling=JaxSampling(greedy=True))
    params, cp_params, codec_params = params_from_numpy(*trees, device="cpu")
    tmodel = Qwen3TTSModel(cfg=tc, params=params, cp_params=cp_params,
                           codec_params=codec_params,
                           tokenizer=ByteTokenizer(),
                           device=torch.device("cpu"),
                           sampling=SamplingConfig(greedy=True))
    return request.param, jmodel, tmodel


def _prompt_kw(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return dict(text_tokens=rng.integers(0, 200, size=6 + seed).astype(np.int32),
                speaker_id=int(seed % 4))


@pytest.mark.parametrize("T", [1, 3])
def test_vector_position_attention_with_windows_matches_jax(T):
    """Per-row positions and pads, two row groups with their own windows,
    and a stale position past the cache (row 2) whose write clamps to the
    cache's last rows and whose RoPE rows clamp to the table's last row:
    the output and every cache row equal the JAX package's."""
    rng = np.random.default_rng(7)
    B, S, D, H, H_kv, hd = 4, 32, 24, 4, 2, 8

    def w(o, i):
        return {"w": rng.normal(0, 0.2, (o, i)).astype(np.float32)}

    p = {"q": w(H * hd, D), "k": w(H_kv * hd, D), "v": w(H_kv * hd, D),
         "o": w(D, H * hd),
         "q_norm": rng.normal(1, 0.1, hd).astype(np.float32),
         "k_norm": rng.normal(1, 0.1, hd).astype(np.float32)}
    x = rng.normal(0, 1, (B, T, D)).astype(np.float32)
    ck = rng.normal(0, 1, (B, S, H_kv, hd)).astype(np.float32)
    cv = rng.normal(0, 1, (B, S, H_kv, hd)).astype(np.float32)
    pos = np.array([5, 17, 60, 9], np.int32)
    pad = np.array([0, 3, 0, 2], np.int32)
    split = ((2, 24), (2, S))
    kw = dict(n_heads=H, n_kv_heads=H_kv, head_dim=hd, rms_eps=1e-6,
              window_split=split)

    jcos, jsin = jlayers.rope_tables(48, hd, 10_000.0)
    jc, js = jlayers.rope_slice(jcos, jsin, jnp.asarray(pos), T)
    ref = jlayers.attention(p, jnp.asarray(x), cos=jc, sin=js,
                            cache_k=jnp.asarray(ck), cache_v=jnp.asarray(cv),
                            pos=jnp.asarray(pos), pad_len=jnp.asarray(pad), **kw)

    tcos, tsin = tlayers.rope_tables(48, hd, 10_000.0)
    pos_t = torch.from_numpy(pos).long()
    tc, ts = tlayers.rope_slice(tcos, tsin, pos_t, T)
    assert tc.shape == (B, T, hd // 2)
    got_k, got_v = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = tlayers.attention(tree_to(p, "cpu"), torch.from_numpy(x), cos=tc,
                            sin=ts, cache_k=got_k, cache_v=got_v, pos=pos_t,
                            pad_len=torch.from_numpy(pad).long(), **kw)
    np.testing.assert_allclose(got.out.numpy(), np.asarray(ref.out), atol=ATOL)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(ref.cache_k), atol=ATOL)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref.cache_v), atol=ATOL)
    # the stale row rewrote its own last rows, nothing else of its cache
    changed = np.abs(got_k.numpy()[2] - ck[2]).max(axis=(1, 2)) > 0
    assert changed[S - T:].all() and not changed[:S - T].any()


def test_serving_run_matches_jax_serving_engine(models):
    """Three prompts (a cold start of three, batched) with budgets 4, 10
    and 7 through four slots, greedy: each stream's codes equal the JAX
    engine's, its PCM within 2 LSB."""
    name, jmodel, tmodel = models
    jeng = JaxEngine(jmodel, max_streams=4, chunk=4,
                     sampling=JaxSampling(greedy=True))
    teng = ServingEngine(tmodel, max_streams=4, chunk=4,
                         sampling=SamplingConfig(greedy=True))
    batched = []
    orig = teng._activate
    teng._activate = lambda group, *a: (batched.append(len(group)),
                                        orig(group, *a))
    seeds = (1, 2, 3)
    ref = jeng.run([JaxPrompt(**_prompt_kw(s)) for s in seeds],
                   max_frames=BUDGETS)
    got = teng.run([PromptSpec(**_prompt_kw(s)) for s in seeds],
                   max_frames=BUDGETS)
    assert batched == [3], batched  # one cold batch of the three prompts
    cfg = tmodel.cfg
    skip = cfg.code2wav.startup_samples if cfg.codec_arch == "code2wav" else 0
    for (rwav, rst), (wav, st) in zip(ref, got):
        assert st.frames == rst.frames > 0, name
        np.testing.assert_array_equal(np.concatenate(st.codes, axis=1),
                                      np.concatenate(rst.codes, axis=1))
        assert wav.dtype == np.int16
        assert wav.shape == rwav.shape == (st.frames * cfg.codec.hop - skip,)
        diff = np.abs(wav.astype(np.int32) - rwav.astype(np.int32))
        assert diff.max() <= PCM_LSB, name
    assert max(np.abs(w).max() for w, _ in ref) > 50  # live audio


def test_multisegment_generate_audio_matches_jax(temp_dir):
    """Two segments through generate_audio on each package's serving
    default (greedy, tiny rvq float32, one numpy tree): the WAVs agree
    within 2 LSB, gap included."""
    jc = _f32(jcfgs.tiny(), True)
    tc = _f32(tcfgs.tiny(), True)
    trees = (init_talker(jc, 0), init_code_predictor(jc, 1),
             tame_codec(init_codec(jc, 2)))
    jmodel = JaxModel(cfg=jc, params=trees[0], cp_params=trees[1],
                      codec_params=trees[2],
                      tokenizer=JaxByteTokenizer(),
                      sampling=JaxSampling(greedy=True))
    params, cp_params, codec_params = params_from_numpy(*trees, device="cpu")
    tmodel = Qwen3TTSModel(cfg=tc, params=params, cp_params=cp_params,
                           codec_params=codec_params,
                           tokenizer=ByteTokenizer(),
                           device=torch.device("cpu"),
                           sampling=SamplingConfig(greedy=True))
    text = "A long first sentence. " * 30 + "The second segment begins."
    wavs = {}
    for name, model, run in (("jax", jmodel, jax_generate_audio),
                             ("torch", tmodel, generate_audio)):
        out = os.path.join(temp_dir, name)
        m = run(model=model, text=text, voice="ryan", output_path=out,
                max_frames=6, seed=3)
        assert m["segments"] == 2
        with wave.open(os.path.join(out, "audio_000.wav"), "rb") as f:
            wavs[name] = np.frombuffer(f.readframes(f.getnframes()),
                                       dtype="<i2").astype(np.int32)
    assert tmodel._serving is not None  # the port took its serving path
    assert wavs["torch"].shape == wavs["jax"].shape
    assert np.abs(wavs["torch"] - wavs["jax"]).max() <= PCM_LSB
    assert np.abs(wavs["jax"]).max() > 1000
