"""The port's int8 KV cache (QWEN3_TTS_KV=int8, ``models/layers.py``
``KVQuant``) against the JAX package's: the format knob, cache allocation,
the quantizer, the scale-factored attention read, window splits, and
greedy float32 synthesis and serving (a mid-flight join included) equal
to the JAX package's int8 runs.

The in-scope cases of ``tests/test_kv_int8.py``. Its MTP case
(frames_per_step=2) waits for ROADMAP item 9's second half, its
tensor-parallel case for item 15, and its quality-gate harness
(``tools/kv_quality_check.py``, an ASR provider) for item 13."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.engine import configs as jcfgs
from qwen3_tts_tpu.engine.api import Qwen3TTSModel as JaxModel
from qwen3_tts_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from qwen3_tts_tpu.models import layers as jlayers
from qwen3_tts_tpu.models.code_predictor import init_code_predictor
from qwen3_tts_tpu.models.codec import init_codec
from qwen3_tts_tpu.models.talker import init_talker
from qwen3_tts_tpu.runtime.generate import Generator as JaxGenerator
from qwen3_tts_tpu.runtime.prompts import PromptSpec as JaxPrompt
from qwen3_tts_tpu.runtime.sampling import SamplingConfig as JaxSampling
from qwen3_tts_tpu.runtime.serving import ServingEngine as JaxEngine
from qwen3_tts_tpu_torch.engine import configs as tcfgs
from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
from qwen3_tts_tpu_torch.engine.tokenizer import ByteTokenizer
from qwen3_tts_tpu_torch.engine.weights import params_from_numpy, tree_to
from qwen3_tts_tpu_torch.models import layers as tlayers
from qwen3_tts_tpu_torch.models.layers import (
    KVQuant, kv_cache_init, kv_dequantize, kv_env_format, kv_quantize,
)
from qwen3_tts_tpu_torch.runtime.generate import Generator
from qwen3_tts_tpu_torch.runtime.prompts import PromptSpec
from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig
from qwen3_tts_tpu_torch.runtime.serving import ServingEngine
from torch_port_helpers import tame_codec, tiny_f32

# float32 attention parity with the JAX package's int8 read: the same int8
# codes and f32 scales, products summed in another order
ATOL = 1e-5


# ---------------------------------------------------------------- unit ----

def test_kv_env_format_parses_and_rejects(monkeypatch):
    for v, want in [("", "dense"), ("0", "dense"), ("dense", "dense"),
                    ("bf16", "dense"), ("int8", "int8"), ("INT8", "int8")]:
        monkeypatch.setenv("QWEN3_TTS_KV", v)
        assert kv_env_format() == want == jlayers.kv_env_format(), v
    monkeypatch.setenv("QWEN3_TTS_KV", "fp8")
    with pytest.raises(ValueError, match="QWEN3_TTS_KV"):
        kv_env_format()


def test_kv_cache_init_formats(monkeypatch):
    shape = (2, 1, 8, 2, 4)
    dense = kv_cache_init(shape, torch.bfloat16, kv_format="dense")
    assert dense.shape == shape and dense.dtype == torch.bfloat16

    q = kv_cache_init(shape, torch.bfloat16, kv_format="int8")
    ref = jlayers.kv_cache_init(shape, jnp.bfloat16, kv_format="int8")
    assert isinstance(q, KVQuant)
    assert q.q.shape == ref.q.shape == shape and q.q.dtype == torch.int8
    assert q.s.shape == ref.s.shape == (*shape[:-1], 1)
    assert q.s.dtype == torch.float32
    assert (q.shape, q.dtype, q.device) == (shape, torch.int8,
                                            torch.device("cpu"))
    # zero scales: an unwritten int8 cache dequantizes to exact zeros
    np.testing.assert_array_equal(kv_dequantize(q, torch.float32).numpy(),
                                  np.zeros(shape))

    monkeypatch.setenv("QWEN3_TTS_KV", "int8")
    assert isinstance(kv_cache_init(shape, torch.bfloat16), KVQuant)
    monkeypatch.delenv("QWEN3_TTS_KV")
    assert not isinstance(kv_cache_init(shape, torch.bfloat16), KVQuant)


def test_kvquant_views_and_assignment_reach_both_leaves():
    """Indexing gives views of codes and scales (writes through them land
    in the cache, as the chunk builders' [:, :, :A] views need), and
    assigning a KVQuant to an index sets both leaves (the serving slot
    scatter)."""
    cache = kv_cache_init((2, 3, 8, 2, 4), torch.float32, kv_format="int8")
    view = cache[:, :, :5]
    assert isinstance(view, KVQuant) and view.shape == (2, 3, 5, 2, 4)
    view.q[1, 2, 4] = 7
    view.s[1, 2, 4] = 0.5
    assert cache.q[1, 2, 4].eq(7).all() and cache.s[1, 2, 4].eq(0.5).all()
    new = kv_quantize(torch.randn(2, 2, 3, 2, 4))
    cache[:, torch.tensor([0, 2]), :3] = new
    torch.testing.assert_close(cache.q[:, [0, 2], :3], new.q, rtol=0, atol=0)
    torch.testing.assert_close(cache.s[:, [0, 2], :3], new.s, rtol=0, atol=0)


def test_kv_quantize_matches_jax_with_its_error_bound_and_exact_rows():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 2, 16)).astype(np.float32)
    c = kv_quantize(torch.from_numpy(x))
    ref = jlayers.kv_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(c.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(c.s.numpy(), np.asarray(ref.s))
    back = kv_dequantize(c, torch.float32).numpy()
    # symmetric rounding error <= scale/2 per element
    assert (np.abs(back - x) <= np.broadcast_to(c.s.numpy() / 2, x.shape)
            + 1e-7).all()
    # rows on the int8 grid with amax 127 (scale exactly 1) round-trip
    grid = rng.integers(-127, 128, size=(2, 5, 1, 8)).astype(np.float32)
    grid[..., 0] = 127.0
    c2 = kv_quantize(torch.from_numpy(grid))
    np.testing.assert_array_equal(kv_dequantize(c2, torch.float32).numpy(),
                                  grid)
    # all-zero rows (unwritten cache slots) stay exactly zero
    assert not kv_quantize(torch.zeros(1, 4, 1, 8)).q.any()


# ----------------------------------------------------- attention parity ----

def _attn_setup(seed=0, B=2, T=4, S=32, D=32, H=4, HKV=2, hd=8):
    rng = np.random.default_rng(seed)

    def lin(o, i):
        return {"w": rng.normal(0, 0.05, (o, i)).astype(np.float32)}

    p = {"q": lin(H * hd, D), "k": lin(HKV * hd, D), "v": lin(HKV * hd, D),
         "o": lin(D, H * hd), "q_norm": np.ones(hd, np.float32),
         "k_norm": np.ones(hd, np.float32)}
    x = rng.normal(0, 1, (B, T, D)).astype(np.float32)
    kw = dict(pos=0, n_heads=H, n_kv_heads=HKV, head_dim=hd, rms_eps=1e-6)
    return p, x, (B, S, HKV, hd), kw, T


def _port_attention(p, x, cshape, kw, T, kv_format, **extra):
    cos, sin = tlayers.rope_tables(cshape[1], cshape[-1], 10000.0)
    ck = kv_cache_init(cshape, torch.float32, kv_format=kv_format)
    cv = kv_cache_init(cshape, torch.float32, kv_format=kv_format)
    out = tlayers.attention(tree_to(p, "cpu"), torch.from_numpy(x),
                            cos=cos[:T], sin=sin[:T], cache_k=ck, cache_v=cv,
                            **kw, **extra)
    return out


def test_attention_int8_equals_jax_int8_and_is_close_to_dense():
    """The port's int8 attention (quantize on write, scale-factored read)
    against the JAX package's int8 attention on the same inputs: output
    within ATOL, cache codes equal and scales within 1e-6 relative (the
    projected keys already differ by float32 ulps); and within 0.02 of the
    dense read, as the JAX package's own test bounds it."""
    p, x, cshape, kw, T = _attn_setup()
    got = _port_attention(p, x, cshape, kw, T, "int8")
    assert isinstance(got.cache_k, KVQuant)
    jcos, jsin = jlayers.rope_tables(cshape[1], cshape[-1], 10000.0)
    ref = jlayers.attention(
        p, jnp.asarray(x), cos=jcos[:T], sin=jsin[:T],
        cache_k=jlayers.kv_cache_init(cshape, jnp.float32, kv_format="int8"),
        cache_v=jlayers.kv_cache_init(cshape, jnp.float32, kv_format="int8"),
        **kw)
    np.testing.assert_allclose(got.out.numpy(), np.asarray(ref.out), atol=ATOL)
    for mine, theirs in ((got.cache_k, ref.cache_k), (got.cache_v, ref.cache_v)):
        np.testing.assert_array_equal(mine.q.numpy(), np.asarray(theirs.q))
        np.testing.assert_allclose(mine.s.numpy(), np.asarray(theirs.s),
                                   rtol=1e-6, atol=0)
    dense = _port_attention(p, x, cshape, kw, T, "dense")
    np.testing.assert_allclose(got.out.numpy(), dense.out.numpy(), atol=0.02,
                               rtol=0.02)
    # the int8 cache holds the quantization of the dense cache's rows
    np.testing.assert_array_equal(got.cache_k.q[:, :T].numpy(),
                                  kv_quantize(dense.cache_k[:, :T]).q.numpy())


def test_attention_int8_window_split_matches_full_window():
    """Per-group windows slice codes and scales together: windows that
    cover every written row equal the unsplit read exactly."""
    p, x, cshape, kw, T = _attn_setup(B=2, T=4, S=32)
    full = _port_attention(p, x, cshape, kw, T, "int8")
    split = _port_attention(p, x, cshape, kw, T, "int8",
                            window_split=((1, 16), (1, 32)))
    np.testing.assert_array_equal(full.out.numpy(), split.out.numpy())


# ----------------------------------------------------------- end-to-end ----

GREEDY_J, GREEDY_T = JaxSampling(greedy=True), SamplingConfig(greedy=True)

# (preset from either package's configs module); rvq's decoder is tamed
CONFIGS = {
    "rvq": lambda m: m.tiny(quant=True),
    "residual_sum_code2wav": lambda m: m.with_quant(m.with_code2wav(
        m.tiny_feedback(), m.tiny_code2wav().code2wav), True),
}


def _trees(jc):
    codec = init_codec(jc, 2)
    if jc.codec_arch == "rvq":
        codec = tame_codec(codec)
    return init_talker(jc, 0), init_code_predictor(jc, 1), codec


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    """(name, JAX model, port model) at float32 on one numpy tree."""
    build = CONFIGS[request.param]
    jc = dataclasses.replace(build(jcfgs), dtype="float32")
    tc = dataclasses.replace(build(tcfgs), dtype="float32")
    trees = _trees(jc)
    jmodel = JaxModel(cfg=jc, params=trees[0], cp_params=trees[1],
                      codec_params=trees[2], tokenizer=JaxByteTokenizer(),
                      sampling=GREEDY_J)
    params, cp_params, codec_params = params_from_numpy(*trees, device="cpu")
    tmodel = Qwen3TTSModel(cfg=tc, params=params, cp_params=cp_params,
                           codec_params=codec_params, tokenizer=ByteTokenizer(),
                           device=torch.device("cpu"), sampling=GREEDY_T)
    return request.param, jmodel, tmodel


def _prompt_kw(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return dict(text_tokens=rng.integers(0, 200, size=6 + seed).astype(np.int32),
                speaker_id=int(seed % 4))


@pytest.mark.parametrize("layout", ["grouped", "rowmajor"])
def test_int8_generator_greedy_codes_equal_jax(layout, monkeypatch):
    """Greedy float32 synthesis from an int8 KV cache, three chunks: the
    port's codes equal the JAX Generator's int8 codes."""
    monkeypatch.setenv("QWEN3_TTS_KV", "int8")
    monkeypatch.setenv("QWEN3_TTS_INT8_LAYOUT", layout)
    jc, tc = tiny_f32(jcfgs), tiny_f32(tcfgs)
    trees = _trees(jc)
    jgen = JaxGenerator(cfg=jc, params=trees[0], cp_params=trees[1],
                        codec_params=trees[2], sampling=GREEDY_J,
                        chunk_schedule=(4,))
    tgen = Generator(cfg=tc, **dict(zip(
        ("params", "cp_params", "codec_params"),
        params_from_numpy(*trees, device="cpu"))),
        sampling=GREEDY_T, chunk_schedule=(4,))
    assert isinstance(tgen._alloc_cache()[0], KVQuant)
    ref = jgen.synthesize(JaxPrompt(**_prompt_kw(1)), max_frames=12,
                          collect_codes=True)
    got = tgen.synthesize(PromptSpec(**_prompt_kw(1)), max_frames=12,
                          collect_codes=True)
    assert got.frames == ref.frames > 4
    np.testing.assert_array_equal(got.codes, ref.codes)


def test_int8_serving_equals_int8_single_stream_and_jax_engine(models,
                                                               monkeypatch):
    """Three prompts (one cold batch) through the int8 serving engine, and
    a fourth joining mid-flight: each stream's greedy codes equal int8
    single-stream synthesis and the JAX int8 engine's."""
    name, jmodel, tmodel = models
    monkeypatch.setenv("QWEN3_TTS_KV", "int8")
    budgets, seeds = [4, 10, 7, 6], (1, 2, 3, 4)

    def serve(engine, prompt_cls):
        ids = [engine.submit(prompt_cls(**_prompt_kw(s)), max_frames=b)
               for s, b in zip(seeds[:3], budgets[:3])]
        engine.step()
        engine.step()
        ids.append(engine.submit(prompt_cls(**_prompt_kw(seeds[3])),
                                 max_frames=budgets[3]))
        for _ in range(100):
            if all(engine.streams[i].done for i in ids):
                break
            engine.step()
        return [np.concatenate(engine.collect(i)[1].codes, axis=1)
                for i in ids]

    teng = ServingEngine(tmodel, max_streams=4, chunk=4, sampling=GREEDY_T)
    assert isinstance(teng.cache_k, KVQuant)
    jeng = JaxEngine(jmodel, max_streams=4, chunk=4, sampling=GREEDY_J)
    assert isinstance(jeng.cache_k, jlayers.KVQuant)
    got, ref = serve(teng, PromptSpec), serve(jeng, JaxPrompt)
    tmodel._generator = None  # a generator of the int8 format
    single = [tmodel.generator.synthesize(PromptSpec(**_prompt_kw(s)),
                                          max_frames=b, collect_codes=True).codes
              for s, b in zip(seeds, budgets)]
    for g, r, s in zip(got, ref, single):
        assert g.shape[1] > 0, name
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, s)
