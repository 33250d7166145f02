"""The port's multi-token prediction (frames_per_step > 1), batched-cp MTP
and speculative depth decode against the JAX package, on tiny float32
trees: the MTP heads' initialisers and forward functions, greedy codes of
the Generator under both decode protocols, the speculative depth decode
(exact greedy; sampled, in distribution), the serving engine at two frames
a step, and a JAX-written native directory that carries MTP heads."""

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
from qwen3_tts_tpu.engine.weights import save_model as jax_save_model
from qwen3_tts_tpu.models import code_predictor as jcp
from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.models.code_predictor import init_code_predictor
from qwen3_tts_tpu.models.codec import init_codec
from qwen3_tts_tpu.models.talker import init_talker
from qwen3_tts_tpu.runtime.generate import Generator as JaxGenerator
from qwen3_tts_tpu.runtime.prompts import PromptSpec as JaxPrompt
from qwen3_tts_tpu.runtime.sampling import SamplingConfig as JaxSampling
from qwen3_tts_tpu.runtime.serving import ServingEngine as JaxEngine
from qwen3_tts_tpu_torch.engine import configs as tcfgs
from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel, load_model
from qwen3_tts_tpu_torch.engine.api import generate_audio
from qwen3_tts_tpu_torch.engine.tokenizer import ByteTokenizer
from qwen3_tts_tpu_torch.engine.weights import params_from_numpy
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.runtime.generate import Generator
from qwen3_tts_tpu_torch.runtime.prompts import PromptSpec
from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig
from qwen3_tts_tpu_torch.runtime.serving import ServingEngine
from torch_port_helpers import assert_trees_equal, one_torch_thread, tame_codec

ATOL = 1e-5  # float32 parity: same arithmetic, different summation order
PCM_LSB = 2  # int16 PCM tolerance: float32 summation order in the codec
GREEDY = dict(greedy=True)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _f32(cfg, quant: bool = True):
    return dataclasses.replace(cfg, dtype="float32",
                               quant=dataclasses.replace(cfg.quant,
                                                         enabled=quant))


def _sixteen_codebooks(cfg, **cp_changes):
    """15 residual codebooks, so that depth groups of 5 divide them (the
    flagship's depth-group shape at tiny widths)."""
    return dataclasses.replace(
        cfg, codec=dataclasses.replace(cfg.codec, num_codebooks=16),
        code_predictor=dataclasses.replace(cfg.code_predictor, **cp_changes))


# (name, the preset made from either package's configs module)
CONFIGS = {
    "cb0_fps2": lambda m: m.with_frames_per_step(m.tiny(), 2),
    "cb0_fps3": lambda m: m.with_frames_per_step(m.tiny(), 3),
    "residual_sum_fps2": lambda m: m.tiny_feedback(frames_per_step=2),
    "residual_sum_fps2_cpb": lambda m: m.tiny_feedback(frames_per_step=2,
                                                       mtp_cp_batch=True),
    "residual_sum_dg5_spec": lambda m: _sixteen_codebooks(
        m.tiny_feedback(), depth_group=5, spec_decode=True),
}


def _trees(jc):
    codec = init_codec(jc, 2)
    if jc.codec_arch == "rvq":
        codec = tame_codec(codec)
    return init_talker(jc, 0), init_code_predictor(jc, 1), codec


def _models(name: str):
    """(JAX model, port model) on one numpy tree, greedy."""
    jc, tc = _f32(CONFIGS[name](jcfgs)), _f32(CONFIGS[name](tcfgs))
    trees = _trees(jc)
    jmodel = JaxModel(cfg=jc, params=trees[0], cp_params=trees[1],
                      codec_params=trees[2], tokenizer=JaxByteTokenizer(),
                      sampling=JaxSampling(**GREEDY))
    params, cp_params, codec_params = params_from_numpy(*trees, device="cpu")
    tmodel = Qwen3TTSModel(cfg=tc, params=params, cp_params=cp_params,
                           codec_params=codec_params, tokenizer=ByteTokenizer(),
                           device=torch.device("cpu"),
                           sampling=SamplingConfig(**GREEDY))
    return jmodel, tmodel


def _prompt_kw(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return dict(text_tokens=rng.integers(0, 200, size=6).astype(np.int32),
                speaker_id=int(seed % 4))


# -- the MTP heads -------------------------------------------------------------

@pytest.mark.parametrize("how", ["init_int8", "init_dense", "graft"])
def test_mtp_trees_are_bit_equal_to_jax(how):
    """A talker initialised at fps 2 (its heads quantized like the rest of
    the tree, or dense), and heads grafted with add_mtp_params (always
    dense, whatever cfg.quant says): the same leaves, bit for bit."""
    quant = how != "init_dense"
    jc = _f32(jcfgs.with_frames_per_step(jcfgs.tiny(), 2), quant)
    tc = _f32(tcfgs.with_frames_per_step(tcfgs.tiny(), 2), quant)
    if how == "graft":
        base = init_talker(_f32(jcfgs.tiny(), quant), 0)
        want = jtalker.add_mtp_params(base, jc, seed=5)
        tbase, _, _ = params_from_numpy(base, {}, {}, device="cpu")
        got = ttalker.add_mtp_params(tbase, tc, seed=5)
        assert "w" in got["mtp"]["merge"]  # dense heads on an int8 tree
        with pytest.raises(ValueError, match="already"):
            ttalker.add_mtp_params(got, tc)
        with pytest.raises(ValueError, match="frames_per_step"):
            ttalker.add_mtp_params(tbase, _f32(tcfgs.tiny(), quant))
    else:
        want = init_talker(jc, 0)
        got = ttalker.init_talker(tc, 0)
        assert ("q" in got["mtp"]["merge"]) == quant
    assert_trees_equal(got["mtp"], want["mtp"])
    assert_trees_equal(got, want)


@pytest.mark.parametrize("fps", [2, 3])
def test_mtp_heads_and_merge_match_jax(fps):
    """mtp_logits(_emb), mtp_hidden and merge_step_embs/tokens on the int8
    fps tree (the port's linears on the plain int8 version), within
    ATOL."""
    jc = _f32(jcfgs.with_frames_per_step(jcfgs.tiny(), fps))
    tc = _f32(tcfgs.with_frames_per_step(tcfgs.tiny(), fps))
    tree = init_talker(jc, 0)
    params, _, _ = params_from_numpy(tree, {}, {}, device="cpu")
    t, jt = tc.talker, jc.talker
    rng = np.random.default_rng(fps)
    B = 3
    h = rng.normal(0, 1.0, (B, t.hidden)).astype(np.float32)
    prev = rng.normal(0, 0.1, (B, t.hidden)).astype(np.float32)
    tok = rng.integers(0, t.codec_vocab, B)
    toks = rng.integers(0, t.codec_vocab, (B, fps))
    embs = rng.normal(0, 0.1, (B, fps, t.hidden)).astype(np.float32)

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    lg, nh = ttalker.mtp_logits(params, t, torch.from_numpy(h),
                                torch.from_numpy(tok))
    rlg, rnh = jtalker.mtp_logits(tree, jt, jnp.asarray(h),
                                  jnp.asarray(tok, jnp.int32))
    close(lg, rlg)
    close(nh, rnh)
    assert lg.dtype == torch.float32 and lg.shape == (B, t.codec_vocab)
    lg, nh = ttalker.mtp_logits_emb(params, t, torch.from_numpy(h),
                                    torch.from_numpy(prev))
    rlg, rnh = jtalker.mtp_logits_emb(tree, jt, jnp.asarray(h),
                                      jnp.asarray(prev))
    close(lg, rlg)
    close(nh, rnh)
    close(ttalker.mtp_hidden(params, t, torch.from_numpy(h),
                             torch.from_numpy(tok)),
          jtalker.mtp_hidden(tree, jt, jnp.asarray(h),
                             jnp.asarray(tok, jnp.int32)))
    close(ttalker.merge_step_embs(params, t, torch.from_numpy(embs)),
          jtalker.merge_step_embs(tree, jt, jnp.asarray(embs)))
    close(ttalker.merge_step_tokens(params, t, torch.from_numpy(toks)),
          jtalker.merge_step_tokens(tree, jt, jnp.asarray(toks, jnp.int32)))


# -- the Generator ---------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_codes_match_jax(name):
    """Greedy synthesis through each package's Generator: equal codes,
    PCM within 2 LSB, on a (4, 8) chunk schedule (aligned to fps)."""
    jmodel, tmodel = _models(name)
    sched = (4, 8)
    jgen = JaxGenerator(cfg=jmodel.cfg, params=jmodel.params,
                        cp_params=jmodel.cp_params,
                        codec_params=jmodel.codec_params,
                        sampling=JaxSampling(**GREEDY), chunk_schedule=sched)
    tgen = Generator(cfg=tmodel.cfg, params=tmodel.params,
                     cp_params=tmodel.cp_params,
                     codec_params=tmodel.codec_params,
                     sampling=SamplingConfig(**GREEDY), chunk_schedule=sched)
    assert tgen.chunk_schedule == jgen.chunk_schedule
    for seed in (1, 2):
        ref = jgen.synthesize(JaxPrompt(**_prompt_kw(seed)), max_frames=13,
                              collect_codes=True)
        got = tgen.synthesize(PromptSpec(**_prompt_kw(seed)), max_frames=13,
                              collect_codes=True)
        assert got.frames == ref.frames > 0
        np.testing.assert_array_equal(got.codes, ref.codes)
        assert got.wav.shape == ref.wav.shape
        diff = np.abs(got.wav.astype(np.int32) - ref.wav.astype(np.int32))
        assert diff.max() <= PCM_LSB, name


@pytest.mark.parametrize("text,segments", [
    ("Hello multi token.", 1),
    ("A long first sentence. " * 30 + "The second segment begins.", 2)],
    ids=["one_segment", "two_segments"])
def test_generate_audio_at_fps2_matches_jax(text, segments, temp_dir):
    """generate_audio end to end at two frames a step (residual_sum), one
    segment (the Generator) and two (each package's serving engine): the
    port's WAV equals the JAX package's within 2 LSB."""
    jmodel, tmodel = _models("residual_sum_fps2")
    wavs = {}
    for name, model, run in (("jax", jmodel, jax_generate_audio),
                             ("torch", tmodel, generate_audio)):
        out = os.path.join(temp_dir, name)
        m = run(model=model, text=text, voice="ryan", output_path=out,
                max_frames=12, seed=3)
        assert m["frames"] > 0 and m.get("segments", 1) == segments
        with wave.open(os.path.join(out, "audio_000.wav"), "rb") as f:
            wavs[name] = np.frombuffer(f.readframes(f.getnframes()),
                                       dtype="<i2").astype(np.int32)
    assert wavs["torch"].shape == wavs["jax"].shape
    assert np.abs(wavs["torch"] - wavs["jax"]).max() <= PCM_LSB
    assert (tmodel._serving is not None) == (segments > 1)


# -- speculative depth decode -----------------------------------------------------

def _cp_inputs(cfg, B: int, seed: int):
    rng = np.random.default_rng(seed)
    h = rng.normal(0, 1, (B, cfg.talker.hidden)).astype(np.float32)
    cb0 = rng.integers(0, cfg.codec.codebook_size, B)
    return h, cb0


@pytest.mark.parametrize("layout", ["hidden_token", "sum"])
def test_spec_decode_equals_sequential_greedy_and_jax(layout):
    """Random weights make an adversarial draft: the verify-and-correct
    loop still ends on the exact depth_group=1 greedy codes, equal to the
    JAX package's speculative decode, with the same feedback sum; the
    teacher-forced logits match JAX's within ATOL."""
    def cfgs(mod):
        base = _f32(_sixteen_codebooks(mod.tiny_feedback()))
        if layout == "sum":
            base = dataclasses.replace(base, code_predictor=dataclasses.replace(
                base.code_predictor, input_layout="sum", input_proj=True))
        return base, _sixteen_codebooks(base, depth_group=5, spec_decode=True)

    (jbase, jspec), (tbase, tspec) = cfgs(jcfgs), cfgs(tcfgs)
    tree = init_code_predictor(jbase, 7)
    _, cp, _ = params_from_numpy({}, tree, {}, device="cpu")
    h, cb0 = _cp_inputs(tbase, 5, 0)
    th, tcb0 = torch.from_numpy(h), torch.from_numpy(cb0)
    seq, rs_seq = tcp.predict_residuals(cp, tbase, th, tcb0,
                                        return_feedback=True)
    got, rs_got, rounds = tcp.predict_residuals_spec(
        cp, tspec, th, tcb0, return_feedback=True, return_rounds=True)
    np.testing.assert_array_equal(got.numpy(), seq.numpy())
    np.testing.assert_allclose(rs_got.numpy(), rs_seq.numpy(), atol=ATOL)
    assert 1 <= rounds <= 15 + 1  # one fix a round, then the confirming pass
    # routed through predict_residuals by the config
    np.testing.assert_array_equal(
        tcp.predict_residuals(cp, tspec, th, tcb0).numpy(), seq.numpy())
    ref = jcp.predict_residuals_spec(tree, jspec, jnp.asarray(h),
                                     jnp.asarray(cb0, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_allclose(
        tcp.depth_logits_teacher_forced(cp, tbase, th, tcb0, got).numpy(),
        np.asarray(jcp.depth_logits_teacher_forced(
            tree, jbase, jnp.asarray(h), jnp.asarray(cb0, jnp.int32),
            jnp.asarray(np.asarray(ref)))), atol=ATOL)


def _joint_counts(codes: np.ndarray, V: int) -> np.ndarray:
    flat = (codes[:, 0] * V + codes[:, 1]) * V + codes[:, 2]
    return np.bincount(flat, minlength=V ** 3)


def _chi2_pvalue(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample chi-squared test of homogeneity on equal-size count
    vectors: sum (a - b)^2 / (a + b) over the cells either sample hit,
    with cells - 1 degrees of freedom."""
    from scipy.stats import chi2

    keep = (a + b) > 0
    stat = float((((a - b) ** 2)[keep] / (a + b)[keep]).sum())
    return float(chi2.sf(stat, int(keep.sum()) - 1))


def test_sampled_spec_matches_sequential_in_distribution():
    """Exact speculative SAMPLING: the joint law of the three residual
    codes of one frame equals the sequential depth_group=1 sampled
    stream's. 20,000 draws (one input row repeated, rows independent) of
    each sampler; a chi-squared test of homogeneity over the joint cells
    must not reject at p = 1e-3. Negative control: the plain grouped dg=3
    path (the factorization the spec loop corrects) is rejected at
    p < 1e-6, so the test has power."""
    def cfgs(mod):
        base = _f32(mod.tiny_feedback())
        base = dataclasses.replace(base, code_predictor=dataclasses.replace(
            base.code_predictor, top_k=4, top_p=0.9))
        return (base,
                dataclasses.replace(base, code_predictor=dataclasses.replace(
                    base.code_predictor, depth_group=3, spec_decode=True)),
                dataclasses.replace(base, code_predictor=dataclasses.replace(
                    base.code_predictor, depth_group=3)))

    base, spec, grouped = cfgs(tcfgs)
    tree = init_code_predictor(cfgs(jcfgs)[0], 7)
    _, cp, _ = params_from_numpy({}, tree, {}, device="cpu")
    N = 20_000
    h, cb0 = _cp_inputs(base, 1, 3)
    th = torch.from_numpy(h).repeat(N, 1)
    tcb0 = torch.from_numpy(cb0).repeat(N)
    V = base.codec.residual_codebook_size

    def draws(cfg, seed):
        gen = torch.Generator().manual_seed(seed)
        return _joint_counts(
            tcp.predict_residuals(cp, cfg, th, tcb0, generator=gen).numpy(), V)

    seq, spc, grp = draws(base, 1), draws(spec, 2), draws(grouped, 3)
    assert _chi2_pvalue(seq, spc) > 1e-3
    assert _chi2_pvalue(seq, grp) < 1e-6
    # top_k=1 leaves one code a depth: the sampled spec path equals the
    # sequential greedy codes exactly
    k1 = dataclasses.replace(spec, code_predictor=dataclasses.replace(
        spec.code_predictor, top_k=1))
    g1 = dataclasses.replace(base, code_predictor=dataclasses.replace(
        base.code_predictor, top_k=0, top_p=1.0))
    h5, c5 = _cp_inputs(base, 5, 4)
    np.testing.assert_array_equal(
        tcp.predict_residuals(cp, k1, torch.from_numpy(h5), torch.from_numpy(c5),
                              generator=torch.Generator().manual_seed(0)).numpy(),
        tcp.predict_residuals(cp, g1, torch.from_numpy(h5),
                              torch.from_numpy(c5)).numpy())


# -- serving and loading ------------------------------------------------------------

@pytest.mark.parametrize("name", ["cb0_fps2", "residual_sum_fps2_cpb"])
def test_serving_engine_at_fps2_matches_jax_engine(name):
    """Three prompts with budgets 4, 10 and 7 through four slots at two
    frames a step, greedy: each stream's codes equal the JAX engine's, its
    PCM within 2 LSB."""
    jmodel, tmodel = _models(name)
    budgets = [4, 10, 7]
    jeng = JaxEngine(jmodel, max_streams=4, chunk=4,
                     sampling=JaxSampling(**GREEDY))
    teng = ServingEngine(tmodel, max_streams=4, chunk=4,
                         sampling=SamplingConfig(**GREEDY))
    assert teng.tok.shape == (4, 2)
    seeds = (1, 2, 3)
    ref = jeng.run([JaxPrompt(**_prompt_kw(s)) for s in seeds],
                   max_frames=budgets)
    got = teng.run([PromptSpec(**_prompt_kw(s)) for s in seeds],
                   max_frames=budgets)
    for (rwav, rst), (wav, st) in zip(ref, got):
        assert st.frames == rst.frames > 0, name
        np.testing.assert_array_equal(np.concatenate(st.codes, axis=1),
                                      np.concatenate(rst.codes, axis=1))
        assert wav.shape == rwav.shape
        diff = np.abs(wav.astype(np.int32) - rwav.astype(np.int32))
        assert diff.max() <= PCM_LSB, name
    with pytest.raises(ValueError, match="multiple"):
        teng.chunk = 5


def test_int8_kv_serving_at_fps2_matches_single_stream(monkeypatch):
    """QWEN3_TTS_KV=int8 at two frames a step: the serving engine's greedy
    codes equal single-stream decode's from the same int8 cache format,
    its PCM within 2 LSB (the codec sums a batch of two rows)."""
    monkeypatch.setenv("QWEN3_TTS_KV", "int8")
    _, tmodel = _models("cb0_fps2")
    gen = tmodel.generator
    prompts = [PromptSpec(**_prompt_kw(s)) for s in (1, 2)]
    singles = [gen.synthesize(p, max_frames=10, collect_codes=True)
               for p in prompts]
    eng = ServingEngine(tmodel, max_streams=2, chunk_schedule=gen.chunk_schedule,
                        sampling=SamplingConfig(**GREEDY))
    assert eng.kv_format == "int8"
    for res, (wav, st) in zip(singles, eng.run(prompts, max_frames=10)):
        assert st.frames == res.frames > 0
        np.testing.assert_array_equal(np.concatenate(st.codes, axis=1),
                                      res.codes)
        diff = np.abs(wav.astype(np.int32) - res.wav.astype(np.int32))
        assert wav.shape == res.wav.shape and diff.max() <= PCM_LSB


def test_jax_native_dir_with_mtp_heads_loads_and_synthesizes(temp_dir):
    """A native directory the JAX package's save_model wrote from a model
    with grafted MTP heads at fps 2 (what finetune.py --mtp-fps leaves):
    the port's load_model reads the mtp subtree bit-equal, and its greedy
    codes equal the JAX model's."""
    jc = _f32(jcfgs.tiny_feedback())
    trees = _trees(jc)
    jfps = jcfgs.with_frames_per_step(jc, 2)
    jmodel = JaxModel(cfg=jfps, params=jtalker.add_mtp_params(trees[0], jfps),
                      cp_params=trees[1], codec_params=trees[2],
                      tokenizer=JaxByteTokenizer(),
                      sampling=JaxSampling(**GREEDY))
    path = os.path.join(temp_dir, "native")
    jax_save_model(jmodel, path)
    tmodel = load_model(path, device="cpu")
    assert tmodel.cfg.talker.frames_per_step == 2
    assert_trees_equal(tmodel.params["mtp"], jmodel.params["mtp"])
    tmodel.sampling = SamplingConfig(**GREEDY)
    ref = jmodel.generator.synthesize(JaxPrompt(**_prompt_kw(1)),
                                      max_frames=9, collect_codes=True)
    got = tmodel.generator.synthesize(PromptSpec(**_prompt_kw(1)),
                                      max_frames=9, collect_codes=True)
    assert got.frames == ref.frames > 0
    np.testing.assert_array_equal(got.codes, ref.codes)


def test_device_init_makes_mtp_heads_on_the_device():
    """Synthetic weights made on a device (here the CPU through
    DeviceInit, Qwen3TTSModel.synthetic's path on the card): an fps 2 talker
    carries int8 MTP heads of the layout the host initialiser makes."""
    tc = tcfgs.with_frames_per_step(tcfgs.tiny(quant=True), 2)
    dev, host = (ttalker.init_talker(tc, 0, device=d)["mtp"]
                 for d in ("cpu", None))

    def layout(tree):
        return {k: layout(v) if isinstance(v, dict) else (v.shape, v.dtype)
                for k, v in tree.items()}
    assert layout(dev) == layout(host)
    assert set(dev["merge"]) == {"q", "scale", "bias"}
