"""The port's one-pass prompt assembly (``Generator.fast_assembly_plan``,
``assemble_from_plan``, ``assemble_plans_batched``), the speculative chunk
pipelining of ``Generator.stream``, the serving engine's deferred plans,
the opt-in talker fusing, and the names ported beside them, against the
JAX package on tiny float32 numpy trees.

Tolerances: the plan's rows are gathers and masked copies of the same
table rows the eager chain concatenates, so they are bit-equal to it and
within 1e-6 of JAX's (identical float32 values: no arithmetic but the
published rows' one add); PCM within 2 LSB of JAX's (float32 summation
order in the codec); every comparison across pipeline depths exact."""

import dataclasses
import fcntl

import numpy as np
import pytest
import torch

from qwen3_tts_tpu import quality as jquality
from qwen3_tts_tpu.config import EngineSettings as JaxEngineSettings
from qwen3_tts_tpu.engine import configs as jcfgs
from qwen3_tts_tpu.models import codec as jcodec
from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.models.code_predictor import init_code_predictor
from qwen3_tts_tpu.models.codec import init_codec
from qwen3_tts_tpu.models.talker import init_talker
from qwen3_tts_tpu.runtime.generate import Generator as JaxGenerator
from qwen3_tts_tpu.runtime.prompts import PromptSpec as JaxPrompt
from qwen3_tts_tpu.runtime.sampling import SamplingConfig as JaxSampling
from qwen3_tts_tpu_torch import device_lock, quality, ui
from qwen3_tts_tpu_torch.config import EngineSettings
from qwen3_tts_tpu_torch.engine import configs as tcfgs
from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
from qwen3_tts_tpu_torch.engine.weights import params_from_numpy
from qwen3_tts_tpu_torch.models import codec as tcodec
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.runtime import generate
from qwen3_tts_tpu_torch.runtime.generate import Generator, fuse_talker_params
from qwen3_tts_tpu_torch.runtime.prompts import PromptSpec
from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig
from qwen3_tts_tpu_torch.runtime.serving import ServingEngine
from torch_port_helpers import tame_codec

JAX_ATOL = 1e-6   # the plan's rows against JAX's plan
PCM_LSB = 2       # int16 PCM against JAX's stream
GREEDY = SamplingConfig(greedy=True)
PLAN_FIELDS = ("proto", "tb_tok", "Lb", "pad", "spk_kind", "spk_idx", "T")


def _f32(cfg, quant: bool = True):
    return dataclasses.replace(cfg, dtype="float32", quant=dataclasses.replace(
        cfg.quant, enabled=quant))


PROTOS = {"cb0": lambda m: m.tiny("custom"),
          "pub": lambda m: m.tiny_feedback("custom")}


def _generators(proto: str, sampling=(GREEDY, JaxSampling(greedy=True)),
                chunk_schedule=(4,)):
    """(JAX Generator, port Generator) on one numpy tree."""
    jc, tc = _f32(PROTOS[proto](jcfgs)), _f32(PROTOS[proto](tcfgs))
    codec = tame_codec(init_codec(jc, 2))
    trees = (init_talker(jc, 0), init_code_predictor(jc, 1), codec)
    jgen = JaxGenerator(cfg=jc, params=trees[0], cp_params=trees[1],
                        codec_params=trees[2], sampling=sampling[1],
                        chunk_schedule=chunk_schedule)
    p, cp, c = params_from_numpy(*trees, device="cpu")
    tgen = Generator(cfg=tc, params=p, cp_params=cp, codec_params=c,
                     sampling=sampling[0], chunk_schedule=chunk_schedule)
    return jgen, tgen


@pytest.fixture(scope="module")
def gens():
    return {proto: _generators(proto) for proto in PROTOS}


SPEAKERS = {"table": {"speaker_id": 2}, "codec": {"speaker_token": 3},
            "none": {}}


def _prompts(proto: str, tgen, spk: str) -> list:
    """Text lengths across the buckets (and, published, across the
    trailing buffer's cut at Tb - 2 text rows)."""
    if proto == "pub":
        Tb = tgen.cfg.talker.trailing_bucket
        lengths = (4, 6, 30, Tb + 1, Tb + 2, Tb + 6)
    else:
        lengths = (1, 6, 9, 40)
    vocab = tgen.cfg.talker.vocab_size
    return [dict(text_tokens=(np.arange(T, dtype=np.int32) * 7 + 3) % vocab,
                 **SPEAKERS[spk]) for T in lengths]


def _eager(tgen, prompt):
    tgen._fast_assembly = False
    try:
        return tgen.assemble_prompt_full(prompt)
    finally:
        tgen._fast_assembly = True


def _np(x):
    return None if x is None else np.asarray(x, np.float32)


@pytest.mark.parametrize("spk", list(SPEAKERS))
@pytest.mark.parametrize("proto", list(PROTOS))
def test_plan_equals_the_eager_chain_and_jax(gens, proto, spk):
    """The plan's (emb, pad, trailing): bit-equal to the port's eager chain,
    within JAX_ATOL of JAX's assemble_from_plan, from a plan whose fields
    are JAX's; the plan is what assemble_prompt_full and the stream use."""
    jgen, tgen = gens[proto]
    for kw in _prompts(proto, tgen, spk):
        prompt = PromptSpec(**kw)
        plan = tgen.fast_assembly_plan(prompt)
        jplan = jgen.fast_assembly_plan(JaxPrompt(**kw))
        assert plan is not None and jplan is not None
        assert [getattr(plan, f) for f in PLAN_FIELDS] == \
            [getattr(jplan, f) for f in PLAN_FIELDS]
        np.testing.assert_array_equal(plan.toks, jplan.toks)
        got = tgen.assemble_from_plan(plan)
        want = _eager(tgen, prompt)
        assert got[1] == want[1]
        assert torch.equal(got[0], want[0])
        assert (got[2] is None) == (want[2] is None) == (proto == "cb0")
        if got[2] is not None:
            assert torch.equal(got[2], want[2])
        full = tgen.assemble_prompt_full(prompt)
        assert torch.equal(full[0], got[0])
        jemb, jpad, jtrail = jgen.assemble_from_plan(jplan)
        assert jpad == got[1]
        np.testing.assert_allclose(got[0].numpy(), _np(jemb), atol=JAX_ATOL,
                                   rtol=0)
        if got[2] is not None:
            np.testing.assert_allclose(got[2].numpy(), _np(jtrail),
                                       atol=JAX_ATOL, rtol=0)


@pytest.mark.parametrize("proto", list(PROTOS))
def test_batched_plans_equal_the_single_plans(gens, proto):
    """Three prompts of mixed lengths (text buckets 8, 16 and 32, one prompt
    bucket): one batched assembly equals the three single ones, and the
    batch is exactly three rows (no power-of-two padding)."""
    _, tgen = gens[proto]
    plans = [tgen.fast_assembly_plan(PromptSpec(
        text_tokens=np.arange(T, dtype=np.int32) + 5, speaker_id=1))
        for T in (5, 12, 27)]
    assert sorted({p.tb_tok for p in plans}) == [8, 16, 32]
    assert len({p.Lb for p in plans}) == 1
    emb, trailing = tgen.assemble_plans_batched(plans)
    assert emb.shape[0] == 3
    for i, plan in enumerate(plans):
        e, _, tr = tgen.assemble_from_plan(plan)
        assert torch.equal(emb[i:i + 1], e)
        if proto == "pub":
            assert torch.equal(trailing[i:i + 1], tr)
        else:
            assert trailing is None and tr is None
    mixed = plans[:1] + [tgen.fast_assembly_plan(PromptSpec(
        text_tokens=np.arange(6, dtype=np.int32), speaker_token=3))]
    with pytest.raises(ValueError, match="group"):
        tgen.assemble_plans_batched(mixed)


def _no_plan_cases(proto: str, cfg) -> dict:
    D = cfg.talker.hidden
    vec = np.full(D, 0.01, np.float32)
    codes = np.zeros((cfg.codec.num_codebooks, 5), np.int32)
    toks = np.arange(8, dtype=np.int32) + 1
    cases = {"clone_vector": dict(text_tokens=toks, speaker_vector=vec),
             "clone_codes": dict(text_tokens=toks, acoustic_codes=codes)}
    if proto == "pub":
        cases["too_short"] = dict(text_tokens=np.arange(3, dtype=np.int32))
    else:
        cases["too_short"] = dict(text_tokens=np.zeros(0, np.int32))
        cases["truncating"] = dict(text_tokens=np.arange(
            3000, dtype=np.int32) % 200, speaker_id=1)
        cases["both_speakers"] = dict(text_tokens=toks, speaker_id=1,
                                      speaker_token=3)
    return cases


@pytest.mark.parametrize("proto", list(PROTOS))
def test_no_plan_where_jax_has_none(gens, proto):
    """Clone conditioning, too-short and (cb0) truncating prompts and both
    speaker kinds at once keep the eager chain in both packages."""
    jgen, tgen = gens[proto]
    for name, kw in _no_plan_cases(proto, tgen.cfg).items():
        assert jgen.fast_assembly_plan(JaxPrompt(**kw)) is None, name
        assert tgen.fast_assembly_plan(PromptSpec(**kw)) is None, name


def test_the_plan_raises_the_tokenizer_mismatch_at_plan_time(gens):
    """Published protocol: an out-of-range id raises when the plan is
    made, as JAX's does (a deferred plan must not postpone it)."""
    jgen, tgen = gens["pub"]
    bad = dict(text_tokens=np.array([1, 2, 3, tgen.cfg.talker.vocab_size],
                                    np.int32))
    with pytest.raises(ValueError, match="tokenizer/config mismatch"):
        jgen.fast_assembly_plan(JaxPrompt(**bad))
    with pytest.raises(ValueError, match="tokenizer/config mismatch"):
        tgen.fast_assembly_plan(PromptSpec(**bad))


class _Recorder(generate._HostCopy):
    """A host copy that logs its dispatch (the chunk's copy started) and
    its read."""

    log: list = []

    def __init__(self, dev, start):
        self.log.append("dispatch")
        super().__init__(dev, start)

    def numpy(self):
        self.log.append("read")
        return super().numpy()


def _in_flight_before_reads(log: list) -> list:
    counts, n = [], 0
    for event in log:
        if event == "dispatch":
            n += 1
        else:
            counts.append(n)
            n -= 1
    return counts


@pytest.mark.parametrize("proto", list(PROTOS))
def test_pipeline_depths_give_jax_codes_and_pcm(gens, proto, monkeypatch):
    """Greedy codes and PCM at pipeline_depth 1, 2 and 3 equal each other
    (exactly) and JAX's stream (codes exactly, PCM within PCM_LSB); the
    first chunk is read before the second is dispatched, then up to
    ``depth`` chunks are in flight at each read."""
    jgen, tgen = gens[proto]
    prompt = dict(text_tokens=np.arange(9, dtype=np.int32) + 2, speaker_id=1)
    want = jgen.synthesize(JaxPrompt(**prompt), max_frames=26,
                           collect_codes=True)
    monkeypatch.setattr(generate, "_HostCopy", _Recorder)
    runs = {}
    for depth in (1, 2, 3):
        tgen.pipeline_depth = depth
        _Recorder.log = []
        runs[depth] = tgen.synthesize(PromptSpec(**prompt), max_frames=26,
                                      collect_codes=True)
        in_flight = _in_flight_before_reads(_Recorder.log)
        assert _Recorder.log[:2] == ["dispatch", "read"]
        assert max(in_flight) == min(depth, len(in_flight))
    tgen.pipeline_depth = 2
    assert tgen.last_assembly["assembly"] == "plan"
    for depth, got in runs.items():
        assert got.frames == want.frames > 8
        np.testing.assert_array_equal(got.codes, runs[1].codes)
        np.testing.assert_array_equal(got.wav, runs[1].wav)
        np.testing.assert_array_equal(got.codes, want.codes)
        assert np.abs(got.wav.astype(np.int32)
                      - want.wav.astype(np.int32)).max() <= PCM_LSB


@pytest.mark.parametrize("proto", list(PROTOS))
def test_sampled_pcm_is_equal_across_depths(proto):
    """Seeded sampling: the chunks dispatched ahead draw the same numbers
    in the same order, so the PCM is the same at every depth."""
    _, tgen = _generators(proto, sampling=(SamplingConfig(),
                                           JaxSampling()))
    prompt = PromptSpec(text_tokens=np.arange(7, dtype=np.int32) + 4)
    wavs = []
    for depth in (1, 2, 3):
        tgen.pipeline_depth = depth
        wavs.append(tgen.synthesize(prompt, max_frames=20, seed=11).wav)
    assert len(wavs[0]) > 0
    for w in wavs[1:]:
        np.testing.assert_array_equal(w, wavs[0])


@pytest.fixture(scope="module")
def fb_model():
    """The published protocol; its rvq decoder's convs tamed (see
    torch_port_helpers), so the PCM bound sees an unclipped signal."""
    m = Qwen3TTSModel.synthetic(_f32(tcfgs.tiny_feedback("custom")), seed=5,
                                device="cpu")
    m.codec_params = tame_codec(m.codec_params)
    m.sampling = GREEDY
    return m


def test_cold_batch_assembles_once_per_group(fb_model):
    """Four cold submissions of three speaker kinds: submit defers every
    assembly, the cold batch makes one assemble_plans_batched call per
    (proto, spk_kind) group and no per-stream call, and every stream's
    codes equal its single-stream synthesis (PCM within PCM_LSB: the batch
    sums in another order)."""
    vocab = fb_model.cfg.talker.vocab_size
    prompts = [PromptSpec(text_tokens=(np.arange(n, dtype=np.int32) * 5 + 1)
                          % vocab, **kw)
               for n, kw in ((7, {"speaker_id": 1}), (9, {"speaker_token": 3}),
                             (12, {"speaker_id": 2}), (6, {}))]
    singles = [fb_model.generator.synthesize(p, max_frames=10,
                                             collect_codes=True)
               for p in prompts]
    engine = ServingEngine(fb_model, max_streams=4, chunk=4, sampling=GREEDY)
    gen = fb_model.generator
    batched, single = [], []
    orig_b, orig_s = gen.assemble_plans_batched, gen.assemble_from_plan

    def spy_b(plans):
        batched.append(sorted(p.spk_kind for p in plans))
        return orig_b(plans)

    def spy_s(plan):
        single.append(plan.spk_kind)
        return orig_s(plan)

    gen.assemble_plans_batched, gen.assemble_from_plan = spy_b, spy_s
    try:
        for p in prompts:
            engine.submit(p, max_frames=10)
        assert all(pp.emb is None and pp.plan is not None
                   for pp in engine._pending)
        assert not batched
        while any(not st.done for st in engine.streams.values()):
            engine.step()
    finally:
        gen.assemble_plans_batched, gen.assemble_from_plan = orig_b, orig_s
    assert sorted(batched) == [["codec"], ["none"], ["table", "table"]]
    assert not single
    for sid, want in enumerate(singles):
        wav, st = engine.collect(sid)
        assert st.frames == want.frames > 0
        np.testing.assert_array_equal(np.concatenate(st.codes, 1),
                                      want.codes)
        assert wav.shape == want.wav.shape
        assert np.abs(wav.astype(np.int32)
                      - want.wav.astype(np.int32)).max() <= PCM_LSB


def test_a_join_assembles_its_deferred_plan_on_first_use(fb_model):
    """A stream submitted while another decodes (the slice path) assembles
    from its plan when its prefill starts."""
    engine = ServingEngine(fb_model, max_streams=2, chunk=4, sampling=GREEDY)
    p1 = PromptSpec(text_tokens=np.arange(8, dtype=np.int32) + 1,
                    speaker_id=1)
    p2 = PromptSpec(text_tokens=np.arange(11, dtype=np.int32) + 3,
                    speaker_id=0)
    a = engine.submit(p1, max_frames=8)
    engine.step()
    b = engine.submit(p2, max_frames=8)
    assert engine._pending[0].emb is None
    while not (engine.streams[a].done and engine.streams[b].done):
        engine.step()
    want = fb_model.generator.synthesize(p2, max_frames=8, collect_codes=True)
    np.testing.assert_array_equal(np.concatenate(engine.collect(b)[1].codes,
                                                 1), want.codes)


def test_fused_talker_greedy_parity(monkeypatch):
    """QWEN3_TTS_FUSE_TALKER=1 (JAX tests/test_fuse.py): the generator's
    talker blocks carry qkv and gate_up, grouped for kernel A under the
    grouped layout, the model keeps its split tree, and greedy codes and
    PCM equal the unfused run's."""
    cfg = _f32(tcfgs.tiny_feedback("custom"))
    prompt = PromptSpec(text_tokens=np.arange(8, dtype=np.int32) + 2,
                        speaker_id=1)
    monkeypatch.setenv("QWEN3_TTS_INT8_LAYOUT", "grouped")

    def run():
        m = Qwen3TTSModel.synthetic(cfg, seed=4, device="cpu")
        m.sampling = GREEDY
        return m, m.generator.synthesize(prompt, max_frames=6,
                                         collect_codes=True)

    monkeypatch.delenv("QWEN3_TTS_FUSE_TALKER", raising=False)
    plain, r_plain = run()
    assert "qkv" not in plain.generator.params["blocks"][0]["attn"]
    monkeypatch.setenv("QWEN3_TTS_FUSE_TALKER", "1")
    fused, r_fused = run()
    attn = fused.generator.params["blocks"][0]["attn"]
    assert "qkv" in attn and "qg" in attn["qkv"]
    assert "gate_up" in fused.generator.params["blocks"][0]["mlp"]
    assert "qkv" not in fused.params["blocks"]["attn"]
    np.testing.assert_array_equal(r_fused.codes, r_plain.codes)
    np.testing.assert_array_equal(r_fused.wav, r_plain.wav)


def test_fuse_talker_params_is_a_no_op_where_jax_skips(monkeypatch):
    """Off unless asked; a LoRA tree, a tp mesh's tree and a fused tree
    come back as they are."""
    cfg = _f32(tcfgs.tiny("custom"), quant=False)
    params = params_from_numpy(init_talker(cfg, 0), {}, {}, device="cpu")[0]
    monkeypatch.delenv("QWEN3_TTS_FUSE_TALKER", raising=False)
    assert fuse_talker_params(params) is params
    monkeypatch.setenv("QWEN3_TTS_FUSE_TALKER", "1")
    fused = fuse_talker_params(params)
    assert "qkv" in fused["blocks"]["attn"]
    assert fuse_talker_params(fused) is fused

    class TwoRanks:
        tp = 2

    assert fuse_talker_params(params, TwoRanks()) is params
    lora = {**params, "blocks": {**params["blocks"], "attn": {
        **params["blocks"]["attn"], "q": {
            **params["blocks"]["attn"]["q"],
            "lora_a": torch.zeros(2, 2, 2)}}}}
    assert fuse_talker_params(lora) is lora


def test_chunk_property_and_assemble_prompt(gens):
    jgen, tgen = gens["cb0"]
    assert tgen.chunk == jgen.chunk == 4
    prompt = dict(text_tokens=np.arange(5, dtype=np.int32) + 1, speaker_id=0)
    emb, pad = tgen.assemble_prompt(PromptSpec(**prompt))
    jemb, jpad = jgen.assemble_prompt(JaxPrompt(**prompt))
    assert pad == jpad
    np.testing.assert_allclose(emb.numpy(), _np(jemb), atol=JAX_ATOL, rtol=0)


# -- the names ported beside them ---------------------------------------------

def test_mel_gate_verdicts_equal_jax():
    assert (quality.MEL_DRIFT_MAX_DB, quality.MEL_GATE_MAX_DB) == \
        (jquality.MEL_DRIFT_MAX_DB, jquality.MEL_GATE_MAX_DB)
    assert quality.DEFAULT_TEXTS == jquality.DEFAULT_TEXTS
    grid = np.linspace(0.0, 10.0, 41)
    for drift in grid:
        for total in grid:
            for lossless in (False, True):
                assert quality.mel_gate_passes(drift, total, lossless) == \
                    jquality.mel_gate_passes(drift, total, lossless)


def test_require_device_lock_exits_3_when_the_lock_is_held(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    monkeypatch.delenv("QWEN3_TTS_CPU", raising=False)
    monkeypatch.delenv("QWEN3_TTS_DEVICE_LOCK", raising=False)
    path = str(tmp_path / "device.lock")
    with open(path, "a+") as held:
        fcntl.flock(held.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        with pytest.raises(SystemExit) as exc:
            device_lock.require_device_lock("bench", wait_s=0, path=path)
    assert exc.value.code == 3
    assert "bench: device lock never freed" in capsys.readouterr().err
    free = str(tmp_path / "free.lock")
    device_lock.require_device_lock("bench", wait_s=0, path=free)  # returns


def test_engine_settings_theme_and_model_helpers_equal_jax():
    assert dataclasses.asdict(EngineSettings()) == \
        dataclasses.asdict(JaxEngineSettings())
    fresh = ui.ThemedTheme()
    assert fresh._theme is None
    assert str(fresh.styles["accent"]) == "bold cyan"
    assert fresh._theme is not None
    cfg = _f32(jcfgs.tiny("custom"))
    tp = init_talker(cfg, 0)
    toks = np.array([[3, 9, 1]], np.int32)
    np.testing.assert_array_equal(
        ttalker.embed_text_tokens(params_from_numpy(tp, {}, {},
                                                    device="cpu")[0],
                                  torch.from_numpy(toks).long()).numpy(),
        np.asarray(jtalker.embed_text_tokens(tp, toks)))
    want = jcodec.init_conv_state(cfg.codec, 2)
    got = tcodec.init_conv_state(_f32(tcfgs.tiny("custom")).codec, 2)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert all(not v.any() for v in got.values())
