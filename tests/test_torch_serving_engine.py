"""The port's continuous batched serving engine on its own (no JAX): greedy
serving equals single-stream synthesis token for token, slots recycle,
prefill is chunked under load and batched at a cold start, slot groups
read their own windows, the chunk schedule and the pipeline ramp, cancel,
deferred and accumulated audio. Tiny float32 models on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch.engine import configs
from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
from qwen3_tts_tpu_torch.runtime import generate
from qwen3_tts_tpu_torch.runtime.prompts import PromptSpec
from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig
from qwen3_tts_tpu_torch.runtime.serving import (
    ServingEngine,
    _DeferredCodes,
    _DeferredWav,
)
from torch_port_helpers import tame_codec

GREEDY = SamplingConfig(greedy=True)
PCM_LSB = 2  # int16 PCM tolerance: float32 summation order in the codec


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module")
def model():
    """The cb0 protocol and the rvq codec, its decoder convs tamed (see
    torch_port_helpers) so that the PCM bound sees an unclipped signal."""
    m = Qwen3TTSModel.synthetic(_f32(configs.tiny(quant=True)), seed=5,
                                device="cpu")
    m.codec_params = tame_codec(m.codec_params)
    m.sampling = GREEDY
    return m


@pytest.fixture(scope="module")
def fb_model():
    """The published residual_sum protocol driving the code2wav decoder."""
    cfg = configs.with_code2wav(configs.tiny_feedback(),
                                configs.tiny_code2wav().code2wav)
    m = Qwen3TTSModel.synthetic(_f32(cfg), seed=5, device="cpu")
    m.sampling = GREEDY
    return m


def _prompt(seed: int, n: int = 6) -> PromptSpec:
    rng = np.random.default_rng(seed)
    return PromptSpec(text_tokens=rng.integers(0, 200, size=n).astype(np.int32),
                      speaker_id=int(seed % 4))


def _codes(stream) -> np.ndarray:
    return np.concatenate(stream.codes, axis=1)


def _single(model, prompt, max_frames):
    return model.generator.synthesize(prompt, max_frames=max_frames,
                                      collect_codes=True)


def _assert_pcm_close(wav, ref):
    assert wav.shape == ref.shape
    assert np.abs(wav.astype(np.int32) - ref.astype(np.int32)).max() <= PCM_LSB


def _assert_same(served, single):
    wav, stream = served
    assert stream.done and stream.frames == single.frames > 0
    np.testing.assert_array_equal(_codes(stream), single.codes)
    _assert_pcm_close(wav, single.wav)


def _drive(eng, *ids, limit=200):
    for _ in range(limit):
        if all(eng.streams[i].done for i in ids):
            return
        eng.step()
    raise AssertionError(f"streams {ids} did not finish in {limit} steps")


@pytest.mark.parametrize("fixture", ["model", "fb_model"],
                         ids=["rvq", "residual_sum_code2wav"])
def test_serving_matches_single_stream_greedy(fixture, request):
    m = request.getfixturevalue(fixture)
    prompts = [_prompt(1), _prompt(2), _prompt(3)]
    budgets = [4, 10, 7]
    singles = [_single(m, p, b) for p, b in zip(prompts, budgets)]
    served = ServingEngine(m, max_streams=4, chunk=4, sampling=GREEDY).run(
        prompts, max_frames=budgets)
    for s, r in zip(served, singles):
        _assert_same(s, r)


@pytest.mark.parametrize("fixture", ["model", "fb_model"],
                         ids=["rvq", "residual_sum_code2wav"])
def test_midflight_join_leaves_other_streams_token_identical(fixture, request):
    """A stream joining mid-flight (chunked prefill interleaved with
    decode) changes no other stream's output and decodes as it would
    alone."""
    m = request.getfixturevalue(fixture)
    pa, pb = _prompt(4), _prompt(5)
    ra, rb = _single(m, pa, 12), _single(m, pb, 6)
    eng = ServingEngine(m, max_streams=2, chunk=4, prefill_chunk=16,
                        sampling=GREEDY)
    a = eng.submit(pa, max_frames=12)
    eng.step()
    eng.step()
    assert not eng.streams[a].done
    b = eng.submit(pb, max_frames=6)
    assert eng._pending[0].Lb > 16  # the join needs several slices
    _drive(eng, a, b)
    _assert_same(eng.collect(a), ra)
    _assert_same(eng.collect(b), rb)


def _spans(prof) -> dict:
    """name -> [(start, end)] of the program's spans in a profile."""
    out: dict = {}
    for e in prof.kineto_results.events():
        if e.name().startswith("qwen3_tts."):
            assert not e.is_user_annotation(), e.name()
            s = e.start_ns()
            out.setdefault(e.name()[len("qwen3_tts."):], []).append(
                (s, s + e.duration_ns()))
    return out


def _inside(iv, outer) -> bool:
    return any(a <= iv[0] and iv[1] <= b for a, b in outer)


@pytest.mark.parametrize("fixture", ["model", "fb_model"],
                         ids=["rvq", "residual_sum_code2wav"])
def test_a_profiled_step_records_every_decode_span(fixture, request):
    """One profiled step of 4 frames opens the decode path's spans: a
    talker pass a frame-step, the code predictor a frame-step (residual_sum,
    inside the loop) or once for the chunk (cb0), code2wav once, all inside
    the dispatch; attention inside the talker and the predictor (and the
    codec's transformer); the host wait inside the collection."""
    m = request.getfixturevalue(fixture)
    eng = ServingEngine(m, max_streams=2, chunk=4, sampling=GREEDY)
    sid = eng.submit(_prompt(2), max_frames=40)
    eng.step()  # the prefill and the first step
    with torch.autograd.profiler.profile(use_kineto=True) as prof:
        eng.step()
    assert not eng.streams[sid].done
    sp = _spans(prof)
    rvq = fixture == "model"
    assert {k: len(v) for k, v in sp.items() if k != "model.attention"} == {
        "engine.dispatch": 1, "engine.collect": 1, "engine.host_wait": 1,
        "model.talker": 4, "model.predictor": 1 if rvq else 4,
        "model.code2wav": 1}
    for name in ("model.talker", "model.predictor", "model.code2wav"):
        assert all(_inside(iv, sp["engine.dispatch"]) for iv in sp[name])
    assert all(_inside(iv, sp["engine.collect"])
               for iv in sp["engine.host_wait"])
    attn = sp["model.attention"]
    model = sp["model.talker"] + sp["model.predictor"] + sp["model.code2wav"]
    assert all(_inside(iv, model) for iv in attn)
    assert any(_inside(iv, sp["model.talker"]) for iv in attn)
    assert any(_inside(iv, sp["model.predictor"]) for iv in attn)


def test_slots_recycle_and_a_recycled_slot_equals_a_fresh_engine(model):
    """Five prompts through two slots all finish, in slots 0 and 1, each
    with the output of a fresh engine serving it alone."""
    prompts = [_prompt(i) for i in range(5)]
    served = ServingEngine(model, max_streams=2, chunk=4,
                           sampling=GREEDY).run(prompts, max_frames=6)
    assert len(served) == 5 and {s.slot for _, s in served} <= {0, 1}
    for p, (wav, st) in zip(prompts, served):
        assert len(wav) == st.frames * model.cfg.codec.hop
        (fwav, fst), = ServingEngine(model, max_streams=2, chunk=4,
                                     sampling=GREEDY).run([p], max_frames=6)
        np.testing.assert_array_equal(_codes(st), _codes(fst))
        np.testing.assert_array_equal(wav, fwav)


def test_ttfa_is_recorded(model):
    (_, stream), = ServingEngine(model, max_streams=1, chunk=4,
                                 sampling=GREEDY).run([_prompt(3)], max_frames=5)
    assert stream.ttfa_s is not None and stream.ttfa_s > 0


def test_submit_overflow_raises(model):
    eng = ServingEngine(model, max_streams=1, chunk=4, sampling=GREEDY)
    eng.submit(_prompt(1), max_frames=4)
    with pytest.raises(RuntimeError, match="no free slots"):
        eng.submit(_prompt(2), max_frames=4)


@pytest.mark.parametrize("budgets,want", [(1, [1, 1]), ([2, 6], [2, 6])],
                         ids=["one_frame", "per_prompt"])
def test_frame_budgets(model, budgets, want):
    served = ServingEngine(model, max_streams=2, chunk=4, sampling=GREEDY).run(
        [_prompt(11), _prompt(12)], max_frames=budgets)
    assert [s.frames for _, s in served] == want
    assert [len(w) for w, _ in served] == [f * model.cfg.codec.hop for f in want]


def test_frame_budget_caps_at_the_codec_and_the_cache(model, monkeypatch):
    import qwen3_tts_tpu_torch.models.codec as codec_mod

    eng = ServingEngine(model, max_streams=2, chunk=4, sampling=GREEDY)
    sid = eng.submit(_prompt(53), max_frames=10_000)
    # the 64-row prompt bucket leaves max_seq_len - 64 positions
    assert eng.streams[sid].max_frames == model.cfg.max_seq_len - 64
    monkeypatch.setattr(codec_mod, "MAX_FRAMES", 32)
    sid = eng.submit(_prompt(54), max_frames=10_000)
    assert eng.streams[sid].max_frames == 32 - 2 * eng.chunk


def test_engine_reuse_across_runs(model):
    eng = ServingEngine(model, max_streams=2, chunk=4, sampling=GREEDY)
    (w1, _), = eng.run([_prompt(1)], max_frames=4)
    (w2, _), = eng.run([_prompt(1)], max_frames=4)
    np.testing.assert_array_equal(w1, w2)
    assert len(eng.streams) <= 2  # finished records do not pile up


def test_prefill_is_chunked_under_load(model):
    """While another stream decodes, one prefill slice of at most
    prefill_chunk tokens runs per step."""
    eng = ServingEngine(model, max_streams=2, chunk=4, prefill_chunk=16,
                        sampling=GREEDY)
    a = eng.submit(_prompt(1), max_frames=40)
    eng.step()  # activates a (nobody live: slices run back to back)
    eng.submit(_prompt(2), max_frames=4)
    slices = []
    while eng._pending:
        pp = eng._pending[0]
        before = pp.pos
        eng.step()
        slices.append(pp.pos - before)
        assert not eng.streams[a].done
    assert len(slices) == 4 and all(s == 16 for s in slices)


def test_non_divisor_prefill_chunk_is_exact(model):
    """A prefill_chunk that does not divide the bucket (64 = 24 + 24 + 16)
    prefills exactly."""
    p = _prompt(51)
    ref = _single(model, p, 10)
    eng = ServingEngine(model, max_streams=2, chunk=4, prefill_chunk=24,
                        sampling=GREEDY)
    a = eng.submit(_prompt(52), max_frames=24)  # keeps one stream live
    eng.step()
    b = eng.submit(p, max_frames=10)            # the sliced join path
    _drive(eng, a, b)
    _assert_same(eng.collect(b), ref)


def test_slot_groups_use_their_own_windows(model, monkeypatch):
    """Window buckets below max_seq_len: a long and a short stream land in
    different slot groups, steps run with distinct per-group windows, and
    both stay token-identical to single-stream synthesis."""
    monkeypatch.setattr(generate, "ATTN_BUCKETS", (96, 160, 256))
    long_p, short_p = _prompt(1), _prompt(2)
    rl, rs = _single(model, long_p, 60), _single(model, short_p, 8)
    eng = ServingEngine(model, max_streams=4, chunk=4, sampling=GREEDY)
    assert eng.n_groups == 2
    a = eng.submit(long_p, max_frames=60)
    b = eng.submit(short_p, max_frames=8)
    size = eng.B // eng.n_groups
    assert eng.streams[a].slot // size != eng.streams[b].slot // size
    _drive(eng, a, b)
    assert any(len(set(wins)) > 1 for _, wins in eng._decode_fns), \
        list(eng._decode_fns)
    _assert_same(eng.collect(a), rl)
    _assert_same(eng.collect(b), rs)


@pytest.mark.parametrize("rows,batched", [(None, [2]), ("64", [1, 1])],
                         ids=["batched", "row_cap"])
def test_cold_start_batch_and_its_row_cap(model, monkeypatch, rows, batched):
    """Two cold prompts of one bucket prefill together; with the row cap
    below 2 x 64 they take the slice path. Outputs equal single-stream
    synthesis either way."""
    if rows is not None:
        monkeypatch.setenv("QWEN3_TTS_COLD_BATCH_ROWS", rows)
    prompts = [_prompt(81), _prompt(82)]
    singles = [_single(model, p, 6) for p in prompts]
    eng = ServingEngine(model, max_streams=2, chunk=4, sampling=GREEDY)
    groups = []
    orig = eng._activate
    eng._activate = lambda group, *a: (groups.append(len(group)),
                                       orig(group, *a))
    for s, r in zip(eng.run(prompts, max_frames=6), singles):
        _assert_same(s, r)
    assert groups == batched


def test_cold_start_batches_multislice_prompts(model):
    """Prompts longer than one prefill slice batch at a cold start too."""
    prompts = [_prompt(61, n=100), _prompt(62, n=100)]
    singles = [_single(model, p, 8) for p in prompts]
    eng = ServingEngine(model, max_streams=2, chunk=4, prefill_chunk=64,
                        sampling=GREEDY)
    sliced = []
    orig = eng._prefill_slice
    eng._prefill_slice = lambda pp, C: (sliced.append(C), orig(pp, C))
    for s, r in zip(eng.run(prompts, max_frames=8), singles):
        _assert_same(s, r)
    assert not sliced and eng.streams  # no slice ran


def _spy_chunks(eng):
    used = []
    orig = eng._decode_fn

    def spy(chunk, wins):
        used.append(chunk)
        return orig(chunk, wins)

    eng._decode_fn = spy
    return used


def test_adaptive_schedule_grows_and_drops_back_for_a_join(model):
    """The schedule ramps as streams age, drops back to its first entry
    while a joining stream is young, and never changes tokens."""
    prompts = [_prompt(61), _prompt(62)]
    fixed = ServingEngine(model, max_streams=2, chunk=4,
                          sampling=GREEDY).run(prompts, max_frames=20)
    eng = ServingEngine(model, max_streams=2, chunk_schedule=(4, 8, 12),
                        sampling=GREEDY)
    used = _spy_chunks(eng)
    served = eng.run(prompts, max_frames=20)
    assert used[0] == 4 and max(used) == 12 and used == sorted(used), used
    for (w, s), (fw, fs) in zip(served, fixed):
        np.testing.assert_array_equal(_codes(s), _codes(fs))
        _assert_pcm_close(w, fw)  # other chunk shapes in the codec

    eng = ServingEngine(model, max_streams=2, chunk_schedule=(4, 8, 12),
                        sampling=GREEDY)
    used = _spy_chunks(eng)
    a = eng.submit(_prompt(63), max_frames=40)
    for _ in range(4):
        eng.step()
    assert used[-1] > 4
    b = eng.submit(_prompt(64), max_frames=8)
    eng.step()
    eng.step()
    assert 4 in used[-2:], used
    _drive(eng, a, b)


def test_chunk_switch_between_runs_matches_a_fresh_engine(model):
    prompts = [_prompt(31), _prompt(32)]
    eng = ServingEngine(model, max_streams=2, chunk=8, sampling=GREEDY)
    eng.run(prompts, max_frames=8)
    eng.chunk = 4
    served = eng.run(prompts, max_frames=10)
    fresh = ServingEngine(model, max_streams=2, chunk=4,
                          sampling=GREEDY).run(prompts, max_frames=10)
    for (w, s), (fw, fs) in zip(served, fresh):
        np.testing.assert_array_equal(_codes(s), _codes(fs))
        np.testing.assert_array_equal(w, fw)


def test_pipeline_ramps_to_depth_two_after_first_audio(model):
    """run() keeps one step in flight until a stream has audio, then two;
    outputs equal a fresh engine's."""
    prompts = [_prompt(81), _prompt(82)]
    expected = ServingEngine(model, max_streams=2, chunk=4,
                             sampling=GREEDY).run(prompts, max_frames=12)
    eng = ServingEngine(model, max_streams=2, chunk=4, sampling=GREEDY)
    events = []
    dispatch, collect = eng.dispatch_step, eng.collect_step

    def spy_dispatch():
        events.append(("d", all(st.ttfa_s is None
                                for st in eng.streams.values()
                                if not st.done)))
        return dispatch()

    def spy_collect(payload):
        events.append(("c", None))
        return collect(payload)

    eng.dispatch_step, eng.collect_step = spy_dispatch, spy_collect
    served = eng.run(prompts, max_frames=12, pipeline_depth=2)
    for i, (kind, cold) in enumerate(events[:-1]):
        if kind == "d" and cold:
            assert events[i + 1][0] == "c", (i, events)
    assert any(events[i] == ("d", False) and events[i + 1][0] == "d"
               for i in range(len(events) - 1)), events
    for (w, s), (fw, fs) in zip(served, expected):
        assert s.frames == fs.frames
        np.testing.assert_array_equal(w, fw)


def test_no_step_is_dispatched_past_every_budget(model):
    """Budgets of 12 at chunk 4 and pipeline depth 4: three steps, none
    dispatched once both streams have all their frames in flight."""
    eng = ServingEngine(model, max_streams=2, chunk=4, sampling=GREEDY)
    used = _spy_chunks(eng)
    served = eng.run([_prompt(4), _prompt(5)], max_frames=12,
                     pipeline_depth=4)
    assert used == [4, 4, 4] and [s.frames for _, s in served] == [12, 12]


def test_cancel_frees_the_slot_and_ignores_its_inflight_step(model):
    eng = ServingEngine(model, max_streams=2, chunk=4, sampling=GREEDY)
    pb = _prompt(72)
    a = eng.submit(_prompt(71), max_frames=40)
    b = eng.submit(pb, max_frames=12)
    eng.step()
    payload = eng.dispatch_step()        # in flight while a is cancelled
    slot = eng.streams[a].slot
    eng.cancel(a)
    assert a not in eng.streams and eng._slots[slot] is None
    assert not bool(eng.active_mask[slot])
    eng.collect_step(payload)            # a's part is dropped
    assert eng.free_slots() == 1
    _drive(eng, b)
    _assert_same(eng.collect(b), _single(model, pb, 12))
    # a cancelled pending prefill never activates
    c = eng.submit(_prompt(73), max_frames=4)
    eng.cancel(c)
    assert not eng._pending and eng.free_slots() == 2


@pytest.mark.parametrize("fixture", ["model", "fb_model"],
                         ids=["rvq", "residual_sum_code2wav"])
def test_accumulated_wav_equals_streaming(fixture, request):
    m = request.getfixturevalue(fixture)
    prompts = [_prompt(21), _prompt(22), _prompt(23)]
    ref = ServingEngine(m, max_streams=2, chunk=8, sampling=GREEDY).run(
        prompts, max_frames=16)
    eng = ServingEngine(m, max_streams=2, chunk=8, sampling=GREEDY,
                        accumulate_wav=True, accum_cap_frames=64)
    out = eng.run(prompts, max_frames=16, pipeline_depth=8)
    for (w, s), (rw, rs) in zip(out, ref):
        assert s.frames == rs.frames and s.ttfa_s is not None
        assert s.codes == []  # codes are not collected in this mode
        np.testing.assert_array_equal(w, rw)


def test_accumulated_wav_guards_its_capacity_and_streaming_consumers(model):
    eng = ServingEngine(model, max_streams=2, chunk=8, sampling=GREEDY,
                        accumulate_wav=True, accum_cap_frames=40)
    with pytest.raises(ValueError, match="accum_cap_frames"):
        eng.submit(_prompt(1), max_frames=39)
    with pytest.raises(ValueError, match="on_chunk"):
        eng.submit(_prompt(1), max_frames=4, on_chunk=lambda w: None)


@pytest.mark.parametrize("env", [{"QWEN3_TTS_DEFER_WAV": "1"},
                                 {"QWEN3_TTS_ASYNC_FETCH": "0"}],
                         ids=["defer_wav", "no_async_fetch"])
def test_fetch_modes_equal_the_default(model, monkeypatch, env):
    """Deferred audio (first chunk read at once, later chunks and every
    code slab at collect) and a copy started at collect give the default
    engine's bytes; three streams recycle one slot."""
    prompts = [_prompt(41), _prompt(42), _prompt(43)]
    ref = ServingEngine(model, max_streams=1, chunk=4, sampling=GREEDY).run(
        prompts, max_frames=12)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    eng = ServingEngine(model, max_streams=1, chunk=4, sampling=GREEDY)
    if "QWEN3_TTS_DEFER_WAV" in env:
        sid = eng.submit(prompts[0], max_frames=12)
        _drive(eng, sid)
        st = eng.streams[sid]
        assert isinstance(st.wav_chunks[0], np.ndarray)  # the TTFA chunk
        assert any(isinstance(c, _DeferredWav) for c in st.wav_chunks[1:])
        assert all(isinstance(c, _DeferredCodes) for c in st.codes)
    out = eng.run(prompts, max_frames=12)
    for (w, s), (rw, rs) in zip(out, ref):
        np.testing.assert_array_equal(w, rw)
        np.testing.assert_array_equal(_codes(s), _codes(rs))


def test_deferred_wav_keeps_on_chunk_streaming(model, monkeypatch):
    monkeypatch.setenv("QWEN3_TTS_DEFER_WAV", "1")
    eng = ServingEngine(model, max_streams=2, chunk=4, sampling=GREEDY)
    chunks = []
    sid = eng.submit(_prompt(42), max_frames=8, on_chunk=chunks.append)
    _drive(eng, sid)
    wav, _ = eng.collect(sid)
    assert len(chunks) == 2 and all(c.dtype == np.int16 for c in chunks)
    np.testing.assert_array_equal(np.concatenate(chunks), wav)


def test_engine_shares_the_generators_weights(model):
    eng = ServingEngine(model, max_streams=2, chunk=4, sampling=GREEDY)
    gen = model.generator
    assert eng.params is gen.params and eng.cp_params is gen.cp_params
    assert eng.codec_params is gen.codec_params
    assert model.serving_engine(2) is model.serving_engine(2)
    assert model.serving_engine(3).B == 3


def test_int8_kv_cache_raises_naming_item_11(model, monkeypatch):
    """Item 11's int8 KV cache is ported: QWEN3_TTS_KV=int8 gives KVQuant
    slot caches, the format read once at construction (a scratch cache
    allocated after the variable changes still matches the slots'); an
    unknown value raises."""
    from qwen3_tts_tpu_torch.models.layers import KVQuant

    monkeypatch.setenv("QWEN3_TTS_KV", "int8")
    eng = ServingEngine(model, max_streams=2, chunk=4, sampling=GREEDY)
    assert isinstance(eng.cache_k, KVQuant) and isinstance(eng.cache_v, KVQuant)
    monkeypatch.delenv("QWEN3_TTS_KV")
    (_, stream), = eng.run([_prompt(5)], max_frames=6)
    assert stream.frames > 0 and isinstance(eng._kv_zeros((1, 2)), KVQuant)
    monkeypatch.setenv("QWEN3_TTS_KV", "fp8")
    with pytest.raises(ValueError, match="QWEN3_TTS_KV"):
        ServingEngine(model, max_streams=2)


def test_sampled_serving_is_seeded(model):
    """Sampling draws from the engine's generator: one seed, one output."""
    sampled = SamplingConfig(temperature=0.9, top_k=20)
    outs = []
    for _ in range(2):
        eng = ServingEngine(model, max_streams=2, chunk=4, sampling=sampled)
        eng.rng.manual_seed(11)
        outs.append([_codes(s) for _, s in eng.run(
            [_prompt(5), _prompt(6)], max_frames=8)])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert isinstance(eng.rng, torch.Generator)
