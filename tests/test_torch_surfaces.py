"""The port's surfaces beside the engine, against the JAX package where it
has a counterpart: the WSOLA time stretch and generate_audio's speed
contract, the emit_metrics line, the spans of ``profiling.trace``, the
ASR provider registry and its backend knob, the decode-quality harness,
the device lock, the voice library over HTTP on a cloning model, and the
serving, batch, transcription and Whisper modules with jax, transformers,
safetensors, ml_dtypes, rich and prompt_toolkit blocked (as on the GPU
machine)."""

import base64
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from qwen3_tts_tpu import quality as jquality
from qwen3_tts_tpu.audio.stretch import time_stretch as jax_time_stretch
from qwen3_tts_tpu.engine import configs as jcfgs
from qwen3_tts_tpu.engine.api import Qwen3TTSModel as JaxModel
from qwen3_tts_tpu.engine.api import generate_audio as jax_generate_audio
from qwen3_tts_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from qwen3_tts_tpu.models.code_predictor import init_code_predictor
from qwen3_tts_tpu.models.codec import init_codec
from qwen3_tts_tpu.models.talker import init_talker
from qwen3_tts_tpu.runtime.sampling import SamplingConfig as JaxSampling
from qwen3_tts_tpu.voices import sanitize_voice_name as jax_sanitize
from qwen3_tts_tpu_torch import profiling, quality, transcription, ui, voices
from qwen3_tts_tpu_torch.audio import write_wav
from qwen3_tts_tpu_torch.audio.stretch import time_stretch
from qwen3_tts_tpu_torch.device_lock import device_lock
from qwen3_tts_tpu_torch.engine import configs as tcfgs
from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel, generate_audio
from qwen3_tts_tpu_torch.engine.tokenizer import ByteTokenizer
from qwen3_tts_tpu_torch.engine.weights import params_from_numpy
from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig
from qwen3_tts_tpu_torch.server import TTSService, make_server
from torch_port_helpers import one_torch_thread, tame_codec, tiny_f32

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
PCM_LSB = 2  # int16 PCM tolerance: float32 summation order in the codec
TIMEOUT = 30  # every urllib call, queue wait and join
TEXT = "Hello there, general."


# -- time stretch and generate_audio's speed ----------------------------------

def _tone(freq, sr, seconds):
    t = np.arange(int(sr * seconds)) / sr
    return np.sin(2 * np.pi * freq * t).astype(np.float32)


@pytest.mark.parametrize("rate,seconds", [
    (0.8, 0.5), (1.3, 0.5), (1.5, 0.3), (1.3, 0.01), (0.8, 0.01)],
    ids=["slow", "fast", "faster", "sub_frame_fast", "sub_frame_slow"])
def test_time_stretch_is_bit_equal_to_jax(rate, seconds):
    rng = np.random.default_rng(0)
    x = _tone(220.0, 24_000, seconds) + 0.1 * rng.standard_normal(
        int(24_000 * seconds)).astype(np.float32)
    got = time_stretch(x, rate, 24_000)
    want = jax_time_stretch(x, rate, 24_000)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="speed rate"):
        time_stretch(x, 0.0, 24_000)


def _tame_pair():
    """(JAX model, port model) on one tiny float32 numpy tree, greedy."""
    jc, tc = tiny_f32(jcfgs), tiny_f32(tcfgs)
    trees = (init_talker(jc, 0), init_code_predictor(jc, 1),
             tame_codec(init_codec(jc, 2)))
    jmodel = JaxModel(cfg=jc, params=trees[0], cp_params=trees[1],
                      codec_params=trees[2], tokenizer=JaxByteTokenizer(),
                      sampling=JaxSampling(greedy=True))
    params, cp_params, codec_params = params_from_numpy(*trees, device="cpu")
    tmodel = Qwen3TTSModel(cfg=tc, params=params, cp_params=cp_params,
                           codec_params=codec_params, tokenizer=ByteTokenizer(),
                           device=torch.device("cpu"),
                           sampling=SamplingConfig(greedy=True))
    return jmodel, tmodel


def _read_pcm(path):
    with wave.open(path, "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(
            np.int32)


def test_generate_audio_speed_matches_jax_and_emits_its_metrics_line(
        temp_dir, monkeypatch, capsys):
    """speed=1.3 on a model without native speed: the whole signal is
    stretched on the host, as in the JAX package (WAVs within 2 LSB), and
    QWEN3_TTS_METRICS=1 prints the generate_audio metrics line."""
    jmodel, tmodel = _tame_pair()
    monkeypatch.setenv("QWEN3_TTS_METRICS", "1")
    pcm, metrics = {}, {}
    for name, model, run in (("jax", jmodel, jax_generate_audio),
                             ("torch", tmodel, generate_audio)):
        out = os.path.join(temp_dir, name)
        capsys.readouterr()
        metrics[name] = run(model=model, text=TEXT, voice="ryan",
                            output_path=out, max_frames=8, speed=1.3)
        line = capsys.readouterr().err.strip().splitlines()[-1]
        event = json.loads(line)
        assert event["event"] == "generate_audio" and event["mode"] == "custom"
        assert event["chars"] == len(TEXT)
        assert event["frames"] == metrics[name]["frames"]
        assert event["audio_s"] == round(metrics[name]["audio_s"], 4)
        pcm[name] = _read_pcm(os.path.join(out, "audio_000.wav"))
    assert pcm["torch"].shape == pcm["jax"].shape
    assert np.abs(pcm["torch"] - pcm["jax"]).max() <= PCM_LSB
    frames = metrics["torch"]["frames"]
    assert abs(len(pcm["torch"]) - frames * 2000 / 1.3) < 0.1 * frames * 2000
    monkeypatch.setenv("QWEN3_TTS_METRICS", "0")
    generate_audio(model=tmodel, text=TEXT, voice="ryan", output_path=temp_dir,
                   max_frames=2)
    assert capsys.readouterr().err == ""


# -- profiling ----------------------------------------------------------------

class _NoEnviron(dict):
    """An ``os.environ`` that fails every read."""

    def _fail(self, *args, **kwargs):
        raise AssertionError("the environment was read")

    __getitem__ = __contains__ = get = _fail


def test_trace_without_a_profiler_is_one_shared_no_op(monkeypatch):
    """With no profiler recording, a span makes no RecordFunction, reads
    no environment variable and is the same shared object every time."""
    def no_record_function(*args, **kwargs):
        raise AssertionError("a RecordFunction was made")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", no_record_function)
    with monkeypatch.context() as m:
        m.setattr(os, "environ", _NoEnviron())
        first = profiling.trace("qwen3_tts.engine.dispatch")
        with first:
            with profiling.trace("qwen3_tts.model.talker") as inner:
                assert inner is None
        second = profiling.trace("qwen3_tts.model.attention")
    assert first is second


def test_a_span_under_the_profiler_is_a_host_op_of_no_user_scope():
    """Under the profiler a span is recorded as a host operation that is
    no user annotation (a ``record_function`` range is one, and leaves a
    shadow on the device's timeline), around the work inside it; once the
    profiler stops, spans are the no-op again."""
    with torch.autograd.profiler.profile(use_kineto=True) as prof:
        with profiling.trace("qwen3_tts.test.span"):
            torch.ones(8).sum()
        with torch.profiler.record_function("user_scope"):
            pass
    events = {e.name(): e for e in prof.kineto_results.events()}
    span, user = events["qwen3_tts.test.span"], events["user_scope"]
    assert span.device_type() == torch.autograd.DeviceType.CPU
    assert not span.is_user_annotation() and user.is_user_annotation()
    s0, s1 = span.start_ns(), span.start_ns() + span.duration_ns()
    inner = [e for e in events.values() if e.name() == "aten::ones"]
    assert inner and all(s0 <= e.start_ns() <= s1 for e in inner)
    assert profiling.trace("a") is profiling.trace("b")


# -- the ASR provider registry --------------------------------------------------

@pytest.fixture
def registry(monkeypatch):
    monkeypatch.setattr(transcription, "_providers", {})
    monkeypatch.setattr(transcription, "_asr_cache", {})
    monkeypatch.delenv("QWEN3_TTS_ASR_MODEL", raising=False)
    monkeypatch.delenv("QWEN3_TTS_ASR_BACKEND", raising=False)
    return transcription


@pytest.fixture
def tiny_wav(temp_dir):
    path = os.path.join(temp_dir, "ref.wav")
    write_wav(path, np.zeros(2400, np.int16), 24_000)
    return path


def test_asr_unavailable_by_default(registry, monkeypatch, tiny_wav):
    monkeypatch.setattr(registry, "_whisper_model_dir", lambda: None)
    assert not registry.asr_available()
    assert registry.available_providers() == []
    assert registry.transcribe_wav(tiny_wav) is None
    assert registry.offer_transcribe(tiny_wav) is None


def test_registered_providers_in_order(registry, monkeypatch, tiny_wav):
    monkeypatch.setattr(registry, "_whisper_model_dir", lambda: None)
    registry.register_provider("bad", lambda p: None)
    registry.register_provider("good", lambda p: "from good")
    assert registry.asr_available()
    assert registry.transcribe_wav(tiny_wav) == "from good"
    assert registry.transcribe_wav("/nonexistent.wav") is None
    # the interactive offer: y transcribes with the first working provider
    monkeypatch.setattr(ui, "safe_line_input", lambda prompt="": "y")
    assert registry.offer_transcribe(tiny_wav) == "from good"


def test_backend_knob_picks_the_package_whisper_or_the_pipeline(
        registry, monkeypatch, tiny_wav, temp_dir):
    """Unset or ``jax``: this package's Whisper, loaded once per directory;
    ``torch``: the transformers pipeline. A failure of the package's own
    Whisper does not fall through to the pipeline."""
    model_dir = os.path.join(temp_dir, "asr")
    os.makedirs(model_dir)
    monkeypatch.setenv("QWEN3_TTS_ASR_MODEL", model_dir)
    assert registry._whisper_model_dir() == model_dir
    assert "whisper-local" in registry.available_providers()
    from qwen3_tts_tpu_torch.models import whisper

    loads, pipeline_calls = [], []

    class FakeASR:
        def __init__(self, d):
            loads.append(d)

        def transcribe_wav(self, p):
            return "own whisper"

    monkeypatch.setattr(whisper, "WhisperASR", FakeASR)
    monkeypatch.setattr(registry, "_whisper_transformers_provider",
                        lambda p: pipeline_calls.append(p) or "pipeline")
    for backend in (None, "jax"):
        if backend:
            monkeypatch.setenv("QWEN3_TTS_ASR_BACKEND", backend)
        assert registry.transcribe_wav(tiny_wav) == "own whisper"
    assert loads == [model_dir] and pipeline_calls == []
    monkeypatch.setenv("QWEN3_TTS_ASR_BACKEND", "torch")
    assert registry.transcribe_wav(tiny_wav) == "pipeline"
    assert pipeline_calls == [tiny_wav]

    class BrokenASR(FakeASR):
        def transcribe_wav(self, p):
            raise RuntimeError("no card")

    monkeypatch.setattr(whisper, "WhisperASR", BrokenASR)
    monkeypatch.setattr(registry, "_asr_cache", {})
    monkeypatch.delenv("QWEN3_TTS_ASR_BACKEND")
    assert registry.transcribe_wav(tiny_wav) is None
    assert pipeline_calls == [tiny_wav]


# -- the decode-quality harness ----------------------------------------------

def test_quality_numpy_functions_equal_jax():
    pairs = [("the cat sat", "the cat sat"), ("the cat sat", "a cat sat on"),
             ("", ""), ("", "x"), ("One two three four", "one too three")]
    for ref, hyp in pairs:
        assert quality.wer(ref, hyp) == jquality.wer(ref, hyp)
    rng = np.random.default_rng(0)
    sr = 24_000
    a = (rng.standard_normal(6000) * 8000).astype(np.int16)
    b = a.copy()
    b[4000:] = (rng.standard_normal(2000) * 8000).astype(np.int16)
    tone = (_tone(440.0, sr, 0.3) * 20000).astype(np.int16)
    for x, y in ((a, b), (a, a), (a, b[:3000]), (tone, a), (a[:0], a[:0])):
        assert quality.divergence_frac(x, y) == jquality.divergence_frac(x, y)
        assert quality.mel_dtw_dist(x, y, sr) == jquality.mel_dtw_dist(x, y, sr)
    for x in (a, tone, tone.astype(np.float32) / 32768):
        np.testing.assert_array_equal(quality.log_mel(x, sr),
                                      jquality.log_mel(x, sr))
    for spec in ("fps=2", "fps=3+dg=5", "kv=int8", "depth_group=15",
                 "fps=2+cpb=1", "mtp_cp_batch=0", "dg=5+spec=1"):
        assert quality.parse_variant(spec) == jquality.parse_variant(spec)
    for spec, err in (("foo=1", "unknown variant key"),
                      ("fps", "expected key=value"), ("kv=fp8", "int8 or dense"),
                      ("", "empty variant")):
        with pytest.raises(ValueError, match=err):
            quality.parse_variant(spec)


@pytest.fixture(scope="module")
def tiny_model():
    return Qwen3TTSModel.synthetic(tcfgs.tiny("custom"), seed=4, device="cpu")


def test_compare_decode_configs_kv_int8(tiny_model):
    calls = []

    def fake_asr(path):
        assert os.path.exists(path)
        calls.append(path)
        return "hello there"

    rep = quality.compare_decode_configs(
        tiny_model, {"kv8": {"kv": "int8"}, "same": {"kv": "dense"}},
        ["hello there", "another line"], fake_asr, max_frames=6)
    assert rep["baseline"] == {"fps": 1, "dg": 1}
    assert len(calls) == 6  # 2 texts x (baseline + 2 variants)
    assert not any(os.path.exists(p) for p in calls)  # temp WAVs removed
    for name, v in rep["variants"].items():
        assert not v["protocol_changing"]
        assert v["median_wer_delta"] == 0.0
        assert 0.0 <= v["median_identical_frac"] <= 1.0
        assert np.isfinite(v["median_mel_dist"]) and v["median_mel_dist"] >= 0
        for r in v["rows"]:
            assert set(r) == {"text", "wer_baseline", "wer_variant",
                              "identical_frac", "mel_dist"}
    # the harness adds no nondeterminism: dense vs dense is bit-identical
    assert rep["variants"]["same"]["median_identical_frac"] == 1.0
    assert "QWEN3_TTS_KV" not in os.environ
    assert quality.gate_passes(rep, 0.02)
    rep["variants"]["kv8"]["median_wer_delta"] = 0.5
    assert not quality.gate_passes(rep, 0.02)
    none = quality.compare_decode_configs(
        tiny_model, {"kv8": {"kv": "int8"}}, ["one text"], None, max_frames=4)
    assert none["variants"]["kv8"]["median_wer_delta"] is None


@pytest.fixture(scope="module")
def tiny_mtp_model():
    return Qwen3TTSModel.synthetic(
        tcfgs.tiny_feedback(frames_per_step=2), seed=4, device="cpu")


@pytest.mark.parametrize("opts", [
    {"fps": 2}, {"fps": 2, "cpb": True}, {"dg": 3, "spec": True}],
    ids=["fps2", "fps2_cpb", "dg3_spec"])
def test_unported_decode_variants_raise_naming_item_9(tiny_mtp_model, opts):
    """Named for what it pinned while item 9 was unported: these variants
    raised. They run now on a residual_sum model that carries MTP heads
    (a view, not a copy): fps and cpb change the protocol; spec keeps the
    depth_group=1 greedy output, so its audio is the baseline's exactly.
    An fps > 1 variant of a model without MTP heads raises, as in the JAX
    package."""
    vm = quality.variant_model(tiny_mtp_model, opts)
    assert vm.params is tiny_mtp_model.params
    base = quality.variant_model(tiny_mtp_model, {"fps": 1})
    rep = quality.compare_decode_configs(base, {"v": opts}, ["text"], None,
                                         max_frames=4)
    v = rep["variants"]["v"]
    assert v["protocol_changing"]  # fps or dg differ from the baseline
    if "spec" in opts:
        assert v["median_identical_frac"] == 1.0
    with pytest.raises(ValueError, match="MTP"):
        quality.variant_model(Qwen3TTSModel.synthetic(
            tcfgs.tiny("custom"), seed=4, device="cpu"), {"fps": 2})


def test_grouped_depth_variant_runs(tiny_model):
    """dg > 1 (grouped depth prediction) is ported: a protocol-changing
    variant that decodes."""
    rep = quality.compare_decode_configs(tiny_model, {"dg3": {"dg": 3}},
                                         ["text"], None, max_frames=4)
    assert rep["variants"]["dg3"]["protocol_changing"]
    with pytest.raises(ValueError, match="frames_per_step"):
        quality.variant_model(tiny_model, {"fps": 1, "cpb": True})


# -- device lock ---------------------------------------------------------------

def _lock_env():
    # pin the lock ON regardless of the caller's shell
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                QWEN3_TTS_DEVICE_LOCK="1", QWEN3_TTS_CPU="0")


def test_device_lock_blocks_a_second_process(tmp_path):
    lock = str(tmp_path / "dev.lock")
    take = ("import sys; from qwen3_tts_tpu_torch.device_lock import "
            f"device_lock; sys.exit(0 if device_lock(wait_s=1, path={lock!r})"
            " else 3)")
    hold = subprocess.Popen(
        [sys.executable, "-c",
         "from qwen3_tts_tpu_torch.device_lock import device_lock; "
         f"assert device_lock(path={lock!r}); "
         "print('held', flush=True); import sys; sys.stdin.readline()"],
        env=_lock_env(), stdout=subprocess.PIPE, stdin=subprocess.PIPE,
        text=True)
    try:
        assert hold.stdout.readline().strip() == "held"
        t0 = time.time()
        r = subprocess.run([sys.executable, "-c", take], env=_lock_env(),
                           timeout=TIMEOUT)
        assert r.returncode == 3            # timed out while held
        assert time.time() - t0 < 20        # respected its wait budget
    finally:
        hold.communicate("\n", timeout=TIMEOUT)
    r = subprocess.run([sys.executable, "-c", take], env=_lock_env(),
                       timeout=TIMEOUT)
    assert r.returncode == 0                # free after the holder exits


def test_device_lock_skips_when_disabled_or_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("QWEN3_TTS_DEVICE_LOCK", "0")
    assert device_lock(wait_s=0, path=str(tmp_path / "x.lock"))
    monkeypatch.setenv("QWEN3_TTS_DEVICE_LOCK", "1")
    monkeypatch.setenv("QWEN3_TTS_CPU", "1")
    assert device_lock(wait_s=0, path=str(tmp_path / "missing" / "x.lock"))


# -- the voice library over HTTP, on a cloning model ---------------------------

@pytest.fixture(scope="module")
def clone_served(tmp_path_factory):
    """One tiny base-mode (cloning) service for this file, stopped at the
    end."""
    model = Qwen3TTSModel.synthetic(tcfgs.tiny("base"), seed=5, device="cpu")
    service = TTSService(model, max_streams=2,
                         sampling=SamplingConfig(greedy=True),
                         voices_dir=str(tmp_path_factory.mktemp("voices")))
    service.engine.chunk = 4
    service.start()
    srv = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", service
    srv.shutdown()
    service.stop(timeout=TIMEOUT)
    thread.join(TIMEOUT)
    assert not service._thread.is_alive() and not thread.is_alive()


def _request(base, path, body=None, method=None):
    req = urllib.request.Request(
        base + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method=method)
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return r.status, dict(r.headers), r.read()


def _ref_wav_b64(temp_dir, seconds=0.4, sr=16_000):
    """A short sine at 16 kHz (enrollment must resample to 24 kHz)."""
    t = np.arange(int(seconds * sr)) / sr
    path = os.path.join(temp_dir, "ref16k.wav")
    write_wav(path, (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), sr)
    return base64.b64encode(open(path, "rb").read()).decode()


def test_voice_library_http_lifecycle(clone_served, temp_dir):
    base, service = clone_served
    b64 = _ref_wav_b64(temp_dir)
    body = {"name": "My Voice!", "audio_b64": b64, "transcript": "hello there"}
    _, _, data = _request(base, "/v1/voices", body)
    assert json.loads(data)["enrolled"] == "My_Voice"
    with pytest.raises(urllib.error.HTTPError) as e:
        _request(base, "/v1/voices", body)
    assert e.value.code == 409
    _request(base, "/v1/voices", dict(body, transcript="hello again",
                                      overwrite=True))
    _, _, data = _request(base, "/v1/voices")
    assert json.loads(data)["voices"] == [
        {"name": "My_Voice", "transcript": "hello again"}]
    with wave.open(os.path.join(service.voices_dir, "My_Voice.wav")) as w:
        assert (w.getframerate(), w.getnchannels()) == (24_000, 1)
    status, headers, data = _request(
        base, "/v1/synthesize",
        {"text": "cloned hello", "saved_voice": "My Voice!", "max_seconds": 1})
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    assert len(data) > 44
    # OpenAI's voice names a saved library voice on a cloning model
    status, _, data = _request(base, "/v1/audio/speech",
                               {"input": "clone via openai", "voice": "My_Voice"})
    assert status == 200 and len(data) > 44
    for path, req in (("/v1/synthesize", {"text": "x", "saved_voice": "ghost"}),
                      ("/v1/audio/speech", {"input": "x", "voice": "ghost"})):
        with pytest.raises(urllib.error.HTTPError) as e:
            _request(base, path, req)
        assert e.value.code == 404
    _request(base, "/v1/voices/My_Voice", method="DELETE")
    _, _, data = _request(base, "/v1/voices")
    assert json.loads(data)["voices"] == []
    with pytest.raises(urllib.error.HTTPError) as e:
        _request(base, "/v1/voices/My_Voice", method="DELETE")
    assert e.value.code == 404


def test_voice_names_match_jax():
    for raw in ("My Voice!", "  a/b\\c  ", "__x__y__", "Élan-2", "../up", ""):
        assert voices.sanitize_voice_name(raw) == jax_sanitize(raw)


# -- the GPU machine's packages ------------------------------------------------

BLOCKED = r"""
import importlib.abc, json, os, sys, tempfile, threading, urllib.request
BLOCK = {"jax", "jaxlib", "transformers", "safetensors", "ml_dtypes", "rich",
         "prompt_toolkit", "qwen3_tts_tpu"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, Block())
sys.path.insert(0, os.path.join(sys.argv[1], "src"))
import numpy as np
from qwen3_tts_tpu_torch import batch, quality, transcription
from qwen3_tts_tpu_torch.client import Qwen3TTSClient
from qwen3_tts_tpu_torch.engine import configs
from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
from qwen3_tts_tpu_torch.engine.fabricate import (
    whisper_config_dict, write_whisper_snapshot)
from qwen3_tts_tpu_torch.models.whisper import WhisperASR
from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig
from qwen3_tts_tpu_torch.server import TTSService, make_server
out = {}
with tempfile.TemporaryDirectory() as tmp:
    snap = write_whisper_snapshot(os.path.join(tmp, "asr"), whisper_config_dict(
        32, (2, 2), 4, 64, 8, 51_000), seed=0)
    wav = sys.argv[2]
    asr = WhisperASR(snap, device="cpu")
    out["tokens"], out["n_valid"] = (
        lambda t: (t[0].tolist(), t[1]))(asr.decode_window(np.zeros(480_000,
                                                         np.float32), max_new=8))
    out["text"] = asr.transcribe_wav(wav)
    os.environ["QWEN3_TTS_ASR_MODEL"] = snap
    os.environ["QWEN3_TTS_ASR_DEVICE"] = "cpu"
    out["provider_text"] = transcription.transcribe_wav(wav)
    model = Qwen3TTSModel.synthetic(configs.tiny("custom"), seed=5, device="cpu")
    service = TTSService(model, max_streams=2,
                         sampling=SamplingConfig(greedy=True)).start()
    srv = make_server(service, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    client = Qwen3TTSClient(f"http://127.0.0.1:{srv.server_address[1]}",
                            timeout=30)
    out["wav_bytes"] = len(client.synthesize("hi there", voice="ryan",
                                             max_seconds=1))
    out["batch"] = batch.run_batch(service, [
        {"id": "a", "text": "first one", "voice": "ryan", "max_seconds": 1}],
        os.path.join(tmp, "batch"))["ok"]
    srv.shutdown()
    service.stop(timeout=30)
    out["quality"] = quality.compare_decode_configs(
        model, {"kv8": {"kv": "int8"}}, ["hi"], transcription.transcribe_wav,
        max_frames=4)["variants"]["kv8"]["median_wer_delta"]
    # the terminal app: scripted custom and design sessions on tiny CPU
    # models, a recording console in place of the rich one
    import contextlib, types
    from qwen3_tts_tpu_torch import app, io, sessions, ui, voices
    from qwen3_tts_tpu_torch.sessions import custom, design
    class Recorder:
        lines = []
        def print(self, *objects, **kwargs):
            self.lines.append(" ".join(str(o) for o in objects))
        def status(self, *args, **kwargs):
            return contextlib.nullcontext()
    answers = ["1", "2", "2", "Hello there.", "", "a calm narrator", "Hi.", ""]
    def ask(prompt=""):
        if not answers:
            raise EOFError
        return answers.pop(0)
    os.environ["QWEN3_TTS_CPU"] = "1"
    io.BASE_OUTPUT_DIR = os.path.join(tmp, "app")
    io.AUTO_PLAY = False
    io.time = types.SimpleNamespace(sleep=lambda s: None)
    for mod in (ui, io, voices, custom, design):
        mod.console = Recorder()
    io.clear_screen = custom.clear_screen = design.clear_screen = lambda: None
    ui.safe_line_input = custom.safe_line_input = ask
    design.safe_line_input = ask
    custom.ensure_model = lambda spec: "synthetic:tiny:custom"
    design.ensure_model = lambda spec: "synthetic:tiny:design"
    sessions.run_custom_session("1")
    sessions.run_design_session("2")
    out["app_wavs"] = [f for _, _, fs in os.walk(io.BASE_OUTPUT_DIR) for f in fs]
    out["app_console"] = Recorder.lines
    out["loaded"] = sorted(n for n in BLOCK if n in sys.modules)
print(json.dumps(out))
"""


def test_surfaces_run_with_the_gpu_machines_packages_missing(temp_dir):
    """The server, client, batch, transcription, quality and Whisper
    modules, and the terminal app's io, voices, sessions and app, with
    jax, transformers, safetensors, ml_dtypes, rich and prompt_toolkit
    blocked: a tiny request, a batch item, a quality step, a tiny
    transcription, whose tokens and text equal the JAX package's Whisper
    on the same snapshot, and scripted custom and design sessions that
    save one WAV each with no error line on their console."""
    import jax.numpy as jnp

    from qwen3_tts_tpu.models import whisper as jw
    from qwen3_tts_tpu_torch.engine.fabricate import (
        whisper_config_dict, write_whisper_snapshot)

    rng = np.random.default_rng(2)
    wav = os.path.join(temp_dir, "speech.wav")
    write_wav(wav, (0.2 * rng.standard_normal(16_000)).astype(np.float32),
              16_000)
    proc = subprocess.run([sys.executable, "-c", BLOCKED, str(ROOT), wav],
                          capture_output=True, text=True, timeout=240,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                               "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["loaded"] == []
    assert got["wav_bytes"] > 44 and got["batch"] == 1
    assert len(got["app_wavs"]) == 2, got["app_console"]
    assert sum("loaded" in ln for ln in got["app_console"]) == 2
    assert any(ln.startswith("Voice Design\n") for ln in got["app_console"])
    assert not [ln for ln in got["app_console"] if "[err]" in ln]
    assert got["quality"] is not None
    snap = write_whisper_snapshot(os.path.join(temp_dir, "asr"),
                                  whisper_config_dict(32, (2, 2), 4, 64, 8,
                                                      51_000), seed=0)
    jasr = jw.WhisperASR(snap)
    toks, n = jw.greedy_decode(
        jasr.params, jasr.cfg,
        jw.log_mel_spectrogram(jnp.zeros(480_000, jnp.float32), jasr.cfg.n_mels),
        jnp.asarray(jasr.prefix), max_new=8)
    assert got["tokens"] == np.asarray(toks).tolist() and got["n_valid"] == int(n)
    assert got["text"] == got["provider_text"] == jasr.transcribe_wav(wav)
