"""The port's HTTP daemon (qwen3_tts_tpu_torch.server), its client and
the batch CLI: the in-scope cases of tests/test_server.py,
tests/test_client.py and tests/test_batch.py, on one tiny float32 greedy
service over a real ThreadingHTTPServer on loopback, plus the parity of
its WAV with the JAX package's TTSService on the same numpy tree."""

import dataclasses
import io
import json
import os
import queue
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from qwen3_tts_tpu.engine import configs as jcfgs
from qwen3_tts_tpu.engine.api import Qwen3TTSModel as JaxModel
from qwen3_tts_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from qwen3_tts_tpu.models.code_predictor import init_code_predictor
from qwen3_tts_tpu.models.codec import init_codec
from qwen3_tts_tpu.models.talker import init_talker
from qwen3_tts_tpu.runtime.sampling import SamplingConfig as JaxSampling
from qwen3_tts_tpu.server import TTSService as JaxService
from qwen3_tts_tpu_torch import batch
from qwen3_tts_tpu_torch.client import ClientError, Qwen3TTSClient
from qwen3_tts_tpu_torch.engine import configs as tcfgs
from qwen3_tts_tpu_torch.engine.api import (
    _SEGMENT_GAP_S,
    Qwen3TTSModel,
    _split_segments,
)
from qwen3_tts_tpu_torch.engine.tokenizer import ByteTokenizer
from qwen3_tts_tpu_torch.engine.weights import params_from_numpy
from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig
from qwen3_tts_tpu_torch.server import (
    TTSService,
    build_model,
    make_server,
    wav_stream_header,
)
from torch_port_helpers import one_torch_thread, tame_codec, tiny_f32

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PCM_LSB = 2   # int16 PCM tolerance: float32 summation order in the codec
TIMEOUT = 30  # every urllib call, queue wait and join
LONG = "A long first sentence. " * 30 + "The second segment begins."


def _trees():
    jc = tiny_f32(jcfgs)
    return jc, (init_talker(jc, 0), init_code_predictor(jc, 1),
                tame_codec(init_codec(jc, 2)))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The file's one service: a tiny float32 greedy model on the JAX
    package's numpy tree, chunk 4, on an ephemeral port; stopped at the
    end, its threads joined."""
    _, trees = _trees()
    params, cp_params, codec_params = params_from_numpy(*trees, device="cpu")
    model = Qwen3TTSModel(cfg=tiny_f32(tcfgs), params=params,
                          cp_params=cp_params, codec_params=codec_params,
                          tokenizer=ByteTokenizer(), device=torch.device("cpu"))
    service = TTSService(model, max_streams=2,
                         sampling=SamplingConfig(greedy=True),
                         voices_dir=str(tmp_path_factory.mktemp("voices")))
    service.engine.chunk = 4
    service.start()
    srv = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    yield base, service, Qwen3TTSClient(base, timeout=TIMEOUT)
    srv.shutdown()
    service.stop(timeout=TIMEOUT)
    thread.join(TIMEOUT)
    assert not service._thread.is_alive() and not thread.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return r.status, json.loads(r.read())


def _post(base, payload, path="/v1/synthesize"):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return r.status, dict(r.headers), r.read()


def _parse_wav(data: bytes) -> tuple[np.ndarray, int]:
    with wave.open(io.BytesIO(data)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16), \
            w.getframerate()


def _drain(job) -> tuple[str, object, list]:
    """A job's chunks and its final (kind, payload)."""
    chunks = []
    while True:
        kind, payload = job.out.get(timeout=TIMEOUT)
        if kind != "chunk":
            return kind, payload, chunks
        chunks.append(payload)


def _wait_for(cond, what: str) -> None:
    deadline = time.monotonic() + TIMEOUT
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


# -- the JAX package's daemon --------------------------------------------------

def test_wav_matches_the_jax_tts_service(served):
    """Same numpy tree, same requests (one segment, then two), greedy:
    the port's daemon returns the JAX TTSService's PCM within 2 LSB."""
    base, service, _ = served
    jc, trees = _trees()
    jmodel = JaxModel(cfg=jc, params=trees[0], cp_params=trees[1],
                      codec_params=trees[2], tokenizer=JaxByteTokenizer())
    jservice = JaxService(jmodel, max_streams=2,
                          sampling=JaxSampling(greedy=True))
    jservice.engine.chunk = 4
    jservice.start()
    try:
        for text, max_frames, segments in (("Hello there, general.", 10, 1),
                                           (LONG, 5, 2)):
            assert len(_split_segments(text)) == segments
            req = {"text": text, "voice": "ryan", "max_frames": max_frames}
            kind, _, chunks = _drain(jservice.submit(**req))
            assert kind == "done"
            want = np.concatenate(chunks).astype(np.int32)
            _, _, data = _post(base, req)
            got, sr = _parse_wav(data)
            assert sr == 24_000 and got.shape == want.shape
            assert np.abs(got.astype(np.int32) - want).max() <= PCM_LSB
            assert np.abs(want).max() > 1000  # live audio
    finally:
        jservice.stop(timeout=TIMEOUT)


# -- server (tests/test_server.py) ---------------------------------------------

def test_healthz_and_models(served):
    base, service, _ = served
    status, body = _get(base + "/healthz")
    assert status == 200 and body["ok"] is True and body["max_streams"] == 2
    status, body = _get(base + "/v1/models")
    assert status == 200 and body["sample_rate"] == 24_000
    assert body["speakers"] == sorted(service.cfg.speakers)
    assert body["native_speed"] is False


def test_synthesize_complete_and_streaming_parity(served):
    """Buffered WAV with the TTFA header; the chunked stream (44-byte
    unknown-length header, then raw PCM) carries the same PCM."""
    base, service, _ = served
    req = {"text": "stream parity check", "voice": "ryan", "max_seconds": 1}
    status, headers, data = _post(base, req)
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    assert "X-TTFA-Ms" in headers
    pcm, sr = _parse_wav(data)
    assert sr == 24_000 and len(pcm) > 0
    _, headers, streamed = _post(base, dict(req, stream=True))
    assert headers["Transfer-Encoding"] == "chunked"
    header = wav_stream_header(24_000)
    assert streamed[:len(header)] == header
    np.testing.assert_array_equal(np.frombuffer(streamed[44:], np.int16), pcm)
    assert len(service.engine.streams) == 0  # finished streams are dropped


def test_multi_segment_request_and_speed(served):
    """Two segments joined by the generate_audio gap; speed 1.25 streams
    segment by segment, stretched with a scaled gap."""
    base, service, _ = served
    _, _, data = _post(base, {"text": LONG, "voice": "ryan", "max_frames": 5})
    pcm, _ = _parse_wav(data)
    gap = int(_SEGMENT_GAP_S * 24_000)
    assert len(pcm) == 2 * 5 * 2000 + gap
    assert not pcm[5 * 2000:5 * 2000 + gap].any()
    _, _, fast = _post(base, {"text": LONG, "voice": "ryan", "max_frames": 5,
                              "speed": 1.25, "stream": True})
    n = len(fast[44:]) // 2
    assert abs(n - len(pcm) / 1.25) < 0.1 * len(pcm)


def test_bad_requests(served):
    base, _, _ = served
    _, before = _get(base + "/healthz")
    for payload in ({"text": ""}, {"text": "hi", "speed": 99.0},
                    {"voice": "x"}, {"text": "hi", "voice": "no-such-voice"},
                    {"text": "hi", "max_frames": "twenty"}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, payload)
        assert e.value.code == 400, payload
    status, body = _get(base + "/healthz")
    assert status == 200 and body["ok"]  # the daemon survived
    assert body["errors_total"] == before["errors_total"] + 1  # the voice
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/nope", timeout=TIMEOUT)
    assert e.value.code == 404


def test_metrics_endpoint(served):
    base, _, _ = served
    _post(base, {"text": "metrics check", "voice": "ryan", "max_seconds": 1})
    with urllib.request.urlopen(base + "/metrics", timeout=TIMEOUT) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    metrics = {line.split()[0]: line.split()[1] for line in text.splitlines()
               if line and not line.startswith("#") and "{" not in line}
    assert int(metrics["qwen3_tts_frames_total"]) > 0
    assert float(metrics["qwen3_tts_audio_seconds_total"]) > 0
    assert int(metrics["qwen3_tts_free_slots"]) == 2
    assert 'quantile="0.5"' in text
    assert float(metrics["qwen3_tts_ttfa_seconds_sum"]) > 0
    assert int(metrics["qwen3_tts_ttfa_seconds_count"]) >= 1


def test_intake_backpressure(served):
    """A full intake queue raises queue.Full (503 upstream); this service
    is never started."""
    _, service, _ = served
    idle = TTSService(service.model, max_streams=2, queue_size=1,
                      sampling=SamplingConfig(greedy=True))
    idle.submit(text="one")
    with pytest.raises(queue.Full):
        idle.submit(text="two")
    assert idle.rejected_total == 1 and idle._thread is None


def test_requests_queued_together_join_the_same_step(served):
    """The engine thread drains its whole intake each turn: two requests waiting
    when it starts are both submitted to the engine before its first
    step (one a turn would let the first reach the long chunks alone)."""
    _, service, _ = served
    other = TTSService(service.model, max_streams=2,
                       sampling=SamplingConfig(greedy=True))
    events = []
    submit, dispatch = other.engine.submit, other.engine.dispatch_step
    other.engine.submit = lambda *a, **k: events.append("submit") or \
        submit(*a, **k)
    other.engine.dispatch_step = lambda: events.append("step") or dispatch()
    jobs = [other.submit(text=t, voice="ryan", max_frames=4)
            for t in ("first request", "second request")]
    other.start()
    try:
        for job in jobs:
            assert _drain(job)[0] == "done"
    finally:
        other.stop(timeout=TIMEOUT)
    assert events[:3] == ["submit", "submit", "step"]


def test_engine_failure_fails_jobs_but_the_service_survives(served):
    _, service, _ = served
    real = service.engine.dispatch_step

    def exploding():
        raise RuntimeError("synthetic device blowup")

    service.engine.dispatch_step = exploding
    try:
        kind, payload, _ = _drain(service.submit(text="doomed", max_frames=8))
    finally:
        service.engine.dispatch_step = real
    assert kind == "error" and payload["code"] == 500
    assert "engine failure" in payload["message"]
    _wait_for(lambda: service.engine.free_slots() == 2, "slots not freed")
    kind, _, chunks = _drain(service.submit(text="recovery", max_frames=4))
    assert kind == "done" and chunks and service._thread.is_alive()


def test_service_cancel_frees_the_slots(served):
    """TTSService.cancel (a client disconnect) frees the job's slots."""
    _, service, _ = served
    job = service.submit(text="cancel me please", max_frames=400)
    _wait_for(lambda: job.seg_of_stream, "the job never reached the engine")
    service.cancel(job)
    _wait_for(lambda: service.engine.free_slots() == 2 and not service._active,
              "the cancelled job's slot was not freed")


def test_disconnected_stream_frees_its_slot(served):
    """A streaming client that goes away after its first chunk: the
    handler's write fails, the job is cancelled and its slot freed."""
    import http.client

    base, service, _ = served
    host, port = base.removeprefix("http://").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=TIMEOUT)
    conn.request("POST", "/v1/synthesize", json.dumps(
        {"text": "a long stream to abandon", "voice": "ryan",
         "max_frames": 400, "stream": True}),
        {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.read(64)          # the header and the first audio
    conn.sock.shutdown(2)
    conn.close()
    _wait_for(lambda: service.engine.free_slots() == 2 and not service._active,
              "the disconnected stream's slot was not freed")


# -- OpenAI /v1/audio/speech -----------------------------------------------

def test_openai_speech_wav_pcm_and_stream(served):
    base, _, _ = served
    body = {"model": "tts-1", "input": "openai surface check", "voice": "alloy"}
    status, headers, data = _post(base, body, "/v1/audio/speech")
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    pcm, _ = _parse_wav(data)
    _, headers, raw = _post(base, dict(body, response_format="pcm"),
                            "/v1/audio/speech")
    assert headers["Content-Type"] == "audio/pcm"
    np.testing.assert_array_equal(np.frombuffer(raw, np.int16), pcm)
    # a native speaker name is the same voice as its OpenAI alias slot
    _, _, native = _post(base, dict(body, voice=sorted(
        ["ryan", "aiden", "serena", "vivian"])[0]), "/v1/audio/speech")
    assert len(native) > 44
    _, _, streamed = _post(base, dict(body, voice="echo",
                                      stream_format="audio"),
                           "/v1/audio/speech")
    assert streamed[:44] == wav_stream_header(24_000) and len(streamed) > 44


def test_openai_speech_error_envelope(served):
    base, _, _ = served
    for body, needle in (({"input": "x", "voice": "alloy",
                           "response_format": "mp3"}, "mp3"),
                         ({"input": "x", "voice": "nobody-real"}, "nobody"),
                         ({"voice": "alloy"}, "input")):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, body, "/v1/audio/speech")
        assert e.value.code == 400
        err = json.loads(e.value.read())["error"]
        assert err["type"] == "invalid_request_error"
        assert needle in err["message"]


# -- client (tests/test_client.py) ---------------------------------------------

def test_client_health_models_metrics(served):
    _, service, client = served
    assert client.health()["ok"] is True
    assert client.models()["sample_rate"] == 24_000
    assert "qwen3_tts_requests_total" in client.metrics_text()


def test_client_buffered_streamed_and_reassembled(served):
    _, _, client = served
    wav = client.synthesize("client parity text", voice="ryan", max_seconds=1)
    buffered, _ = _parse_wav(wav)
    for chunk_samples in (7, 4096, 65536):  # splits across read boundaries
        streamed = np.concatenate(list(client.synthesize_stream(
            "client parity text", voice="ryan", max_seconds=1,
            chunk_samples=chunk_samples)))
        np.testing.assert_array_equal(streamed, buffered)


def test_client_openai_and_error_mapping(served):
    _, _, client = served
    with wave.open(io.BytesIO(client.speech("via client", voice="alloy"))) as w:
        assert w.getnframes() > 0
    pcm = client.speech("via client", voice="alloy", response_format="pcm",
                        max_seconds=1)
    assert len(pcm) % 2 == 0 and len(pcm) > 0
    with pytest.raises(ClientError) as e:
        client.synthesize("x", voice="nobody-here")
    assert e.value.status == 400 and "nobody-here" in e.value.message
    with pytest.raises(ClientError) as e:
        client.speech("x", voice="alloy", response_format="mp3")
    assert e.value.status == 400 and "mp3" in e.value.message


def _wav_bytes(sr=24_000, n=2400) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.sin(2 * np.pi * 220 * np.arange(n) / sr) * 8000)
                      .astype(np.int16).tobytes())
    return buf.getvalue()


def test_client_voice_library_roundtrip(served):
    _, _, client = served
    assert client.list_voices() == []
    assert client.enroll_voice("client_voice", _wav_bytes(),
                               transcript="spoken words") == "client_voice"
    assert client.list_voices() == [{"name": "client_voice",
                                     "transcript": "spoken words"}]
    with pytest.raises(ClientError) as e:
        client.enroll_voice("client_voice", _wav_bytes())
    assert e.value.status == 409
    client.enroll_voice("client_voice", _wav_bytes(), overwrite=True)
    assert client.list_voices() == [{"name": "client_voice",
                                     "transcript": None}]
    client.delete_voice("client_voice")
    assert client.list_voices() == []
    with pytest.raises(ClientError) as e:
        client.delete_voice("client_voice")
    assert e.value.status == 404


# -- batch (tests/test_batch.py) -----------------------------------------------

def test_parse_plain_text(tmp_path):
    p = tmp_path / "lines.txt"
    p.write_text("hello world\n\n# a comment\nsecond line\n")
    items = batch.parse_items(str(p), {"voice": "ryan"})
    assert [it["text"] for it in items] == ["hello world", "second line"]
    assert all(it["voice"] == "ryan" for it in items)
    assert [it["id"] for it in items] == ["000001", "000004"]


def test_parse_jsonl_defaults_and_overrides(tmp_path):
    p = tmp_path / "items.jsonl"
    p.write_text(json.dumps({"text": "a", "id": "x"}) + "\n"
                 + json.dumps({"text": "b", "voice": "serena", "speed": 1.3})
                 + "\n")
    items = batch.parse_items(str(p), {"voice": "ryan"})
    assert items[0]["voice"] == "ryan" and items[0]["id"] == "x"
    assert items[1]["voice"] == "serena" and items[1]["speed"] == 1.3


@pytest.mark.parametrize("line,err", [
    ('{"text": "a", "voics": "ryan"}', "unknown keys"),
    ('{"voice": "ryan"}', "missing/empty 'text'"),
    ('["not", "an", "object"]', "expected an object"),
    ('{bad json', "bad JSON"),
    ('{"text": "a", "id": "same"}\n{"text": "b", "id": "same"}',
     "duplicate item ids"),
], ids=["unknown_key", "no_text", "not_object", "bad_json", "duplicate_ids"])
def test_parse_jsonl_rejects_bad_rows(tmp_path, line, err):
    p = tmp_path / "bad.jsonl"
    p.write_text(line + "\n")
    with pytest.raises(ValueError, match=err):
        batch.parse_items(str(p), {})


class _FakeService:
    class cfg:
        class codec:
            frame_rate = 12

    def resolve_saved_voice(self, name):
        if name != "known":
            raise FileNotFoundError(name)
        return "/voices/known.wav", "the transcript"


def test_submit_kwargs_translation():
    kw = batch._submit_kwargs(_FakeService(), {
        "text": "t", "saved_voice": "known", "max_seconds": 2.5})
    assert kw["ref_wav_path"] == "/voices/known.wav"
    assert kw["ref_text"] == "the transcript"
    assert kw["max_frames"] == 30  # 2.5 s * 12 Hz
    kw = batch._submit_kwargs(_FakeService(), {"text": "t",
                                               "ref_audio": "/a/b.wav"})
    assert kw["ref_wav_path"] == "/a/b.wav" and kw["ref_text"] == "."


def _manifest(out_dir):
    with open(os.path.join(out_dir, "manifest.jsonl")) as fh:
        return {row["id"]: row for row in map(json.loads, fh)}


def test_run_batch_end_to_end(served, tmp_path):
    _, service, _ = served
    items = [{"id": "a", "text": "first utterance", "voice": "ryan",
              "max_seconds": 1},
             {"id": "b", "text": "second utterance", "voice": "ryan",
              "max_seconds": 1},
             {"id": "c", "text": "third one", "voice": "no-such-speaker"},
             {"id": "d", "text": "ghost", "saved_voice": "ghost"}]
    out = str(tmp_path / "out")
    summary = batch.run_batch(service, items, out)
    assert summary["items"] == 4
    assert summary["ok"] == 2 and summary["failed"] == 2
    rows = _manifest(out)
    for good in ("a", "b"):
        assert rows[good]["ok"] is True and rows[good]["seconds"] > 0
        with wave.open(os.path.join(out, rows[good]["wav"])) as w:
            assert w.getframerate() == 24_000 and w.getnframes() > 0
    assert "no-such-speaker" in rows["c"]["error"]
    assert "ghost" in rows["d"]["error"]
    assert summary["audio_seconds"] == pytest.approx(
        rows["a"]["seconds"] + rows["b"]["seconds"], abs=1e-6)


def test_run_batch_resume(served, tmp_path):
    """--resume skips ok rows (the WAV is not rewritten), survives a torn
    last manifest line, and without --resume an item runs again."""
    _, service, _ = served
    out = str(tmp_path / "out")
    os.makedirs(out)
    with open(os.path.join(out, "manifest.jsonl"), "w") as fh:
        fh.write(json.dumps({"id": "t1", "ok": True}) + "\n")
        fh.write('{"id": "t2", "ok": tr')  # crash mid-write
    items = [{"id": "t1", "text": "done already", "voice": "ryan"},
             {"id": "t2", "text": "torn row reruns", "voice": "ryan",
              "max_seconds": 1}]
    s1 = batch.run_batch(service, items, out, resume=True)
    assert s1["skipped"] == 1 and s1["ok"] == 1
    mtime = os.path.getmtime(os.path.join(out, "t2.wav"))
    s2 = batch.run_batch(service, items[1:], out, resume=True)
    assert s2["skipped"] == 1 and s2["ok"] == 0 and s2["failed"] == 0
    assert os.path.getmtime(os.path.join(out, "t2.wav")) == mtime
    s3 = batch.run_batch(service, items[1:], out)
    assert s3["ok"] == 1


@pytest.mark.parametrize("name,fps", [
    ("synthetic", 2), ("synthetic-tiny", 1), ("synthetic-tiny-code2wav", 1)])
def test_synthetic_daemon_models_and_their_frames_per_step(name, fps,
                                                           monkeypatch):
    """``--model synthetic`` is the flagship at two frames a step, as the
    JAX daemon's default (its MTP heads come with the synthetic tree); the
    tiny presets decode one frame a step. Qwen3TTSModel.synthetic is stubbed:
    the flagship is not drawn on the CPU here."""
    from qwen3_tts_tpu_torch.engine import api

    seen = []
    monkeypatch.setattr(api.Qwen3TTSModel, "synthetic", classmethod(
        lambda cls, cfg, device=None: seen.append((cfg, device)) or cfg))
    cfg = build_model(name, "design", "cpu")
    assert seen == [(cfg, "cpu")]
    assert cfg.talker.frames_per_step == fps and cfg.mode == "design"
    if name == "synthetic":
        assert cfg.talker.hidden == jcfgs.flagship().talker.hidden
        assert cfg == tcfgs.flagship("design", frames_per_step=2)


def test_clients_that_connect_at_once_all_wait_in_the_backlog():
    """Twelve clients connect while the listener accepts none (as when the
    decode thread holds the interpreter): each connect completes in the
    listen backlog; socketserver's default backlog of 5 drops the rest."""
    import socket

    srv = make_server(None, port=0)
    socks = []
    try:
        for _ in range(12):
            s = socket.create_connection(srv.server_address, timeout=2)
            socks.append(s)
    finally:
        for s in socks:
            s.close()
        srv.server_close()
    assert len(socks) == 12


def test_service_serves_feedback_protocol_model():
    """tests/test_server.py::test_service_serves_feedback_protocol_model:
    the daemon's service loop over a published-protocol model (the engine's
    residual-sum feedback step underneath) returns a finished WAV, whose
    PCM is the JAX TTSService's on the same numpy tree within PCM_LSB."""
    jc = dataclasses.replace(jcfgs.tiny_feedback("custom"), dtype="float32")
    tc = dataclasses.replace(tcfgs.tiny_feedback("custom"), dtype="float32")
    trees = (init_talker(jc, 0), init_code_predictor(jc, 1),
             tame_codec(init_codec(jc, 2)))
    params, cp_params, codec_params = params_from_numpy(*trees, device="cpu")
    model = Qwen3TTSModel(cfg=tc, params=params, cp_params=cp_params,
                          codec_params=codec_params, tokenizer=ByteTokenizer(),
                          device=torch.device("cpu"))
    jmodel = JaxModel(cfg=jc, params=trees[0], cp_params=trees[1],
                      codec_params=trees[2], tokenizer=JaxByteTokenizer())
    req = {"text": "daemon over the published protocol",
           "voice": sorted(tc.speakers)[0], "max_frames": 8}
    pcm = {}
    for name, service in (
            ("port", TTSService(model, max_streams=2,
                                sampling=SamplingConfig(greedy=True))),
            ("jax", JaxService(jmodel, max_streams=2,
                               sampling=JaxSampling(greedy=True)))):
        service.engine.chunk = 4
        service.start()
        try:
            job = service.submit(**req)
            kind, payload, chunks = _drain(job)
            assert kind == "done", (name, payload)
            assert job.frames > 0, name
            pcm[name] = np.concatenate(chunks).astype(np.int32)
        finally:
            service.stop(timeout=TIMEOUT)
    assert pcm["port"].shape == pcm["jax"].shape
    assert np.abs(pcm["port"] - pcm["jax"]).max() <= PCM_LSB
    assert np.abs(pcm["jax"]).max() > 1000  # live audio
