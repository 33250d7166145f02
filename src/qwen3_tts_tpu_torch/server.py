"""HTTP serving daemon: a long-lived process that keeps one
continuous-batching engine (``runtime/serving.py::ServingEngine``) hot on
the card and serves concurrent synthesis requests over plain HTTP, with
optional chunked audio streaming (the JAX package's server.py).

Threading model:

- a single **engine thread** issues ALL device work: prompt prefills,
  decode steps (pipelined ``_PIPELINE_DEPTH`` deep, as
  ``ServingEngine.run`` does) and the encoding of cloning references. It
  waits for each step's host copy itself (``ServingEngine.collect_step``),
  so what reaches a job's queue is host numpy PCM;
- HTTP handler threads (stdlib ``ThreadingHTTPServer``) touch only numpy
  and queues: parse the request, enqueue a job, then block on that job's
  chunk queue;
- backpressure: the intake queue is bounded; a full queue returns 503
  instead of stacking unbounded work behind the device.

Endpoints:

- ``GET /healthz``       -> liveness + slot/queue occupancy JSON
- ``GET /v1/models``     -> model name + config summary
- ``GET /metrics``       -> Prometheus text exposition (counters, gauges,
  rolling TTFA quantile summary)
- ``GET /v1/voices``     -> the voice library (``voices.py`` wav/txt pairs)
- ``POST /v1/voices``    -> enroll ``{name, audio_b64, transcript?}``
  (409 on existing names unless ``overwrite``)
- ``DELETE /v1/voices/<name>``
- ``POST /v1/synthesize``-> ``audio/wav`` bytes. The JSON body mirrors
  ``engine.api.generate_audio``: ``text``, ``voice``, ``instruct``,
  ``speed``, ``ref_audio`` (server-local path) or ``ref_audio_b64``
  (base64 WAV bytes) or ``saved_voice`` (a library name), ``ref_text``,
  ``max_seconds``, ``stream`` (chunked transfer of audio as it decodes).
- ``POST /v1/audio/speech`` -> the OpenAI-compatible text-to-speech surface
  (``input``, ``voice``, ``instructions``, ``speed``, ``response_format``
  wav|pcm, ``stream_format`` audio). The OpenAI voice names (alloy, echo,
  ...) map deterministically onto the model's speakers; on a cloning-mode
  model ``voice`` names a saved library voice.

Run it with ``python -m qwen3_tts_tpu_torch.server``: on the CUDA device,
or on the CPU with QWEN3_TTS_CPU=1.
"""

from __future__ import annotations

import base64
import io
import json
import os
import queue
import struct
import tempfile
import threading
import time
import wave
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np
import torch

_PIPELINE_DEPTH = 2  # steps in flight, as ServingEngine.run's default


# --------------------------------------------------------------------------
# jobs
# --------------------------------------------------------------------------

@dataclass(eq=False)  # identity semantics: jobs are tracked in sets/maps
class _Job:
    """One synthesis request moving through the engine thread."""

    text: str
    voice: str | None
    instruct: str | None
    speed: float
    ref_wav_path: str | None
    ref_text: str | None
    max_frames: int | None
    stream: bool
    # segment bookkeeping (filled by the engine thread)
    prompts: list = field(default_factory=list)
    budgets: list = field(default_factory=list)
    next_seg: int = 0                   # next segment to submit
    seg_of_stream: dict = field(default_factory=dict)   # stream_id -> seg
    seg_chunks: dict = field(default_factory=dict)      # seg -> [np.int16]
    seg_done: set = field(default_factory=set)
    cur_seg: int = 0                    # next segment to EMIT (in order)
    live: bool = True                   # chunk-level streaming allowed
    # output: (kind, payload) tuples; kind in {"chunk", "done", "error"}
    out: queue.Queue = field(default_factory=queue.Queue)
    submitted_at: float = field(default_factory=time.perf_counter)
    ttfa_s: float | None = None
    frames: int = 0
    error: str | None = None
    cancelled: bool = False
    samples: int = 0                    # PCM samples actually emitted

    def emit(self, kind: str, payload: Any = None) -> None:
        if kind == "chunk":
            self.samples += len(payload)
        self.out.put((kind, payload))


# --------------------------------------------------------------------------
# the service (engine + the thread that drives it)
# --------------------------------------------------------------------------

class TTSService:
    """Owns one ServingEngine and the single thread that drives it."""

    def __init__(
        self,
        model,
        *,
        max_streams: int = 8,
        sampling=None,
        queue_size: int = 64,
        voices_dir: str | None = None,
    ):
        from . import config
        from .runtime.serving import ServingEngine

        self.model = model
        self.cfg = model.cfg
        self.voices_dir = voices_dir or config.VOICES_DIR
        if sampling is not None:
            self.engine = ServingEngine(
                model, max_streams=max_streams, sampling=sampling
            )
        else:
            self.engine = model.serving_engine(max_streams)
        self._intake: queue.Queue[_Job] = queue.Queue(
            maxsize=max(1, queue_size)
        )
        self._jobs: list[_Job] = []        # jobs with unsubmitted segments
        self._active: dict[int, _Job] = {}  # stream_id -> job
        self._cancels: queue.Queue[_Job] = queue.Queue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()      # guards the counters below
        self.requests_total = 0
        self.errors_total = 0
        self.rejected_total = 0
        self.frames_total = 0
        self.audio_seconds_total = 0.0
        self.ttfa_seconds_sum = 0.0           # cumulative (summary _sum)
        self.ttfa_count = 0                   # cumulative (summary _count)
        self._recent_ttfa: list[float] = []   # last N (quantile window)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "TTSService":
        self._thread = threading.Thread(
            target=self._drive, name="tts-engine", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    # -- intake (HTTP handler threads) --------------------------------------

    def submit(self, **kwargs) -> _Job:
        """Validate + enqueue one request; raises queue.Full on overload and
        ValueError on bad parameters (mapped to 503/400 by the handler)."""
        max_frames = kwargs.get("max_frames")
        if max_frames is not None:
            max_frames = int(max_frames)   # reject non-numeric JSON here
            if max_frames < 1:
                raise ValueError(f"max_frames {max_frames} must be >= 1")
        job = _Job(
            text=str(kwargs["text"]),
            voice=kwargs.get("voice"),
            instruct=kwargs.get("instruct"),
            speed=float(kwargs.get("speed", 1.0)),
            ref_wav_path=kwargs.get("ref_wav_path"),
            ref_text=kwargs.get("ref_text"),
            max_frames=max_frames,
            stream=bool(kwargs.get("stream", False)),
        )
        if not job.text.strip():
            raise ValueError("empty text")
        if not (0.25 <= job.speed <= 4.0):
            raise ValueError(f"speed {job.speed} out of range [0.25, 4]")
        # chunk-level streaming needs the model to natively honor the speed
        # tag; otherwise WSOLA (host, whole-signal) runs per SEGMENT, so the
        # response still streams but segment-at-a-time (engine.api speed
        # contract)
        job.live = self.cfg.native_speed or abs(job.speed - 1.0) < 1e-3
        try:
            self._intake.put_nowait(job)  # queue.Full -> 503 upstream
        except queue.Full:
            with self._lock:
                self.rejected_total += 1
            raise
        with self._lock:
            self.requests_total += 1
        return job

    def cancel(self, job: _Job) -> None:
        """Abort a job (e.g. the HTTP client disconnected mid-stream): its
        engine streams are cancelled on the engine thread so the slots stop
        burning decode compute on discarded audio."""
        job.cancelled = True
        self._cancels.put(job)

    def stats(self) -> dict:
        eng = self.engine
        with self._lock:
            reqs, errs, rej = (
                self.requests_total, self.errors_total, self.rejected_total
            )
        return {
            "ok": True,
            "model": self.model.name,
            "max_streams": eng.B,
            "free_slots": eng.free_slots(),
            "queue_depth": self._intake.qsize(),
            "requests_total": reqs,
            "errors_total": errs,
            "rejected_total": rej,
        }

    # -- voice library (HTTP face of voices.py's wav/txt pairs) -------------

    def _voice_paths(self, raw_name: str) -> tuple[str, str, str]:
        """(name, wav_path, txt_path); raises ValueError on empty names.
        Names are sanitized with the same rule as the terminal app
        (voices.sanitize_voice_name), which also confines them to the
        voices dir — no separators survive."""
        from .voices import sanitize_voice_name

        name = sanitize_voice_name(raw_name)
        if not name:
            raise ValueError(f"invalid voice name {raw_name!r}")
        return (
            name,
            os.path.join(self.voices_dir, f"{name}.wav"),
            os.path.join(self.voices_dir, f"{name}.txt"),
        )

    def list_voices(self) -> list[dict]:
        if not os.path.isdir(self.voices_dir):
            return []
        out = []
        for f in sorted(os.listdir(self.voices_dir)):
            if not f.lower().endswith(".wav") or f.startswith("."):
                continue
            name = os.path.splitext(f)[0]
            txt = os.path.join(self.voices_dir, f"{name}.txt")
            transcript = None
            if os.path.exists(txt):
                with open(txt, encoding="utf-8", errors="replace") as fh:
                    transcript = fh.read().strip() or None
            out.append({"name": name, "transcript": transcript})
        return out

    def enroll_voice(
        self,
        raw_name: str,
        wav_bytes_in: bytes,
        transcript: str | None = None,
        *,
        overwrite: bool = False,
    ) -> str:
        """Convert + store one reference sample as a library voice (24 kHz
        mono — the same normalization the terminal enroll flow applies).
        Raises FileExistsError when the name is taken and not overwriting."""
        from .audio import read_wav, resample, write_wav
        from .audio.wavio import to_mono

        name, wav_path, txt_path = self._voice_paths(raw_name)
        if os.path.exists(wav_path) and not overwrite:
            raise FileExistsError(name)
        fd, tmp = tempfile.mkstemp(suffix=".wav")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(wav_bytes_in)
            data, rate = read_wav(tmp)
        finally:
            os.unlink(tmp)
        sr = self.cfg.codec.sample_rate
        wav = resample(to_mono(data), rate, sr)
        os.makedirs(self.voices_dir, exist_ok=True)
        write_wav(wav_path, wav, sr)
        if transcript:
            with open(txt_path, "w", encoding="utf-8") as fh:
                fh.write(transcript.strip() + "\n")
        elif os.path.exists(txt_path):
            os.unlink(txt_path)  # overwrite without transcript clears it
        return name

    def delete_voice(self, raw_name: str) -> None:
        name, wav_path, txt_path = self._voice_paths(raw_name)
        if not os.path.exists(wav_path):
            raise FileNotFoundError(name)
        os.unlink(wav_path)
        if os.path.exists(txt_path):
            os.unlink(txt_path)

    def resolve_saved_voice(self, raw_name: str) -> tuple[str, str | None]:
        """(wav_path, transcript) for a library voice; FileNotFoundError
        when absent."""
        name, wav_path, txt_path = self._voice_paths(raw_name)
        if not os.path.exists(wav_path):
            raise FileNotFoundError(name)
        transcript = None
        if os.path.exists(txt_path):
            with open(txt_path, encoding="utf-8", errors="replace") as fh:
                transcript = fh.read().strip() or None
        return wav_path, transcript

    # -- OpenAI-compatible request translation ------------------------------

    # The 11 built-in OpenAI voice names, mapped round-robin onto the
    # model's (sorted) speaker set so stock SDK clients work unchanged.
    OPENAI_VOICES = (
        "alloy", "ash", "ballad", "coral", "echo", "fable",
        "nova", "onyx", "sage", "shimmer", "verse",
    )

    def openai_to_submit(self, req: dict) -> tuple[dict, str]:
        """Translate an OpenAI ``/v1/audio/speech`` body into ``submit``
        kwargs. Returns (kwargs, response_format). Raises ValueError/
        KeyError for bad requests (mapped to 400 upstream) and
        FileNotFoundError for a missing saved voice on clone models."""
        fmt = str(req.get("response_format", "wav")).lower()
        if fmt not in ("wav", "pcm"):
            raise ValueError(
                f"response_format {fmt!r} not supported (no audio codec "
                "toolchain on this host); use 'wav' or 'pcm'"
            )
        kwargs: dict = {
            "text": req["input"],
            "speed": float(req.get("speed", 1.0)),
            "stream": (
                str(req.get("stream_format", "")).lower() == "audio"
                or bool(req.get("stream", False))
            ),
        }
        if req.get("instructions"):
            kwargs["instruct"] = str(req["instructions"])
        voice = req.get("voice")
        if self.cfg.mode == "base":
            # cloning model: `voice` names a saved library voice
            if not voice:
                raise ValueError("cloning models need 'voice' = a saved "
                                 "library voice name")
            wav_path, transcript = self.resolve_saved_voice(str(voice))
            kwargs["ref_wav_path"] = wav_path
            kwargs["ref_text"] = transcript or "."
        elif self.cfg.mode == "custom":
            speakers = sorted(self.cfg.speakers)
            name = str(voice or speakers[0]).lower()
            if name in self.cfg.speakers:
                kwargs["voice"] = name
            elif name in self.OPENAI_VOICES:
                idx = self.OPENAI_VOICES.index(name)
                kwargs["voice"] = speakers[idx % len(speakers)]
            else:
                raise ValueError(
                    f"unknown voice {voice!r}; valid: {speakers} or "
                    f"OpenAI aliases {list(self.OPENAI_VOICES)}"
                )
        # design mode: conditioning comes from `instructions` alone
        return kwargs, fmt

    def prometheus_metrics(self) -> str:
        """Prometheus text exposition (0.0.4) for GET /metrics."""
        eng = self.engine
        with self._lock:
            ttfa = sorted(self._recent_ttfa)
            ttfa_sum, ttfa_count = self.ttfa_seconds_sum, self.ttfa_count
            lines = [
                ("qwen3_tts_requests_total", "counter", self.requests_total),
                ("qwen3_tts_errors_total", "counter", self.errors_total),
                ("qwen3_tts_rejected_total", "counter", self.rejected_total),
                ("qwen3_tts_frames_total", "counter", self.frames_total),
                ("qwen3_tts_audio_seconds_total", "counter",
                 self.audio_seconds_total),
                ("qwen3_tts_free_slots", "gauge", eng.free_slots()),
                ("qwen3_tts_max_streams", "gauge", eng.B),
                ("qwen3_tts_queue_depth", "gauge", self._intake.qsize()),
            ]
        out = []
        for name, kind, value in lines:
            out.append(f"# TYPE {name} {kind}")
            out.append(f"{name} {value}")
        if ttfa:
            # quantiles over a rolling window; _sum/_count cumulative (the
            # summary-type contract: rate(sum)/rate(count) = average TTFA)
            out.append("# TYPE qwen3_tts_ttfa_seconds summary")
            for q in (0.5, 0.9, 0.99):
                v = ttfa[min(len(ttfa) - 1, int(q * len(ttfa)))]
                out.append(
                    f'qwen3_tts_ttfa_seconds{{quantile="{q}"}} {v:.4f}'
                )
            out.append(f"qwen3_tts_ttfa_seconds_sum {ttfa_sum:.4f}")
            out.append(f"qwen3_tts_ttfa_seconds_count {ttfa_count}")
        return "\n".join(out) + "\n"

    # -- engine thread ------------------------------------------------------

    def _prepare(self, job: _Job) -> None:
        """Segment + tokenize + (for cloning) encode the reference sample —
        the same frontend generate_audio uses (engine.api.prepare_segments).
        Device work — engine thread only."""
        from .engine.api import prepare_segments

        job.prompts, job.budgets = prepare_segments(
            self.model, job.text,
            voice=job.voice, instruct=job.instruct, speed=job.speed,
            ref_audio=job.ref_wav_path, ref_text=job.ref_text,
            max_frames=job.max_frames,
        )

    def _admit(self) -> None:
        """Submit waiting segments into free slots, oldest job first. A
        submission failure fails THAT job only — other jobs keep serving."""
        for job in list(self._jobs):
            try:
                while (
                    job.next_seg < len(job.prompts)
                    and self.engine.free_slots()
                ):
                    seg = job.next_seg
                    sid = self.engine.submit(
                        job.prompts[seg],
                        max_frames=job.budgets[seg],
                        on_chunk=self._chunk_cb(job, seg),
                    )
                    job.seg_of_stream[sid] = seg
                    job.seg_chunks[seg] = []
                    self._active[sid] = job
                    job.next_seg += 1
            except Exception as e:
                self._jobs.remove(job)
                self._cancel_job_streams(job)
                self._fail_job(job, f"{type(e).__name__}: {e}", code=500)
                continue
            if job.next_seg >= len(job.prompts):
                self._jobs.remove(job)

    def _chunk_cb(self, job: _Job, seg: int):
        def cb(chunk: np.ndarray) -> None:
            if job.ttfa_s is None and seg == 0:
                job.ttfa_s = time.perf_counter() - job.submitted_at
            if job.stream and job.live and seg == job.cur_seg:
                job.emit("chunk", chunk)
            else:
                job.seg_chunks[seg].append(chunk)

        return cb

    def _gap(self, job: _Job) -> np.ndarray:
        """Inter-segment silence. When WSOLA speed-stretching runs per
        segment (non-native-speed models), the gap is scaled by the same
        factor so the joined output matches generate_audio's whole-signal
        stretch (engine.api speed contract)."""
        from .engine.api import _SEGMENT_GAP_S

        sr = self.cfg.codec.sample_rate
        gap_s = _SEGMENT_GAP_S if job.live else _SEGMENT_GAP_S / job.speed
        return np.zeros(int(gap_s * sr), dtype=np.int16)

    def _segment_wav(self, job: _Job, seg: int) -> np.ndarray:
        """Buffered segment audio, speed-stretched when the model does not
        handle the tag natively (same contract as engine.api)."""
        parts = job.seg_chunks.pop(seg, [])
        wav = np.concatenate(parts) if parts else np.zeros(0, np.int16)
        if not job.live and len(wav):
            from .audio.stretch import time_stretch
            from .ops.pcm import pcm16_to_f32

            sr = self.cfg.codec.sample_rate
            out = time_stretch(pcm16_to_f32(wav), job.speed, sr)
            wav = np.clip(out * 32767.0, -32768, 32767).astype(np.int16)
        return wav

    def _on_finished(self, stream_id: int) -> None:
        job = self._active.pop(stream_id, None)
        if job is None:
            return
        seg = job.seg_of_stream[stream_id]
        st = self.engine.streams.pop(stream_id)  # also frees codes/chunks
        job.frames += st.frames
        job.seg_done.add(seg)
        # flush segments in order; when the (new) current segment is still
        # decoding in live-stream mode, hand its buffered chunks over NOW so
        # its subsequent live-emitted chunks append in order behind them
        while True:
            if job.cur_seg in job.seg_done:
                wav = self._segment_wav(job, job.cur_seg)
                if len(wav):
                    job.emit("chunk", wav)
                job.cur_seg += 1
                if job.cur_seg < len(job.prompts):
                    job.emit("chunk", self._gap(job))
            elif job.stream and job.live and job.seg_chunks.get(job.cur_seg):
                for c in job.seg_chunks[job.cur_seg]:
                    job.emit("chunk", c)
                job.seg_chunks[job.cur_seg] = []
                break
            else:
                break
        if len(job.seg_done) == len(job.prompts):
            job.emit("done", {"frames": job.frames, "ttfa_s": job.ttfa_s})
            with self._lock:
                self.frames_total += job.frames
                # true served seconds (counts gaps + per-segment speed
                # stretch), not frames/frame_rate — they differ whenever
                # WSOLA speed handling rescales the PCM
                self.audio_seconds_total += (
                    job.samples / self.cfg.codec.sample_rate
                )
                if job.ttfa_s is not None:
                    self.ttfa_seconds_sum += job.ttfa_s
                    self.ttfa_count += 1
                    self._recent_ttfa = (
                        self._recent_ttfa + [job.ttfa_s]
                    )[-100:]

    def _fail_job(self, job: _Job, msg: str, *, code: int = 400) -> None:
        """Surface a failure to the waiting HTTP handler. ``code`` 400 for
        request problems (bad voice, unreadable reference), 500 for engine
        failures — clients/load-balancers must be able to tell them apart."""
        job.error = msg
        job.emit("error", {"message": msg, "code": code})
        with self._lock:
            self.errors_total += 1

    def _cancel_job_streams(self, job: _Job) -> None:
        """Free every engine slot the job still occupies. The _active entry
        drops BEFORE engine.cancel so an observer never sees a freed slot
        with a lingering active-job record (stats/tests poll both)."""
        for sid in [s for s, j in self._active.items() if j is job]:
            del self._active[sid]
            self.engine.cancel(sid)

    def _drain_cancels(self) -> None:
        while True:
            try:
                job = self._cancels.get_nowait()
            except queue.Empty:
                return
            if job in self._jobs:
                self._jobs.remove(job)
            self._cancel_job_streams(job)

    def _drive(self) -> None:
        # grad mode is thread-local: this thread's tensor work records no
        # autograd graph whatever its inputs
        with torch.no_grad():
            self._drive_loop()

    def _drive_loop(self) -> None:
        inflight: list = []
        while not self._stop.is_set():
            busy = bool(self._active) or bool(self._jobs) or inflight
            # drain the whole intake (block briefly when idle, no spinning):
            # requests that arrive together join the same step. Taking one
            # a turn, as the JAX daemon does, lets the first stream reach
            # the schedule's long chunks alone while the others queue
            timeout = 0.0 if busy else 0.2
            while True:
                try:
                    jb = self._intake.get(timeout=timeout)
                except queue.Empty:
                    break
                timeout = 0.0
                try:
                    self._prepare(jb)
                    self._jobs.append(jb)
                except Exception as e:  # bad voice, unreadable ref, ...
                    self._fail_job(jb, f"{type(e).__name__}: {e}")
            try:
                self._drain_cancels()
                self._admit()
                if not (self._active or self._jobs or inflight):
                    continue
                # pipelined decode (mirrors ServingEngine.run, incl. its
                # cold-start ramp: while NO live stream has first audio yet,
                # a speculative second step queued on the device would
                # land in every stream's TTFA)
                live = [
                    st for st in self.engine.streams.values() if not st.done
                ]
                depth = (
                    1 if live and all(st.ttfa_s is None for st in live)
                    else _PIPELINE_DEPTH
                )
                while (
                    (self._active or self._jobs)
                    and len(inflight) < depth
                ):
                    payload = self.engine.dispatch_step()
                    if payload is None:
                        break
                    inflight.append(payload)
                finished = self.engine.collect_step(
                    inflight.pop(0) if inflight else None
                )
                for sid in finished:
                    self._on_finished(sid)
            except Exception as e:  # never kill the engine thread
                # a dispatch/collect failure poisons the whole engine step:
                # fail every in-flight job, releasing their engine slots
                # (jobs hash by identity, so this dedups across both lists)
                for job in dict.fromkeys(
                    [*self._jobs, *self._active.values()]
                ):
                    self._cancel_job_streams(job)
                    self._fail_job(job, f"engine failure: {e}", code=500)
                self._active.clear()
                self._jobs.clear()
                inflight.clear()


# --------------------------------------------------------------------------
# WAV framing
# --------------------------------------------------------------------------

def wav_bytes(samples: np.ndarray, sample_rate: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(np.ascontiguousarray(samples, np.int16).tobytes())
    return buf.getvalue()


def wav_stream_header(sample_rate: int) -> bytes:
    """A 44-byte PCM WAV header with unknown (maxed) data length — the
    standard framing for live streams; players read until EOF."""
    byte_rate = sample_rate * 2
    return b"".join([
        b"RIFF", struct.pack("<I", 0xFFFFFFFF), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, byte_rate,
                             2, 16),
        b"data", struct.pack("<I", 0xFFFFFFFF),
    ])


# --------------------------------------------------------------------------
# HTTP transport
# --------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    service: TTSService = None  # type: ignore[assignment]
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        if os.environ.get("QWEN3_TTS_HTTP_LOG"):
            super().log_message(fmt, *args)

    def _json(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._json(200, self.service.stats())
        elif self.path == "/metrics":
            body = self.service.prometheus_metrics().encode()
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/v1/models":
            cfg = self.service.cfg
            self._json(200, {
                "name": self.service.model.name,
                "mode": cfg.mode,
                "sample_rate": cfg.codec.sample_rate,
                "speakers": sorted(cfg.speakers),
                "native_speed": cfg.native_speed,
            })
        elif self.path == "/v1/voices":
            self._json(200, {"voices": self.service.list_voices()})
        else:
            self._json(404, {"error": "not found"})

    def do_DELETE(self):
        if self.path.startswith("/v1/voices/"):
            name = self.path[len("/v1/voices/"):]
            try:
                self.service.delete_voice(name)
                self._json(200, {"deleted": name})
            except FileNotFoundError:
                self._json(404, {"error": f"no voice {name!r}"})
            except ValueError as e:
                self._json(400, {"error": str(e)})
        else:
            self._json(404, {"error": "not found"})

    def _post_voice(self, req: dict) -> None:
        try:
            name = self.service.enroll_voice(
                req["name"],
                base64.b64decode(req["audio_b64"]),
                req.get("transcript"),
                overwrite=bool(req.get("overwrite", False)),
            )
            self._json(200, {"enrolled": name})
        except FileExistsError as e:
            self._json(409, {
                "error": f"voice {e.args[0]!r} exists (pass overwrite)"
            })
        except Exception as e:  # bad wav bytes, name, b64, missing keys
            self._json(400, {"error": f"{type(e).__name__}: {e}"})

    def _post_openai_speech(self, req: dict) -> None:
        """POST /v1/audio/speech — the OpenAI TTS surface. OpenAI-style
        error envelope ({"error": {"message", "type"}}) on failure."""
        def err(code: int, msg: str, kind: str = "invalid_request_error"):
            self._json(code, {"error": {"message": msg, "type": kind}})

        try:
            kwargs, fmt = self.service.openai_to_submit(req)
            job = self.service.submit(**kwargs)
        except queue.Full:
            err(503, "server overloaded, retry later", "overloaded_error")
            return
        except FileNotFoundError as e:
            err(404, f"no saved voice {e.args[0]!r}")
            return
        except (ValueError, KeyError, TypeError) as e:
            msg = f"missing {e}" if isinstance(e, KeyError) else str(e)
            err(400, msg)
            return
        if job.stream:
            self._respond_streaming(job, fmt=fmt)
        else:
            self._respond_complete(job, fmt=fmt)

    def do_POST(self):
        if self.path in ("/v1/voices", "/v1/audio/speech"):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
                return
            if self.path == "/v1/voices":
                self._post_voice(req)
            else:
                self._post_openai_speech(req)
            return
        if self.path != "/v1/synthesize":
            self._json(404, {"error": "not found"})
            return
        tmp_path = None
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            if "saved_voice" in req:
                wav_path, transcript = self.service.resolve_saved_voice(
                    req.pop("saved_voice")
                )
                req["ref_wav_path"] = wav_path
                # the clone contract's "." fallback (reference clone.py)
                req.setdefault("ref_text", transcript or ".")
            elif "ref_audio_b64" in req:
                fd, tmp_path = tempfile.mkstemp(suffix=".wav")
                with os.fdopen(fd, "wb") as f:
                    f.write(base64.b64decode(req["ref_audio_b64"]))
                req["ref_wav_path"] = tmp_path
            elif "ref_audio" in req:
                req["ref_wav_path"] = req["ref_audio"]
            if "max_seconds" in req:
                req["max_frames"] = max(1, int(
                    float(req["max_seconds"])
                    * self.service.cfg.codec.frame_rate
                ))
            job = self.service.submit(**req)
        except queue.Full:
            self._json(503, {"error": "server overloaded, retry later"})
            return
        except FileNotFoundError as e:
            self._json(404, {"error": f"no saved voice {e.args[0]!r}"})
            return
        except (ValueError, KeyError, TypeError) as e:
            self._json(400, {"error": str(e)})
            return
        try:
            if job.stream:
                self._respond_streaming(job)
            else:
                self._respond_complete(job)
        finally:
            if tmp_path:
                try:
                    os.unlink(tmp_path)
                except OSError:
                    pass

    def _respond_complete(self, job: _Job, fmt: str = "wav") -> None:
        pieces: list[np.ndarray] = []
        while True:
            kind, payload = job.out.get()
            if kind == "chunk":
                pieces.append(payload)
            elif kind == "error":
                self._json(payload["code"], {"error": payload["message"]})
                return
            else:
                break
        sr = self.service.cfg.codec.sample_rate
        wav = np.concatenate(pieces) if pieces else np.zeros(0, np.int16)
        if fmt == "pcm":  # raw s16le mono (OpenAI 'pcm' framing)
            body = np.ascontiguousarray(wav, np.int16).tobytes()
        else:
            body = wav_bytes(wav, sr)
        try:
            self.send_response(200)
            self.send_header("Content-Type", f"audio/{fmt}")
            self.send_header("Content-Length", str(len(body)))
            if job.ttfa_s is not None:
                self.send_header("X-TTFA-Ms", f"{job.ttfa_s * 1e3:.0f}")
            self.send_header("X-Audio-Seconds", f"{len(wav) / sr:.2f}")
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionError):
            self.close_connection = True

    def _respond_streaming(self, job: _Job, fmt: str = "wav") -> None:
        """Chunked transfer: WAV header first (raw PCM chunks when
        ``fmt == "pcm"``), then PCM as it decodes. The first queue item
        decides the status code (an invalid request still gets a clean
        error before any audio bytes). A failure AFTER audio started aborts
        the connection mid-chunked-body — no terminal chunk — so clients
        can distinguish truncated audio from success. A client disconnect
        cancels the job, freeing its engine slots."""
        kind, payload = job.out.get()
        if kind == "error":
            self._json(payload["code"], {"error": payload["message"]})
            return
        sr = self.service.cfg.codec.sample_rate
        self.send_response(200)
        self.send_header("Content-Type", f"audio/{fmt}")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def send(data: bytes) -> None:
            self.wfile.write(f"{len(data):X}\r\n".encode())
            self.wfile.write(data)
            self.wfile.write(b"\r\n")

        try:
            if fmt == "wav":
                send(wav_stream_header(sr))
            while True:
                if kind == "chunk" and len(payload):
                    send(np.ascontiguousarray(payload, np.int16).tobytes())
                elif kind == "done":
                    send(b"")  # clean terminal chunk: stream is complete
                    return
                elif kind == "error":
                    self.close_connection = True  # abort = visible failure
                    return
                kind, payload = job.out.get()
        except (BrokenPipeError, ConnectionError):
            self.service.cancel(job)  # stop decoding discarded audio
            self.close_connection = True


class _Server(ThreadingHTTPServer):
    # clients that connect at once wait in the listen backlog while the
    # accept loop shares the interpreter with the decode thread;
    # socketserver's backlog of 5 overflows when 8 connect together
    request_queue_size = 128


def make_server(
    service: TTSService, host: str = "127.0.0.1", port: int = 8080
) -> ThreadingHTTPServer:
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return _Server((host, port), handler)


def model_device() -> str:
    """The daemon's device: the CUDA device, or the CPU when QWEN3_TTS_CPU
    is set (to anything but 0)."""
    return "cpu" if os.environ.get("QWEN3_TTS_CPU", "0") not in ("", "0") \
        else "cuda"


def build_model(name: str, mode: str, device: str):
    """``synthetic`` (the flagship at two frames a step, its MTP heads
    int8 like the rest of the tree), ``synthetic-tiny``,
    ``synthetic-tiny-code2wav``, or a checkpoint directory."""
    from .engine import configs
    from .engine.api import Qwen3TTSModel, load_model

    presets = {
        "synthetic": lambda: configs.flagship(mode, frames_per_step=2),
        "synthetic-tiny": lambda: configs.tiny(mode),
        "synthetic-tiny-code2wav": lambda: configs.tiny_code2wav(mode),
    }
    if name in presets:
        return Qwen3TTSModel.synthetic(presets[name](), device=device)
    return load_model(name, device=device)


def main(argv: list[str] | None = None) -> None:
    import argparse
    import sys

    ap = argparse.ArgumentParser(description="qwen3-tts HTTP server")
    ap.add_argument("--model", default="synthetic",
                    help="checkpoint path, or 'synthetic'/'synthetic-tiny'"
                         "/'synthetic-tiny-code2wav'")
    ap.add_argument("--mode", default="custom",
                    choices=["custom", "design", "base"])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--voices-dir", default=None,
                    help="voice library directory (default: ./voices)")
    args = ap.parse_args(argv)

    # the daemon owns a big-cache engine for its whole lifetime: take the
    # host-wide device lock so a second engine-owning process waits
    # instead of allocating into the same card's memory (no-op on the CPU)
    from .device_lock import device_lock

    if not device_lock(label="server"):
        print("error: device lock never freed (another engine-owning "
              "process is using the card); refusing to start a second "
              "engine", file=sys.stderr)
        raise SystemExit(2)

    model = build_model(args.model, args.mode, model_device())
    service = TTSService(
        model, max_streams=args.streams, voices_dir=args.voices_dir
    ).start()
    srv = make_server(service, args.host, args.port)
    print(f"qwen3-tts serving {model.name} on {model.device} at "
          f"http://{args.host}:{srv.server_address[1]} "
          f"({args.streams} streams)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        service.stop()


if __name__ == "__main__":
    main()
