"""The driven service: the daemon's engine thread and closed-loop clients.

``Recorder`` wraps, from outside, the calls of one ``TTSService`` and its
``ServingEngine`` that the metrics and the check read:

- ``dispatch_step``: the time, chunk and rows of every dispatched step;
- ``collect_step``: the time of every collected step and the samples it
  handed to each job's queue (a step's audio reaches the queues inside
  its collection, through the engine's chunk callbacks);
- ``_activate`` and the module's ``seed_feedback_frames``: each stream's
  seed frame (cb0 and its residual codes; it conditions the first decode
  step and is not rendered), kept on the device until the run ends;
- ``_on_finished``: the codes the engine served a finishing stream;
- the engine thread's CPU time at each collection (``host.thread_sample``).

With ``trace`` it also opens a ``perfbench.*`` profiler range around each
wrapped call, and runs the profiled slice on the engine thread, with
kernel A's launches counted by shape (``ops.grouped_qmv.grouped_qmv_cuda``
wrapped while the slice runs).

``Client`` is one closed-loop caller: it submits a request, reads its
queue to the end as an HTTP handler does, and submits the next.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import Counter

import numpy as np
import torch

from .host import thread_sample
from .trace import Slice


class Recorder:
    def __init__(self, service, trace: bool, slice_steps: int = 1,
                 slice_seconds: float = 2.0):
        from qwen3_tts_tpu_torch.ops import grouped_qmv
        from qwen3_tts_tpu_torch.runtime import serving

        self.service = service
        self.engine = service.engine
        self.serving = serving
        self.qmv = grouped_qmv
        self.trace = trace
        self.dispatches: list[tuple[float, int, int, bool]] = []
        self.collects: list[tuple[float, int, list]] = []
        self.engine_host: list[tuple] = []       # thread_sample() a collect
        self.served: dict[int, tuple] = {}       # id(job) -> (codes, seed)
        self._seeds: dict[int, tuple] = {}       # stream id -> seed frame
        self._group: list[int] = []
        self.slice_steps = slice_steps
        self.slice_seconds = slice_seconds
        self.want_slice = threading.Event()
        self.slice_done = threading.Event()
        self.slice: Slice | None = None
        self.slice_t0 = 0.0
        self.slice_collects = 0
        self.profiling = False
        self.qmv_shapes: Counter = Counter()
        self._saved: list = []

    # -- wrappers -------------------------------------------------------------

    def _span(self, name):
        if self.trace:
            return torch.profiler.record_function(f"perfbench.{name}")
        return _NULL

    def install(self) -> None:
        svc, eng = self.service, self.engine
        dispatch, collect = eng.dispatch_step, eng.collect_step
        activate, finished = eng._activate, svc._on_finished
        prepare = svc._prepare
        seed_fn = self.serving.seed_feedback_frames
        self._saved = [(eng, "dispatch_step"), (eng, "collect_step"),
                       (eng, "_activate"), (svc, "_on_finished"),
                       (svc, "_prepare")]

        def dispatch_step():
            with self._span("dispatch_step"):
                p = dispatch()
            if p is not None:
                self.dispatches.append((time.perf_counter(), p[1], len(p[0]),
                                        self.profiling))
            return p

        def collect_step(payload):
            jobs = list(dict.fromkeys(svc._active.values()))
            before = [j.samples for j in jobs]
            with self._span("collect_step"):
                out = collect(payload)
            got = [(id(j), b, j.samples) for j, b in zip(jobs, before)
                   if j.samples != b]
            if payload is not None:
                self.collects.append((time.perf_counter(), payload[1], got))
                self.engine_host.append(thread_sample())
                self._slice_hook()
            return out

        def _activate(group, *args):
            self._group = [pp.stream.stream_id for pp in group]
            with self._span("activate"):
                return activate(group, *args)

        def seed_feedback_frames(*args, **kwargs):
            out = seed_fn(*args, **kwargs)
            first, _, res = out
            for i, sid in enumerate(self._group):
                self._seeds[sid] = (first, res, i)
            return out

        def _on_finished(sid):
            job = svc._active.get(sid)
            st = eng.streams.get(sid)
            if job is not None and st is not None:
                codes = (np.concatenate(st.codes, axis=1) if st.codes
                         else np.zeros((0, 0), np.int64))
                self.served[id(job)] = (codes, self._seeds.pop(sid, None))
            with self._span("on_finished"):
                return finished(sid)

        def _prepare(job):
            with self._span("prepare"):
                return prepare(job)

        eng.dispatch_step, eng.collect_step = dispatch_step, collect_step
        eng._activate, svc._on_finished = _activate, _on_finished
        svc._prepare = _prepare
        self._seed_fn = seed_fn
        self.serving.seed_feedback_frames = seed_feedback_frames

    def uninstall(self) -> None:
        for obj, name in self._saved:
            obj.__dict__.pop(name, None)
        self.serving.seed_feedback_frames = self._seed_fn

    # -- the profiled slice (engine thread) -----------------------------------

    def _slice_hook(self) -> None:
        if not self.want_slice.is_set() or self.slice_done.is_set():
            return
        if not self.profiling:
            self.slice = Slice()
            self._qmv_fn = self.qmv.grouped_qmv_cuda
            self.qmv.grouped_qmv_cuda = self._count_qmv
            self.slice.start()
            self.profiling = True
            self.slice_t0 = time.perf_counter()
            self.slice_collects = 0
            return
        self.slice_collects += 1
        if (self.slice_collects >= self.slice_steps
                and time.perf_counter() - self.slice_t0 >= self.slice_seconds):
            self.slice.stop()
            self.qmv.grouped_qmv_cuda = self._qmv_fn
            self.profiling = False
            self.slice_done.set()

    def _count_qmv(self, x2, qg, sg, bg):
        g, gs, n = qg.shape
        self.qmv_shapes[(x2.shape[0], n, g * gs, gs,
                         x2.dtype == torch.float32)] += 1
        return self._qmv_fn(x2, qg, sg, bg)

    # -- after the run ----------------------------------------------------------

    def seed_codes(self) -> dict[int, np.ndarray]:
        """id(job) -> the seed frame's codes [Q] (cb0, residual depths)."""
        out = {}
        for key, (_, seed) in self.served.items():
            if seed is None:
                continue
            first, res, i = seed
            out[key] = np.concatenate([first[i, :1].cpu().numpy(),
                                       res[i, 0].cpu().numpy()]).astype(np.int64)
        return out


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class Clients:
    """The closed loops: ``n`` threads, each sending its requests in turn."""

    def __init__(self, service, requests: list[list[dict]]):
        self.service = service
        self.records: list[dict] = []
        self.lock = threading.Lock()
        self.stop = threading.Event()      # send no further request
        self.halt = threading.Event()      # the engine has stopped
        self.threads = [threading.Thread(target=self._loop, args=(reqs,),
                                         name=f"client-{i}", daemon=True)
                        for i, reqs in enumerate(requests)]

    def start(self) -> None:
        for t in self.threads:
            t.start()

    def release(self) -> None:
        """Wake every client still waiting on its job's queue, so that it
        returns (the engine thread has stopped)."""
        self.halt.set()
        for rec in list(self.records):
            if rec["job"] is not None and rec["t_done"] is None:
                rec["job"].out.put(("halt", None))

    def join(self, timeout: float) -> None:
        end = time.perf_counter() + timeout
        for t in self.threads:
            t.join(max(0.0, end - time.perf_counter()))

    def alive(self) -> int:
        return sum(t.is_alive() for t in self.threads)

    def _loop(self, reqs: list[dict]) -> None:
        for req in reqs:
            if self.stop.is_set() or self.halt.is_set():
                return
            rec = {"req": req, "t_submit": time.perf_counter(),
                   "t_first": None, "t_done": None, "samples": 0,
                   "pcm": [], "error": None, "job": None}
            with self.lock:
                self.records.append(rec)
            try:
                job = self.service.submit(
                    text=req["text"], voice=req["voice"],
                    instruct=req["instruct"], max_frames=req["frames"],
                    stream=True)
            except queue.Full:
                rec["error"] = "rejected: intake queue full"
                continue
            rec["job"] = job
            while True:
                # a blocking read, as an HTTP handler's: the thread wakes
                # only when the engine hands its job something
                kind, payload = job.out.get()
                if kind == "halt":
                    return
                now = time.perf_counter()
                if kind == "chunk":
                    if len(payload) and rec["t_first"] is None:
                        rec["t_first"] = now
                    rec["samples"] += len(payload)
                    rec["pcm"].append(payload)
                elif kind == "done":
                    rec["t_done"] = now
                    break
                else:
                    rec["error"] = str(payload.get("message"))
                    break
