"""Tracing, profiling and structured metrics (the JAX package's
profiling.py on torch.profiler and CUDA synchronisation).

- ``trace(label)``: a named host range in the profiler's timeline
  (``torch.profiler.record_function``);
- ``profile_to(dir)``: a CPU + CUDA trace of the block, written into
  ``dir`` as a Chrome trace (chrome://tracing, Perfetto);
- ``StageTimer``: wall time per stage, with ``sync=True`` a
  ``torch.cuda.synchronize()`` at each boundary so stages are device
  boundaries, not enqueue boundaries;
- ``emit_metrics``: one JSON line per event on stderr, opt-in with
  QWEN3_TTS_METRICS=1.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Iterator

import torch


def metrics_enabled() -> bool:
    return os.environ.get("QWEN3_TTS_METRICS", "0") not in ("", "0", "false")


@contextlib.contextmanager
def trace(label: str) -> Iterator[None]:
    """Annotate a region in the profiler timeline (a no-op range when no
    trace is being captured)."""
    with torch.profiler.record_function(label):
        yield


@contextlib.contextmanager
def profile_to(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the block on the CPU and, when there is one, the CUDA device;
    the trace is written to ``log_dir/trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass
class StageTimer:
    """Accumulates wall time per named stage.

    ``sync=True`` waits for the CUDA device before and after each stage
    (kernels are enqueued asynchronously)."""

    sync: bool = False
    stages: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        if self.sync:
            self._block()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                self._block()
            dt = time.perf_counter() - t0
            self.stages[name] = self.stages.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    @staticmethod
    def _block() -> None:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def summary(self) -> dict[str, Any]:
        return {
            name: {"total_s": round(t, 4), "calls": self.counts[name]}
            for name, t in sorted(self.stages.items())
        }


def emit_metrics(event: str, payload: dict[str, Any]) -> None:
    """One JSON line on stderr when QWEN3_TTS_METRICS is set."""
    if not metrics_enabled():
        return
    line = {"event": event, "ts": round(time.time(), 3), **payload}
    print(json.dumps(line), file=sys.stderr, flush=True)
