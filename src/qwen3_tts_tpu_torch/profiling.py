"""Tracing and structured metrics (the JAX package's profiling.py on
torch.profiler).

- ``trace(name)``: a named span of host time in a profiler's trace, and
  nothing at all when no profiler records;
- ``emit_metrics``: one JSON line per event on stderr, opt-in with
  QWEN3_TTS_METRICS=1.

The decode path opens its spans under ``qwen3_tts.``: the engine's step
(``engine.dispatch``, ``engine.collect`` and the ``engine.host_wait`` for
the step's host copy inside it), the model's layers (``model.talker``,
``model.predictor``, ``model.code2wav``, ``model.attention``) and kernel
A's launch path (``kernel.grouped_qmv``).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Any

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler


def metrics_enabled() -> bool:
    return os.environ.get("QWEN3_TTS_METRICS", "0") not in ("", "0", "false")


_NO_SPAN = contextlib.nullcontext()


def trace(name: str):
    """A context manager that records ``name`` as a span of host time
    while a profiler records; with none recording, one shared no-op
    object (no allocation, no RecordFunction: a single read of the flag
    that the profiler's start and stop set).

    The span is a ``_RecordFunctionFast`` range, which the profiler keeps
    as a host ``cpu_op`` event on the clock of the device's kernels. It
    is not ``torch.profiler.record_function``: a range of user scope also
    leaves a shadow of itself on the device's timeline, spanning the
    kernels launched inside it and every gap between them, which a reader
    of the device's time would count as work."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _RecordFunctionFast(name)


def emit_metrics(event: str, payload: dict[str, Any]) -> None:
    """One JSON line on stderr when QWEN3_TTS_METRICS is set."""
    if not metrics_enabled():
        return
    line = {"event": event, "ts": round(time.time(), 3), **payload}
    print(json.dumps(line), file=sys.stderr, flush=True)
