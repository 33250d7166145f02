"""The program's own spans in the profiled slice: host and device time by
layer, and the device's idle time by what the program was doing.

The program opens ``qwen3_tts.*`` spans on its engine thread
(``qwen3_tts_tpu_torch/profiling.py::trace``): host ``cpu_op`` ranges on
the clock of the device's kernels, with no shadow on the device. From the
slice's events (``Slice.prof.kineto_results.events()``) this reads:

- host time per span name, inclusive and self (the span less the program
  spans directly inside it), and the number of spans;
- device time per span: each launch on the host (a kernel launch, or a
  memcpy or memset call of the runtime) belongs to the program spans open
  around it on its thread, and its device event, found by correlation id,
  adds its time to each of them (``device_ms``) and to the innermost one
  (``device_self_ms``). A device event whose launch fell before the slice
  (``device_before_ms``) or outside every span (``device_outside_ms``)
  stays unattributed. Device ranges of user scope (the shadows of
  ``record_function`` ranges) are no device work and are skipped;
- the device's idle gaps over the slice, each put down to the innermost
  program span open at its midpoint (``idle_ms``, "-" where none is);
- ``coverage``: the share of the engine thread's time from its first
  program span to its last that the outermost spans cover.

The window and the device's busy time are taken as ``trace.Slice.read``
takes them: from the first to the last host event, device intervals
clipped to it. A program that opens no span gives None.
"""

from __future__ import annotations

import re
from collections import defaultdict

import torch

PREFIX = "qwen3_tts."
LAUNCH = re.compile(r"LaunchKernel|^cu(da)?Mem(cpy|set)")
NONE = "-"


def of(ctx) -> dict | None:
    """``summarize`` of the ctx's profiled slice, read once per slice."""
    sl = getattr(ctx.recorder, "slice", None)
    if ctx.profile is None or sl is None or sl.prof is None:
        return None
    if not hasattr(sl, "program_spans"):  # kept on the slice: read once
        sl.program_spans = summarize(sl.prof.kineto_results.events())
    return sl.program_spans


def steps(ctx) -> int:
    """Engine steps dispatched in the slice."""
    return sum(1 for *_, prof in ctx.recorder.dispatches if prof)


def frame_steps(ctx) -> int:
    """Frame-steps dispatched in the slice (a step of c frames counts c)."""
    return sum(c for _, c, _, prof in ctx.recorder.dispatches if prof)


def per(ctx, key: str, names, frames: bool) -> float | None:
    """The sum of ``summarize(...)[key]`` over ``names`` per frame-step
    (``frames``) or per step of the slice; None without spans, without
    any of ``names``, or without a step."""
    s = of(ctx)
    if s is None:
        return None
    got = [s[key][n] for n in names if n in s[key]]
    n = frame_steps(ctx) if frames else steps(ctx)
    return sum(got) / n if got and n else None


def summarize(events) -> dict | None:
    """Host and device time by program span over one profiler session's
    kineto events (module docstring)."""
    cpu = torch.autograd.DeviceType.CPU
    spans, launches, devs = [], [], []
    w0 = w1 = None
    for e in events:
        name = e.name()
        s = e.start_ns()
        t = s + e.duration_ns()
        if e.device_type() == cpu:
            w0 = s if w0 is None or s < w0 else w0
            w1 = t if w1 is None or t > w1 else w1
            if name.startswith(PREFIX):
                spans.append((s, t, e.start_thread_id(), name))
            elif LAUNCH.search(name):
                launches.append((s, e.start_thread_id(), e.correlation_id()))
        elif not e.is_user_annotation():
            devs.append((s, t, e.correlation_id()))
    if not spans:
        return None
    by_tid: dict = defaultdict(int)
    for _, _, tid, _ in spans:
        by_tid[tid] += 1
    engine = max(by_tid, key=by_tid.get)
    spans = sorted(((s, t, n) for s, t, tid, n in spans if tid == engine),
                   key=lambda x: (x[0], -x[1]))

    host, self_, calls = (defaultdict(float), defaultdict(float),
                          defaultdict(int))
    stack, roots = [], 0.0
    for s, t, name in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        d = (t - s) * 1e-6
        host[name] += d
        self_[name] += d
        calls[name] += 1
        if stack:
            self_[stack[-1][2]] -= d
        else:
            roots += d
        stack.append((s, t, name))

    # correlation id -> the spans open at its launch on the engine thread
    chains = dict(_sweep(spans, sorted((s, c) for s, tid, c in launches
                                       if tid == engine)))
    seen = {c for _, _, c in launches}
    dev_incl, dev_self = defaultdict(float), defaultdict(float)
    before = outside = 0.0
    clipped = []
    for s, t, corr in devs:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        clipped.append((s, t))
        d = (t - s) * 1e-6
        chain = chains.get(corr)
        if chain:
            for name in set(chain):
                dev_incl[name] += d
            dev_self[chain[-1]] += d
        elif corr in seen:
            outside += d
        else:
            before += d

    union = []
    for s, t in sorted(clipped):
        if union and s <= union[-1][1]:
            union[-1][1] = max(union[-1][1], t)
        else:
            union.append([s, t])
    edges = [w0] + [x for iv in union for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle = defaultdict(float)
    mids = sorted(((a + b) // 2, (b - a) * 1e-6) for a, b in gaps)
    for d, chain in _sweep(spans, mids):
        idle[chain[-1] if chain else NONE] += d
    first, last = spans[0][0], max(t for _, t, _ in spans)
    return {
        "host_ms": dict(host), "self_ms": dict(self_), "calls": dict(calls),
        "device_ms": dict(dev_incl), "device_self_ms": dict(dev_self),
        "device_before_ms": before, "device_outside_ms": outside,
        "busy_ms": sum(t - s for s, t in union) * 1e-6,
        "window_ms": (w1 - w0) * 1e-6, "idle_ms": dict(idle),
        "coverage": roots / ((last - first) * 1e-6) if last > first else 1.0,
    }


def _sweep(spans, points):
    """For each (time, key) of ``points`` (sorted by time), (key, the names
    of the spans open at that time, outermost first). ``spans`` are one
    thread's (start, end, name), sorted by start and properly nested."""
    stack, i = [], 0
    for x, key in points:
        while i < len(spans) and spans[i][0] <= x:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < x:
            stack.pop()
        yield key, tuple(n for _, _, n in stack)
