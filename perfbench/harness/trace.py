"""The profiled slice: the profiler over whole engine steps, read into
device intervals, launches, kernel A's time and the breakdown.

The slice is started and stopped on the engine thread, between a step's
collection and the next dispatch, so it holds whole steps. Nothing is
exported: the events are read from the profiler in memory.
"""

from __future__ import annotations

import re
from collections import defaultdict

import torch

# kernel A's kernels: the ring instances ring_kernel<T, R, BANDS, RAGGED>
# (kernel B's ring takes one int) and the simple qmv_grouped_kernel
KERNEL_A = re.compile(r"qmv_grouped_kernel|ring_kernel<(__nv_bfloat16|float),")
LAUNCH = re.compile(r"LaunchKernel")
SPAN_PREFIX = "perfbench."


def _interval(e) -> tuple[float, float]:
    """(start, end) of a kineto event in seconds."""
    s = e.start_ns()
    return s * 1e-9, (s + e.duration_ns()) * 1e-9


class Slice:
    """One profiler session over whole steps."""

    def __init__(self):
        self.prof = None

    def start(self) -> None:
        # the autograd profiler itself: its events are read from the kineto
        # result, never parsed into Python function events
        self.prof = torch.autograd.profiler.profile(
            use_device="cuda" if torch.cuda.is_available() else None,
            use_kineto=True)
        self.prof.__enter__()

    def stop(self) -> None:
        self.prof.__exit__(None, None, None)

    def read(self) -> dict:
        """Device intervals and their union over the slice, launches, kernel
        A's device seconds, the top device operations and the longest idle
        gaps, each named by what the host was doing in it."""
        cpu_iv, dev_iv = [], []
        for e in self.prof.kineto_results.events():
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CPU:
                cpu_iv.append((*_interval(e), name))
            elif not name.startswith(SPAN_PREFIX):
                # (a harness range's shadow on the device's timeline is
                # no device work)
                dev_iv.append((*_interval(e), name))
        if cpu_iv:
            w0 = min(s for s, _, _ in cpu_iv)
            w1 = max(t for _, t, _ in cpu_iv)
        else:
            w0 = min(s for s, _, _ in dev_iv)
            w1 = max(t for _, t, _ in dev_iv)
        clipped = sorted((max(s, w0), min(t, w1)) for s, t, _ in dev_iv
                         if t > w0 and s < w1)
        union = []
        for s, t in clipped:
            if union and s <= union[-1][1]:
                union[-1][1] = max(union[-1][1], t)
            else:
                union.append([s, t])
        busy = sum(t - s for s, t in union)
        by_name: dict[str, float] = defaultdict(float)
        kernel_a = 0.0
        for s, t, name in dev_iv:
            by_name[name] += t - s
            if KERNEL_A.search(name):
                kernel_a += t - s
        edges = [w0] + [x for iv in union for x in iv] + [w1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:10]
        idle = [[_host_at(cpu_iv, (a + b) / 2), g] for g, a, b in gaps]
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {
            "window_s": w1 - w0,
            "busy_s": busy,
            "launches": sum(1 for _, _, n in cpu_iv if LAUNCH.search(n)),
            "kernel_a_s": kernel_a,
            "device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": idle,
        }


def _host_at(cpu_iv, t: float) -> str:
    """What the host was doing at ``t``: the outermost harness span and the
    innermost operation open then."""
    open_ = [(e - s, name) for s, e, name in cpu_iv if s <= t <= e]
    if not open_:
        return "host: no operation open"
    spans = [x for x in open_ if x[1].startswith(SPAN_PREFIX)]
    inner = min(open_)[1]
    outer = max(spans)[1] if spans else "-"
    return f"{outer} > {inner}"[:160]
