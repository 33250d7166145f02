"""What the host did during the window, read from this process without
changing it: where the noise of a host-bound rate comes from.

- ``thread_sample``: on the calling thread (the engine thread, at each
  collection), the time and that thread's CPU seconds;
- ``process_sample``: the time and this process's CPU seconds, every
  thread counted.

``summary`` turns them into one line for standard error. An engine thread
on a CPU nearly all of the window, with the process adding little, means
that the window's length follows the speed of that CPU.
"""

from __future__ import annotations

import os
import time


def thread_sample() -> tuple[float, float]:
    return time.perf_counter(), time.thread_time()


def process_sample() -> tuple[float, float]:
    t = os.times()
    return time.perf_counter(), t.user + t.system


def summary(t_open: float, t_close: float, engine: list, p0: tuple,
            p1: tuple) -> str:
    """One line: the window's engine steps (ms each, from one collection to
    the next), the engine thread's CPU share over them, and the process's
    CPU seconds per second of the window."""
    inside = [s for s in engine if t_open <= s[0] <= t_close]
    parts = [f"host steps {max(len(inside) - 1, 0)}"]
    if len(inside) >= 2:
        (ta, ca), (tb, cb) = inside[0], inside[-1]
        steps = [round((b[0] - a[0]) * 1e3, 1)
                 for a, b in zip(inside, inside[1:])]
        parts.append("step_ms " + ",".join(str(s) for s in steps))
        parts.append(f"engine_cpu_share {(cb - ca) / (tb - ta):.4f}")
    if p1[0] > p0[0]:
        parts.append(f"proc_cpu_per_s {(p1[1] - p0[1]) / (p1[0] - p0[0]):.3f}")
    return " ".join(parts)
