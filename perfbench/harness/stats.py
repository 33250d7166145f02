"""The arithmetic of the metrics: percentiles with missing requests,
spreads, and rates over whole deliveries."""

from __future__ import annotations

import math
import statistics


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0-100, linear between ranks, numpy's default)
    of ``values``, in which a missing request is +inf: a percentile that
    touches one is +inf."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = q / 100.0 * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    if math.isinf(xs[lo]) or (frac > 0 and math.isinf(xs[hi])):
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * frac


def spread(values: list[float]) -> float:
    """Distance between the first and the third quartile
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def delivery_window(deliveries: list[tuple[float, float]], t_open: float,
                    t_close: float):
    """The whole deliveries of a window: ``deliveries`` are (time, amount)
    pairs in time order, one per engine step that handed audio out. The
    window runs from the first delivery at or after ``t_open`` to the last
    at or before ``t_close``; it counts what the deliveries after its
    first handed out, so every step it counts lies wholly inside it.
    Returns (amount, seconds), or None with fewer than two deliveries."""
    inside = [(t, a) for t, a in deliveries if t_open <= t <= t_close]
    if len(inside) < 2:
        return None
    return sum(a for _, a in inside[1:]), inside[-1][0] - inside[0][0]


def whole_delivery_rate(deliveries, t_open, t_close) -> float | None:
    """Amount per second over ``delivery_window``; None where it is empty."""
    w = delivery_window(deliveries, t_open, t_close)
    if w is None or w[1] <= 0:
        return None
    return w[0] / w[1]
