"""The 95th percentile of time to first audio over every request sent in
the window: the client's clock from ``submit`` to the first non-empty
chunk read from its job's queue. A request with no audio by the drain (or
failed) counts as +inf; a percentile that reaches one is not reported."""

import math

from harness.stats import percentile


def read(ctx):
    ttfa = [(r["t_first"] - r["t_submit"]) if r["t_first"] is not None
            and r["error"] is None else math.inf
            for r in ctx.records if ctx.t_open <= r["t_submit"] <= ctx.t_close]
    if not ttfa:
        return None
    value = percentile(ttfa, 95)
    return value if math.isfinite(value) else None
