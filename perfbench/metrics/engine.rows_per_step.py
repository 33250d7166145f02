"""Mean number of active slots (decoding streams) in the steps dispatched
in the window, read from the dispatch's own snapshot of its rows."""


def read(ctx):
    rows = [r for t, _, r, _ in ctx.recorder.dispatches
            if ctx.t_open <= t <= ctx.t_close]
    return sum(rows) / len(rows) if rows else None
