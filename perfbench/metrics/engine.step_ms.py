"""Milliseconds of the window per dispatched engine step (a step is one
``ServingEngine.dispatch_step`` of 4 or 32 frames for every slot)."""


def read(ctx):
    n = sum(1 for t, *_ in ctx.recorder.dispatches
            if ctx.t_open <= t <= ctx.t_close)
    return (ctx.t_close - ctx.t_open) * 1e3 / n if n else None
