"""Kernel launch calls (the CUDA runtime's launch entries in the profiler's
host events) in the profiled slice per frame-step dispatched in it (a step
of c frames counts c)."""


def read(ctx):
    if ctx.profile is None:
        return None
    frames = sum(c for _, c, _, prof in ctx.recorder.dispatches if prof)
    return ctx.profile["launches"] / frames if frames else None
