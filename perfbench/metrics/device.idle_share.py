"""Share of the profiled slice in which no kernel, copy or memset ran on
the card: one less the union of the device's intervals over the slice."""


def read(ctx):
    if ctx.profile is None or ctx.profile["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.profile["busy_s"] / ctx.profile["window_s"])
