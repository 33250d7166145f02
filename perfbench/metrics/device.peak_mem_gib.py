"""``torch.cuda.max_memory_allocated()`` over the run, before the check,
in GiB: the weights, the 64 slots' caches and the steps' transients."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
