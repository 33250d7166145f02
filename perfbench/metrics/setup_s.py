"""Seconds from the process's start to the window's opening: imports, the
weights made on the device, the kernels' build (first run of a checkout)
or load, the engine, and the warm-up (the cold batch of every client's
first request, a step of each chunk size)."""


def read(ctx):
    return ctx.setup_s
