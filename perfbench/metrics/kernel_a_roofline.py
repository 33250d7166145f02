"""Kernel A's share of its roofline in the profiled slice: the sum over its
launches of each launch's least time (``harness/roofline.py::bound_ms``
at the launch's M, N, K and group size, counted by wrapping the program's
``grouped_qmv_cuda`` while the slice runs) over kernel A's device time in
the slice (its ``ring_kernel<T, ...>`` and ``qmv_grouped_kernel``
kernels). Nothing where kernel A did not run."""

from harness.roofline import bound_ms


def read(ctx):
    if ctx.profile is None or ctx.profile["kernel_a_s"] <= 0:
        return None
    bound = sum(n * bound_ms(m, nn, k, gs, f32)[0]
                for (m, nn, k, gs, f32), n in ctx.recorder.qmv_shapes.items())
    if bound <= 0:
        return None
    return 100.0 * bound / (ctx.profile["kernel_a_s"] * 1e3)
