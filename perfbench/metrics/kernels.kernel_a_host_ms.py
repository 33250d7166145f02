"""Host milliseconds a frame-step in kernel A's launch path in the profiled
slice: the program's ``qwen3_tts.kernel.grouped_qmv`` spans (the route
choice, ``plan_kernel_a``, the workspace and the call into the library),
inclusive, over the frame-steps dispatched in the slice (a step of c frames
counts c; ``harness/spans.py``). Nothing where kernel A is not called."""

from harness import spans


def read(ctx):
    return spans.per(ctx, "host_ms", ["qwen3_tts.kernel.grouped_qmv"],
                     frames=True)
