"""Device milliseconds a frame-step of the kernels and copies launched
inside the program's ``qwen3_tts.model.attention`` spans (every attention
of the talker, the code predictor and code2wav's transformer: projections,
the cache write, the float32 scores and context) in the profiled slice,
over the frame-steps dispatched in the slice (a step of c frames counts c;
``harness/spans.py``)."""

from harness import spans


def read(ctx):
    return spans.per(ctx, "device_ms", ["qwen3_tts.model.attention"],
                     frames=True)
