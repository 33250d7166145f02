"""Device milliseconds a frame-step of the kernels and copies launched
inside the program's ``qwen3_tts.model.talker`` spans in the profiled
slice (linked to their launches by correlation id), over the frame-steps
dispatched in the slice (a step of c frames counts c;
``harness/spans.py``)."""

from harness import spans


def read(ctx):
    return spans.per(ctx, "device_ms", ["qwen3_tts.model.talker"],
                     frames=True)
