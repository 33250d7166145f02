"""Host milliseconds a frame-step in the talker in the profiled slice:
the program's ``qwen3_tts.model.talker`` spans (a talker pass: the step's
input embedding, the 28 layers, cb0's sample), inclusive, over the
frame-steps dispatched in the slice (a step of c frames counts c;
``harness/spans.py``)."""

from harness import spans


def read(ctx):
    return spans.per(ctx, "host_ms", ["qwen3_tts.model.talker"],
                     frames=True)
