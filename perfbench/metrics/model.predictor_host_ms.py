"""Host milliseconds a frame-step in the code predictor in the profiled
slice: the program's ``qwen3_tts.model.predictor`` spans (the predictor's
passes for a step's frames), inclusive, over the frame-steps dispatched in
the slice (a step of c frames counts c; ``harness/spans.py``)."""

from harness import spans


def read(ctx):
    return spans.per(ctx, "host_ms", ["qwen3_tts.model.predictor"],
                     frames=True)
