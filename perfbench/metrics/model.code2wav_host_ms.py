"""Host milliseconds a frame-step in code2wav in the profiled slice: the
program's ``qwen3_tts.model.code2wav`` spans (the codec's streaming decode
of a chunk and its PCM), inclusive, over the frame-steps dispatched in the
slice (a step of c frames counts c; ``harness/spans.py``)."""

from harness import spans


def read(ctx):
    return spans.per(ctx, "host_ms", ["qwen3_tts.model.code2wav"],
                     frames=True)
