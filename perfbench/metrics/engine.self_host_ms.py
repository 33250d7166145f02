"""Milliseconds a step of the engine's own host work in the profiled
slice: the self time of the program's ``qwen3_tts.engine.dispatch`` and
``qwen3_tts.engine.collect`` spans (each less the model spans and the host
wait inside it: packing, chunk choice, accounting, callbacks) over the
engine steps dispatched in the slice (``harness/spans.py``)."""

from harness import spans


def read(ctx):
    return spans.per(ctx, "self_ms", ["qwen3_tts.engine.dispatch",
                                        "qwen3_tts.engine.collect"],
                     frames=False)
