"""Milliseconds a step that the engine thread spent blocked on the card
in the profiled slice: the program's ``qwen3_tts.engine.host_wait`` spans
(the wait for a step's host copy inside ``collect_step``), inclusive, over
the engine steps dispatched in the slice (``harness/spans.py``)."""

from harness import spans


def read(ctx):
    return spans.per(ctx, "host_ms", ["qwen3_tts.engine.host_wait"],
                     frames=False)
