"""The share of the program's attention calls that ran kernel C in the
profiled slice, in %: 100 x the ``qwen3_tts.kernel.decode_attention`` spans
(``ops/decode_attention.py::decode_attention_cuda``) over the
``qwen3_tts.model.attention`` spans (every attention of the talker, the
code predictor and code2wav's transformer; ``harness/spans.py``). 0 where
attention ran and kernel C did not; nothing where the program has no
kernel C (no ``qwen3_tts_tpu_torch.ops.decode_attention``) or the slice
holds no attention span."""

import importlib.util

from harness import spans


def read(ctx):
    s = spans.of(ctx)
    if s is None or importlib.util.find_spec(
            "qwen3_tts_tpu_torch.ops.decode_attention") is None:
        return None
    calls = s["calls"]
    total = calls.get("qwen3_tts.model.attention")
    kernel = calls.get("qwen3_tts.kernel.decode_attention", 0)
    return 100.0 * kernel / total if total else None
