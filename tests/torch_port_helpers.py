"""Shared inputs of the tests that hold qwen3_tts_tpu_torch against the JAX
package (tests/test_torch_*.py)."""

import dataclasses

# The initialiser's conv gain grows the tiny codec's activations to ~1e2
# before the final tanh: the waveform clips, and float32 summation order
# alone then moves unclipped samples by ~1e-4 (3 LSB at int16). Scaling the
# decoder's conv weights by 0.6 keeps activations O(1) and the waveform
# unclipped (max |w| ~0.5), so the comparison sees the whole signal.
CODEC_CONV_SCALE = 0.6


def tiny_f32(configs_module, **cp_changes):
    """The tiny int8 config at float32 (optionally with code-predictor
    fields changed), from either package's engine.configs."""
    cfg = dataclasses.replace(configs_module.tiny(quant=True), dtype="float32")
    if cp_changes:
        cfg = dataclasses.replace(cfg, code_predictor=dataclasses.replace(
            cfg.code_predictor, **cp_changes))
    return cfg


def tame_codec(codec_np: dict, factor: float = CODEC_CONV_SCALE) -> dict:
    """A copy of a numpy codec tree with every decoder conv weight scaled."""
    dec = codec_np["dec"]

    def conv(p):
        return {**p, "w": p["w"] * factor}

    return {**codec_np, "dec": {
        **dec,
        "in_proj": conv(dec["in_proj"]),
        "out_conv": conv(dec["out_conv"]),
        "stages": [{"up": conv(s["up"]),
                    "res": {c: conv(s["res"][c]) for c in ("c1", "c2")}}
                   for s in dec["stages"]],
    }}
