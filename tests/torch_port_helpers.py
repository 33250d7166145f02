"""Shared inputs of the tests that hold qwen3_tts_tpu_torch against the JAX
package (tests/test_torch_*.py)."""

import dataclasses

import pytest

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


def leaf_bits(tree) -> dict:
    """{path: (dtype name, shape, raw bytes)} of every leaf of a JAX numpy
    tree or a port tensor tree; bf16 leaves through a uint16 view, so equal
    entries mean bit-identical leaves."""
    import numpy as np
    import torch

    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}{k}/")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}{i}/")
        elif isinstance(node, torch.Tensor):
            t = node.detach().cpu().contiguous()
            raw = t.view(torch.uint16) if t.dtype == torch.bfloat16 else t
            out[path[:-1]] = (str(t.dtype).replace("torch.", ""),
                              tuple(t.shape), raw.numpy().tobytes())
        else:
            a = np.ascontiguousarray(np.asarray(node))
            raw = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
            out[path[:-1]] = (a.dtype.name, a.shape, raw.tobytes())

    walk(tree, "")
    return out


def assert_trees_equal(got, want) -> None:
    """Same leaf paths, dtypes, shapes and bits."""
    g, w = leaf_bits(got), leaf_bits(want)
    assert sorted(g) == sorted(w), (sorted(set(g) ^ set(w)))[:10]
    bad = [(k, g[k][:2], w[k][:2]) for k in w if g[k] != w[k]]
    assert not bad, f"{len(bad)} leaves differ, e.g. {bad[:5]}"


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one intra-op thread for a module, restored after. The suite
    runs several workers on the CPU: torch's default thread per core then
    spins against the other workers, and a module of many small ops (a
    Whisper window is 224 decode steps) runs many times slower."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
