"""The port's ops (qwen3_tts_tpu_torch.ops) against the JAX package's:
quantization, both int8 matmuls' plain versions against the JAX XLA
references and the Pallas kernels in interpret mode, every ``linear``
branch, and PCM. The CUDA kernels are held against these plain versions in
tests/test_torch_kernels.py and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu.ops import quant as jq
from qwen3_tts_tpu.ops.grouped_qmv import (
    pack_grouped as jax_pack_grouped,
    quantized_matmul_grouped as jax_grouped_pallas,
    quantized_matmul_grouped_xla,
)
from qwen3_tts_tpu.ops.linear import linear as jax_linear
from qwen3_tts_tpu.ops.linear import quantized_matmul_xla
from qwen3_tts_tpu.ops.pallas_matmul import quantized_matmul_pallas
from qwen3_tts_tpu.ops.pcm import wav_to_pcm16 as jax_wav_to_pcm16
from qwen3_tts_tpu_torch.ops import quant as tq
from qwen3_tts_tpu_torch.ops.dequant_matmul import (
    quantized_matmul,
    quantized_matmul_ref,
)
from qwen3_tts_tpu_torch.ops.grouped_qmv import (
    pack_grouped,
    pack_grouped_tree,
    quantized_matmul_grouped,
    quantized_matmul_grouped_ref,
)
from qwen3_tts_tpu_torch.ops.linear import linear
from qwen3_tts_tpu_torch.ops.pcm import pcm16_to_f32, wav_to_pcm16

# f32 parity of the matmuls: same products, different summation order
RTOL, ATOL = 1e-5, 1e-4


def _quant(rng, n, k, gs):
    w = rng.normal(size=(n, k)).astype(np.float32)
    return w, jq.quantize_weights(w, group_size=gs)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def test_quantize_weights_equal():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(48, 96)).astype(np.float32)
    w[3, :32] = 0.25  # a constant group: the 1e-8 scale floor
    for gs in (16, 32):
        ref = jq.quantize_weights(w, group_size=gs)
        got = tq.quantize_weights(w, group_size=gs)
        for key in ("q", "scale", "bias"):
            np.testing.assert_array_equal(got[key], ref[key])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_equal(dtype):
    rng = np.random.default_rng(1)
    _, p = _quant(rng, 3 * 32, 64, 16)
    stacked = {k: v.reshape(3, 32, -1) for k, v in p.items()}
    ref = np.asarray(jq.dequantize(stacked, dtype=getattr(jnp, dtype)),
                     dtype=np.float32)
    got = tq.dequantize({k: _t(v) for k, v in stacked.items()},
                        dtype=getattr(torch, dtype)).float().numpy()
    np.testing.assert_array_equal(got, ref)


def test_dequantize_tree_converts_only_quantized():
    rng = np.random.default_rng(2)
    _, p = _quant(rng, 16, 32, 16)
    tree = {"attn": {"q": {k: _t(v) for k, v in p.items()},
                     "q_norm": torch.ones(4)}, "list": [torch.zeros(2)]}
    out = tq.dequantize_tree(tree, dtype=torch.float32)
    assert set(out["attn"]["q"]) == {"w"}
    assert out["attn"]["q_norm"] is tree["attn"]["q_norm"]
    assert out["list"][0] is tree["list"][0]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_pack_grouped_equal(as_tensor):
    rng = np.random.default_rng(3)
    q = rng.integers(0, 255, size=(4, 64, 32), dtype=np.uint8)
    p = {"q": q,
         "scale": rng.normal(size=(4, 64, 2)).astype(np.float32),
         "bias": rng.normal(size=(4, 64, 2)).astype(np.float32),
         "b": np.arange(64, dtype=np.float32)}
    ref = jax_pack_grouped(p)
    src = {k: _t(v) for k, v in p.items()} if as_tensor else p
    got = pack_grouped(src)
    for key in ("qg", "sg", "bg", "b"):
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(ref[key]))
    if as_tensor:
        assert all(got[k].is_contiguous() for k in ("qg", "sg", "bg"))


@pytest.mark.parametrize("m_shape", [(1, 128), (3, 128), (2, 5, 128),
                                     (100, 128)])
def test_grouped_plain_matches_jax_xla(m_shape):
    """Including the M > 64 dense route."""
    rng = np.random.default_rng(4)
    _, p = _quant(rng, 96, 128, 32)
    gp = jax_pack_grouped(p)
    x = rng.normal(size=m_shape).astype(np.float32)
    ref = quantized_matmul_grouped_xla(jnp.asarray(x), gp["qg"], gp["sg"],
                                       gp["bg"])
    got = quantized_matmul_grouped_ref(_t(x), _t(gp["qg"]), _t(gp["sg"]),
                                       _t(gp["bg"]))
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m_shape", [(1, 256), (2, 5, 256)])
def test_grouped_plain_matches_jax_pallas_interpret(m_shape):
    rng = np.random.default_rng(5)
    _, p = _quant(rng, 256, 256, 64)
    gp = jax_pack_grouped(p)
    x = rng.normal(size=m_shape).astype(np.float32)
    ref = jax_grouped_pallas(jnp.asarray(x), jnp.asarray(gp["qg"]),
                             jnp.asarray(gp["sg"]), jnp.asarray(gp["bg"]),
                             interpret=True)
    got = quantized_matmul_grouped(_t(x), _t(gp["qg"]), _t(gp["sg"]),
                                   _t(gp["bg"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m_shape", [(1, 128), (2, 3, 128), (70, 128)])
def test_rowmajor_plain_matches_jax_xla(m_shape):
    rng = np.random.default_rng(6)
    _, p = _quant(rng, 128, 128, 32)
    x = rng.normal(size=m_shape).astype(np.float32)
    ref = quantized_matmul_xla(jnp.asarray(x), p["q"], p["scale"], p["bias"])
    got = quantized_matmul_ref(_t(x), _t(p["q"]), _t(p["scale"]), _t(p["bias"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_rowmajor_plain_matches_jax_pallas_interpret():
    rng = np.random.default_rng(7)
    _, p = _quant(rng, 256, 128, 64)
    x = rng.normal(size=(3, 128)).astype(np.float32)
    ref = quantized_matmul_pallas(jnp.asarray(x), jnp.asarray(p["q"]),
                                  jnp.asarray(p["scale"]),
                                  jnp.asarray(p["bias"]), interpret=True)
    got = quantized_matmul(_t(x), _t(p["q"]), _t(p["scale"]), _t(p["bias"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def _linear_params(branch, rng):
    n, k = 48, 64
    w, p = _quant(rng, n, k, 16)
    if branch == "dense":
        return {"w": w}
    if branch == "grouped":
        return jax_pack_grouped(p)
    if branch == "lora":
        return {**p, "lora_a": rng.normal(size=(4, k)).astype(np.float32),
                "lora_b": rng.normal(size=(n, 4)).astype(np.float32),
                "lora_scale": np.float32(0.5)}
    if branch == "bias":
        return {**jax_pack_grouped(p), "b": rng.normal(size=(n,)).astype(np.float32)}
    return p


@pytest.mark.parametrize("branch", ["dense", "rowmajor", "grouped", "lora", "bias"])
def test_linear_branches_match_jax(branch):
    rng = np.random.default_rng(8)
    params = _linear_params(branch, rng)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    ref = jax_linear(jnp.asarray(x), params)
    got = linear(_t(x), {k: _t(v) for k, v in params.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_pack_grouped_tree_keeps_other_leaves():
    rng = np.random.default_rng(9)
    _, p = _quant(rng, 16, 32, 16)
    tree = {"blocks": {"attn": {"q": {"w": torch.ones(4, 4)}},
                       "mlp": {k: _t(v) for k, v in p.items()}},
            "norm": torch.ones(4)}
    out = pack_grouped_tree(tree)
    assert set(out["blocks"]["mlp"]) == {"qg", "sg", "bg"}
    assert out["blocks"]["attn"]["q"]["w"] is tree["blocks"]["attn"]["q"]["w"]
    assert out["norm"] is tree["norm"]


def test_pcm_equal():
    edges = np.array([k / 32767.0 for k in range(-40, 41)], np.float32)
    halves = np.array([(k + 0.5) / 32767.0 for k in range(-40, 40)], np.float32)
    rng = np.random.default_rng(10)
    x = np.concatenate([edges, halves, np.nextafter(halves, 2.0),
                        np.nextafter(halves, -2.0), [-1.5, -1.0, 1.0, 1.5, 0.0],
                        rng.uniform(-1.2, 1.2, 2000)]).astype(np.float32)
    ref = np.asarray(jax_wav_to_pcm16(jnp.asarray(x)))
    got = wav_to_pcm16(_t(x)).numpy()
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, ref)
    ints = np.arange(-32767, 32768, 97, dtype=np.int16)
    np.testing.assert_array_equal(
        wav_to_pcm16(_t(pcm16_to_f32(ints))).numpy(), ints)
