"""Weight-only affine quantization: pack/unpack and the plain dequant.

Layout (the JAX package's, MLX-compatible): a weight ``W[out, in]`` is
stored per output row in groups of ``G`` along the input dimension as

    W[o, g*G + j]  ≈  scale[o, g] * q[o, g*G + j] + bias[o, g]

with ``q`` uint8 codes and f32 ``scale``/``bias``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

QuantParams = dict[str, Any]  # {"q": uint8 [out,in], "scale","bias": [out, in/G]}


def is_quantized(p: dict) -> bool:
    """True for a quantized-linear param dict. An attention block also has
    a key named "q" (the query projection), so the structure is checked."""
    return (
        "q" in p
        and "scale" in p
        and "bias" in p
        and not isinstance(p["q"], dict)
    )


def quantize_weights(
    w: np.ndarray, group_size: int = 64, bits: int = 8
) -> QuantParams:
    """Affine per-group quantization of ``w[out, in]`` (numpy, load-time):
    uint8 codes + float32 scale/bias per (row, group), from min/max."""
    w = np.asarray(w, dtype=np.float32)
    out_dim, in_dim = w.shape
    if in_dim % group_size:
        raise ValueError(f"in_dim {in_dim} not divisible by {group_size}")
    n_groups = in_dim // group_size
    levels = (1 << bits) - 1

    grouped = w.reshape(out_dim, n_groups, group_size)
    w_min = grouped.min(axis=-1)
    w_max = grouped.max(axis=-1)
    scale = (w_max - w_min) / levels
    scale = np.where(scale == 0.0, 1e-8, scale)
    bias = w_min

    q = np.clip(np.round((grouped - bias[..., None]) / scale[..., None]), 0, levels)
    return {
        "q": q.reshape(out_dim, in_dim).astype(np.uint8),
        "scale": scale.astype(np.float32),
        "bias": bias.astype(np.float32),
    }


def dequantize(p: QuantParams, dtype=torch.bfloat16) -> torch.Tensor:
    """Plain dequantization -> dense ``[..., out, in]`` tensor, formed in f32
    and rounded once to ``dtype`` (leading stacked-layer dims pass through)."""
    q = torch.as_tensor(p["q"])
    scale = torch.as_tensor(p["scale"]).float()
    bias = torch.as_tensor(p["bias"]).float()
    *lead, out_dim, in_dim = q.shape
    n_groups = scale.shape[-1]
    w = q.float().reshape(*lead, out_dim, n_groups, in_dim // n_groups)
    w = w * scale[..., None] + bias[..., None]
    return w.reshape(*lead, out_dim, in_dim).to(dtype)


def unpack_mlx_uint32(packed, bits: int, in_dim: int | None = None) -> torch.Tensor:
    """MLX's uint32-packed codes -> uint8 codes, ``32 / bits`` per word,
    little-endian within the word (element i in bits [i*bits, (i+1)*bits)),
    cut to ``in_dim`` along the last axis. At 8 bits this is a byte view."""
    if bits not in (2, 4, 8):
        raise ValueError(f"unpack_mlx_uint32: bits={bits}, expected 2, 4 or 8")
    packed = torch.as_tensor(packed)
    if packed.dtype != torch.uint32:
        packed = torch.from_numpy(
            np.ascontiguousarray(packed.numpy().astype(np.uint32)))
    packed = packed.contiguous()
    if bits == 8:
        codes = packed.view(torch.uint8)
    else:
        words = packed.numpy()
        parts = [((words >> (bits * i)) & ((1 << bits) - 1)).astype(np.uint8)
                 for i in range(32 // bits)]
        codes = torch.from_numpy(
            np.stack(parts, axis=-1).reshape(*words.shape[:-1], -1))
    return codes if in_dim is None else codes[..., :in_dim]


def dequantize_tree(params, dtype=torch.bfloat16):
    """Replace every quantized linear in a param tree by a dense ``{"w"}``
    dict of ``dtype`` (the bf16 compute format)."""

    def convert(node):
        if isinstance(node, dict):
            if is_quantized(node):
                return {"w": dequantize(node, dtype=dtype)}
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(convert(v) for v in node)
        return node

    return convert(params)
