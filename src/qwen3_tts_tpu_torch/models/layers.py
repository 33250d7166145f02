"""Shared transformer building blocks (Qwen3-style), in PyTorch.

RMSNorm (pre-norm), grouped-query attention with per-head QK RMSNorm,
rotate-half RoPE, SwiGLU MLPs. Functions of (param dict, tensors); the
quantized/dense distinction is hidden behind ``ops.linear``. Attention is
plain tensor code (einsum + masked softmax in f32), as the JAX package
keeps it outside any kernel.

Shape conventions (the JAX package's):
  x          [B, T, D]
  q/k/v      [B, T, H, hd]
  KV cache   [B, S, H_kv, hd] per layer
  cos/sin    [T, hd/2] (already sliced to the query positions)

The KV cache is written IN PLACE at ``pos`` (the JAX functions return an
updated copy; here the returned cache tensors are the inputs, updated).
``pos`` and ``pad_len`` are Python ints (one utterance: every row at the
same offset) or ``[B]`` tensors (continuous batched serving: each row at
its own offset).
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.linear import linear


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


@lru_cache(maxsize=16)
def rope_tables(
    max_len: int, head_dim: int, theta: float, device="cpu"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate-half RoPE tables: cos/sin [max_len, head_dim/2] float32
    (cached per shape and device; treat as read-only)."""
    half = head_dim // 2
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, half, dtype=torch.float32) / float(half))
    )
    t = torch.arange(max_len, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs).to(device), torch.sin(freqs).to(device)


def kv_env_format() -> str:
    """The KV cache format knob QWEN3_TTS_KV: dense (the default) or int8,
    whose ``KVQuant`` cache waits for ROADMAP queue A, item 11."""
    v = os.environ.get("QWEN3_TTS_KV", "").strip().lower()
    if v in ("", "0", "dense", "bf16"):
        return "dense"
    if v == "int8":
        raise NotImplementedError(
            "QWEN3_TTS_KV=int8 (the KVQuant int8 KV cache) waits for ROADMAP "
            "queue A, item 11")
    raise ValueError(f"QWEN3_TTS_KV={v!r}: expected 'int8' or 'dense'")


def rope_slice(cos_table, sin_table, pos, T: int):
    """Tables for T query positions starting at ``pos``: a scalar gives
    [T, hd/2] slices; a [B] tensor gives per-row [B, T, hd/2] rows,
    positions past the table clamped to its last row (the JAX package's
    ``mode="clip"`` gather)."""
    if isinstance(pos, torch.Tensor):
        idx = pos[:, None] + torch.arange(T, device=pos.device)[None, :]
        idx = idx.clamp(0, cos_table.shape[0] - 1)
        return cos_table[idx], sin_table[idx]
    return cos_table[pos:pos + T], sin_table[pos:pos + T]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate-half RoPE on x [B, T, H, hd] with cos/sin [T, hd/2] (shared
    positions) or [B, T, hd/2] (per-row positions)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)       # [(B,) T, 1, hd/2]
    s = sin[..., None, :].to(x.dtype)
    return torch.cat((x1 * c - x2 * s, x2 * c + x1 * s), dim=-1)


class AttnOut(NamedTuple):
    out: torch.Tensor          # [B, T, D]
    cache_k: torch.Tensor      # [B, S, H_kv, hd], updated in place
    cache_v: torch.Tensor


def _scores_ctx(qg, keys, values, qry_idx: torch.Tensor, pad_b, head_dim: int,
                out_dtype) -> torch.Tensor:
    """Masked GQA attention read over a cache: qg [B, T, H_kv, g, hd],
    keys/values [B, S, H_kv, hd] -> ctx [B, T, H_kv, g, hd]. Keys are
    allowed where ``pad_b <= key <= qry_idx`` (qry_idx [B|1, T, 1], pad_b
    an int or [B, 1, 1]); padded queries may attend to themselves. Scores
    and softmax in f32; probabilities rounded to the cache type before the
    value product (f32 accumulation), as in the JAX package."""
    S = keys.shape[1]
    scores = torch.einsum("bthgd,bshd->bhgts", qg.float(), keys.float())
    scores = scores * (head_dim ** -0.5)
    key_idx = torch.arange(S, device=qg.device)[None, None, :]   # [1, 1, S]
    allowed = ((key_idx <= qry_idx) & (key_idx >= pad_b)) | (key_idx == qry_idx)
    scores = scores.masked_fill(~allowed[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(values.dtype)
    return torch.einsum(
        "bhgts,bshd->bthgd", probs.float(), values.float()
    ).to(out_dtype)


def _write_rows(cache: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write new [B, T, ...] into cache [B, S, ...] at ``pos`` in place. A
    [B] ``pos`` writes each row at its own offset, clamped to [0, S - T]
    as ``jax.lax.dynamic_update_slice`` clamps (a serving slot that is not
    decoding holds a stale position and rewrites its own last rows)."""
    T = new.shape[1]
    if not isinstance(pos, torch.Tensor):
        cache[:, pos:pos + T] = new
        return
    B, S = cache.shape[:2]
    start = pos.clamp(0, S - T)[:, None]
    rows = start + torch.arange(T, device=pos.device)[None, :]     # [B, T]
    batch = torch.arange(B, device=pos.device)[:, None].expand(B, T)
    cache.index_put_((batch, rows), new)


def attention(
    p: dict,
    x: torch.Tensor,
    *,
    cos: torch.Tensor,
    sin: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rms_eps: float,
    qk_norm: bool = True,
    pad_len=0,
    window_split: tuple | None = None,
) -> AttnOut:
    """GQA attention with a KV-cache write at offset ``pos`` (prefill T > 1
    or decode T == 1). Queries attend over the whole cache with the mask
    ``pad_len <= key <= pos + query``; padded queries may attend to
    themselves, to keep the softmax finite. ``pos``/``pad_len``: ints, or
    [B] tensors with per-row cos/sin [B, T, hd/2].

    ``window_split`` (serving): (rows, window) pairs over contiguous row
    groups; group g's queries read only the first ``window`` cache rows.
    The projections stay whole-batch; only the attention read splits."""
    B, T, _ = x.shape
    groups = n_heads // n_kv_heads
    if "qkv" in p:  # fused projection (fuse_block_projections)
        q_dim = n_heads * head_dim
        kv_dim = n_kv_heads * head_dim
        qkv = linear(x, p["qkv"])
        q = qkv[..., :q_dim].reshape(B, T, n_heads, head_dim)
        k = qkv[..., q_dim:q_dim + kv_dim].reshape(B, T, n_kv_heads, head_dim)
        v = qkv[..., q_dim + kv_dim:].reshape(B, T, n_kv_heads, head_dim)
    else:
        q = linear(x, p["q"]).reshape(B, T, n_heads, head_dim)
        k = linear(x, p["k"]).reshape(B, T, n_kv_heads, head_dim)
        v = linear(x, p["v"]).reshape(B, T, n_kv_heads, head_dim)

    if qk_norm:  # per-head RMSNorm over head_dim (Qwen3)
        q = rmsnorm(q, p["q_norm"], rms_eps)
        k = rmsnorm(k, p["k_norm"], rms_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    _write_rows(cache_k, k.to(cache_k.dtype), pos)
    _write_rows(cache_v, v.to(cache_v.dtype), pos)

    qg = q.reshape(B, T, n_kv_heads, groups, head_dim)
    steps = torch.arange(T, device=x.device)
    if isinstance(pos, torch.Tensor):
        qry_idx = (pos[:, None] + steps[None, :])[:, :, None]    # [B, T, 1]
    else:
        qry_idx = (pos + steps)[None, :, None]                   # [1, T, 1]
    pad_b = pad_len[:, None, None] if isinstance(pad_len, torch.Tensor) \
        else pad_len
    if window_split is None:
        ctx = _scores_ctx(qg, cache_k, cache_v, qry_idx, pad_b, head_dim,
                          x.dtype)
    else:
        parts = []
        lo = 0
        for size, win in window_split:
            hi = lo + size
            rows = slice(lo, hi)
            parts.append(_scores_ctx(
                qg[rows], cache_k[rows, :win], cache_v[rows, :win],
                qry_idx[rows] if qry_idx.shape[0] == B else qry_idx,
                pad_b[rows] if isinstance(pad_b, torch.Tensor) else pad_b,
                head_dim, x.dtype))
            lo = hi
        if lo != B:
            raise ValueError(f"window_split {window_split} covers {lo} of "
                             f"{B} rows")
        ctx = torch.cat(parts, dim=0)
    ctx = ctx.reshape(B, T, n_heads * head_dim)
    return AttnOut(linear(ctx, p["o"]), cache_k, cache_v)


def swiglu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "gate_up" in p:  # fused [gate; up] projection
        gate, up = linear(x, p["gate_up"]).chunk(2, dim=-1)
    else:
        gate = linear(x, p["gate"])
        up = linear(x, p["up"])
    return linear(F.silu(gate) * up, p["down"])


def _concat_linears(parts: list[dict]) -> dict:
    """Concatenate linear param dicts along the output dimension (dense
    ``w`` or quantized ``q``/``scale``/``bias``, stacked axes included):
    row r of a product depends on row r of the weight alone, so the fused
    product equals the separate ones."""
    keys = set(parts[0])
    for p in parts[1:]:
        if set(p) != keys:
            raise ValueError(
                f"cannot fuse linears with differing layouts: {sorted(keys)} "
                f"vs {sorted(set(p))}"
            )
    if {"lora_a", "lora_b"} & keys:
        raise ValueError("cannot fuse linears carrying unmerged LoRA adapters")
    return {k: torch.cat([p[k] for p in parts], dim=-2) for k in keys}


def fuse_block_projections(blocks: dict) -> dict:
    """Copy of stacked block params with q/k/v fused into ``qkv`` and
    gate/up into ``gate_up`` (attention/swiglu_mlp dispatch on the fused
    keys)."""
    attn = dict(blocks["attn"])
    mlp = dict(blocks["mlp"])
    attn["qkv"] = _concat_linears([attn.pop("q"), attn.pop("k"), attn.pop("v")])
    mlp["gate_up"] = _concat_linears([mlp.pop("gate"), mlp.pop("up")])
    out = dict(blocks)
    out["attn"] = attn
    out["mlp"] = mlp
    return out


def unstack_layers(blocks) -> list[dict]:
    """Stacked block params ``[L, ...]`` -> a list of per-layer param dicts
    (views). A list passes through."""
    if isinstance(blocks, list):
        return blocks

    def first_leaf(node):
        return first_leaf(next(iter(node.values()))) if isinstance(node, dict) else node

    def index(node, i):
        if isinstance(node, dict):
            return {k: index(v, i) for k, v in node.items()}
        return node[i]

    return [index(blocks, i) for i in range(first_leaf(blocks).shape[0])]


def transformer_block(
    p: dict,
    x: torch.Tensor,
    *,
    cos: torch.Tensor,
    sin: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rms_eps: float,
    qk_norm: bool = True,
    pad_len=0,
    window_split: tuple | None = None,
) -> torch.Tensor:
    """Pre-norm residual block: x + Attn(LN(x)); x + MLP(LN(x)). Writes this
    block's keys/values into ``cache_k``/``cache_v`` in place."""
    attn_out = attention(
        p["attn"], rmsnorm(x, p["ln1"], rms_eps),
        cos=cos, sin=sin, cache_k=cache_k, cache_v=cache_v, pos=pos,
        n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
        rms_eps=rms_eps, qk_norm=qk_norm, pad_len=pad_len,
        window_split=window_split,
    )
    x = x + attn_out.out
    return x + swiglu_mlp(p["mlp"], rmsnorm(x, p["ln2"], rms_eps))
