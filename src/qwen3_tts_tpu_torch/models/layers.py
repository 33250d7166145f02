"""Shared transformer building blocks (Qwen3-style), in PyTorch.

RMSNorm (pre-norm), grouped-query attention with per-head QK RMSNorm,
rotate-half RoPE, SwiGLU MLPs. Functions of (param dict, tensors); the
quantized/dense distinction is hidden behind ``ops.linear``.

Attention's plain code (einsum + masked softmax in f32, ``_attend_plain``)
is the JAX package's, which keeps attention outside any kernel. On the
card, a bf16 decode call (T <= 2) over a dense bf16 cache with no autograd
and no mesh takes kernel C instead (``ops/decode_attention.py``): norm,
RoPE, cache write and the masked read in one launch, with the plain code's
roundings. The choice reads only what the call can observe
(``_takes_decode_kernel``; a call of the kernel's kind that it cannot take
is counted as declined); the CPU, float32, the int8 cache, training,
calls of T > 2 (prefill, the cold batch, the rvq codec's transformer) and
meshes keep the plain code.

Shape conventions (the JAX package's):
  x          [B, T, D]
  q/k/v      [B, T, H, hd]
  KV cache   [B, S, H_kv, hd] per layer (or a ``KVQuant`` pair, int8)
  cos/sin    [T, hd/2] (already sliced to the query positions)

The KV cache is written IN PLACE at ``pos`` (the JAX functions return an
updated copy; here the returned cache tensors are the inputs, updated).
``pos`` and ``pad_len`` are Python ints (one utterance: every row at the
same offset) or ``[B]`` tensors (continuous batched serving: each row at
its own offset).

Under tensor parallelism (``mesh`` given, ``parallel/``) the blocks hold
this rank's heads and ffn slice: callers pass the LOCAL head counts, the
input of the q/k/v and gate/up projections passes ``comm.copy_to_tp``
(its grad sums over tp) and the o and down projections' partial outputs
are summed over the tp group before the residual add. With ``sp``
(sequence parallelism, training) the residual stream is this rank's T
slice: the projections' input is all-gathered along T
(``comm.gather_seq``) and the o and down outputs reduce-scattered back
(``comm.scatter_seq``); the cache and the attention read span the whole
sequence.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.cuda_kernels import DECODE_ATTENTION
from ..ops.decode_attention import HEAD_DIM, decode_attention_cuda, fits
from ..ops.linear import linear
from ..parallel.comm import copy_to_tp, gather_seq
from ..profiling import trace


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


class KVQuant:
    """int8 KV cache leaf pair: codes ``q`` int8 [..., S, H_kv, hd] and a
    symmetric per-(position, kv-head) scale ``s`` f32 [..., S, H_kv, 1].

    The scale keeps the codes' rank, so every piece of cache plumbing
    applies to both leaves alike: indexing returns a ``KVQuant`` of views
    of both (writes through it land in the cache), and assigning a
    ``KVQuant`` to an index assigns both leaves (the torch form of the
    JAX package's ``jax.tree.map`` over the pair). ``shape``, ``dtype`` and
    ``device`` are the codes'."""

    __slots__ = ("q", "s")

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        self.q, self.s = q, s

    def __getitem__(self, idx) -> "KVQuant":
        return KVQuant(self.q[idx], self.s[idx])

    def __setitem__(self, idx, value: "KVQuant") -> None:
        self.q[idx] = value.q
        self.s[idx] = value.s

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.q.dtype

    @property
    def device(self) -> torch.device:
        return self.q.device


def kv_env_format() -> str:
    """The KV cache format knob QWEN3_TTS_KV: dense (the default) or int8."""
    v = os.environ.get("QWEN3_TTS_KV", "").strip().lower()
    if v in ("", "0", "dense", "bf16"):
        return "dense"
    if v == "int8":
        return "int8"
    raise ValueError(f"QWEN3_TTS_KV={v!r}: expected 'int8' or 'dense'")


def kv_cache_init(shape: tuple, dtype, kv_format: str | None = None,
                  device="cpu"):
    """One zeroed KV cache buffer: dense [..., S, H_kv, hd] of ``dtype``, or
    a ``KVQuant`` pair when ``kv_format`` (default: QWEN3_TTS_KV) is int8.
    Zero scales dequantize unwritten rows to exact zeros, as the dense
    init (those rows are position-masked anyway)."""
    fmt = kv_env_format() if kv_format is None else kv_format
    if fmt == "int8":
        return KVQuant(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros((*shape[:-1], 1), dtype=torch.float32,
                                   device=device))
    return torch.zeros(shape, dtype=dtype, device=device)


def kv_quantize(x: torch.Tensor) -> KVQuant:
    """Symmetric per-(position, head) int8 quantization over head_dim."""
    xf = x.float()
    s = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return KVQuant(q, s)


def kv_dequantize(c: KVQuant, dtype) -> torch.Tensor:
    # int8 values are exact in f32; one rounding on the downcast
    return (c.q.float() * c.s).to(dtype)


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
    cache_k: torch.Tensor      # [B, S, H_kv, hd] or KVQuant, updated in place
    cache_v: torch.Tensor


def _row_scale(c: KVQuant) -> torch.Tensor:
    """Per-row scales [B, S, H_kv, 1] -> [B, H_kv, 1, 1, S], broadcast over
    scores/probabilities [B, H_kv, g, T, S]."""
    return c.s.permute(0, 2, 3, 1)[:, :, :, None, :]


def _scores_ctx(qg, keys, values, qry_idx: torch.Tensor, pad_b, head_dim: int,
                out_dtype) -> torch.Tensor:
    """Masked GQA attention read over a cache: qg [B, T, H_kv, g, hd],
    keys/values [B, S, H_kv, hd] (dense or ``KVQuant``) -> ctx
    [B, T, H_kv, g, hd]. Keys are allowed where ``pad_b <= key <= qry_idx``
    (qry_idx [B|1, T, 1], pad_b an int or [B, 1, 1]); padded queries may
    attend to themselves. Scores and softmax in f32; probabilities rounded
    to the cache type before the value product (f32 accumulation), as in
    the JAX package.

    An int8 cache is read scale-factored, with no dequantized buffer: the
    row scale is constant over head_dim, so ``q·(k_q·s) = (q·k_q)·s`` on
    the scores and ``Σ p·(v_q·s) = Σ (p·s)·v_q`` on the context, ``p·s``
    rounded to the query's dtype (the JAX package's order)."""
    k_quant = isinstance(keys, KVQuant)
    S = keys.shape[1]
    scores = torch.einsum("bthgd,bshd->bhgts", qg.float(),
                          (keys.q if k_quant else keys).float())
    if k_quant:
        scores = scores * _row_scale(keys)
    scores = scores * (head_dim ** -0.5)
    key_idx = torch.arange(S, device=qg.device)[None, None, :]   # [1, 1, S]
    allowed = ((key_idx <= qry_idx) & (key_idx >= pad_b)) | (key_idx == qry_idx)
    scores = scores.masked_fill(~allowed[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    if isinstance(values, KVQuant):
        probs = (probs * _row_scale(values)).to(qg.dtype)
        v_mat = values.q
    else:
        probs = probs.to(values.dtype)
        v_mat = values
    return torch.einsum(
        "bhgts,bshd->bthgd", probs.float(), v_mat.float()
    ).to(out_dtype)


def _write_rows(cache, new: torch.Tensor, pos) -> None:
    """Write new [B, T, ...] into cache [B, S, ...] at ``pos`` in place,
    quantized first when the cache is a ``KVQuant``. A [B] ``pos`` writes
    each row at its own offset, clamped to [0, S - T] as
    ``jax.lax.dynamic_update_slice`` clamps (a serving slot that is not
    decoding holds a stale position and rewrites its own last rows)."""
    if isinstance(cache, KVQuant):
        new = kv_quantize(new)
        pairs = ((cache.q, new.q), (cache.s, new.s))
    else:
        pairs = ((cache, new.to(cache.dtype)),)
    T = new.shape[1]
    if not isinstance(pos, torch.Tensor):
        for c, u in pairs:
            c[:, pos:pos + T] = u
        return
    B, S = cache.shape[:2]
    start = pos.clamp(0, S - T)[:, None]
    rows = start + torch.arange(T, device=pos.device)[None, :]     # [B, T]
    batch = torch.arange(B, device=pos.device)[:, None].expand(B, T)
    for c, u in pairs:
        c.index_put_((batch, rows), u)


class WindowSplit(tuple):
    """A ``window_split`` (its (rows, window) pairs, a tuple as any other)
    that keeps its per-row window table for kernel C: made on the device at
    the first call and reused, so the serving engine, which makes one a
    decode function, copies nothing to the card per call."""

    def table(self, batch: int, device) -> torch.Tensor:
        """The window of each of ``batch`` rows, int64 on ``device``."""
        t = self.__dict__.get("_table")
        if t is None or t.device != device:
            wins = [w for size, w in self for _ in range(size)]
            if len(wins) != batch:
                raise ValueError(f"window_split {tuple(self)} covers "
                                 f"{len(wins)} of {batch} rows")
            t = self._table = torch.tensor(wins, dtype=torch.int64,
                                           device=device)
        return t


def _max_window(window_split, S: int) -> int:
    """The widest window a call reads: its split's widest, at most S."""
    return S if window_split is None else min(max(w for _, w in window_split),
                                              S)


def _takes_decode_kernel(q, k, v, norms: tuple, cache_k, cache_v, pos, pad_len,
                         window_split, n_heads: int, n_kv_heads: int,
                         head_dim: int, mesh) -> bool:
    """Whether an attention call runs kernel C. A call of the kernel's kind
    is a bf16 decode (q [B, T <= 2, ...]) on the card over a dense bf16
    cache, with no autograd and no mesh; the kernel takes it where it is
    written for it (head_dim 128, bf16 norm weights, int64 row positions or
    an int ``pos`` inside the cache, and T * g score rows over the widest
    window within the card's shared memory). A call of its kind that it
    cannot take is counted (``DECODE_ATTENTION.declined``) and keeps the
    plain code. Reads only the call's own tensors and arguments."""
    T = q.shape[1]
    if mesh is not None or T > 2 or not q.is_cuda \
            or q.dtype != torch.bfloat16:
        return False
    if isinstance(cache_k, KVQuant) or isinstance(cache_v, KVQuant) \
            or cache_k.dtype != torch.bfloat16 \
            or cache_v.dtype != torch.bfloat16:
        return False
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, *norms)):
        return False
    S = cache_k.shape[1]
    takes = head_dim == HEAD_DIM and n_heads % n_kv_heads == 0 \
        and all(w.dtype == torch.bfloat16 for w in norms) \
        and all(r.dtype == torch.int64 for r in (pos, pad_len)
                if isinstance(r, torch.Tensor)) \
        and (isinstance(pos, torch.Tensor) or 0 <= pos <= S - T) \
        and fits(T * (n_heads // n_kv_heads), _max_window(window_split, S),
                 q.get_device())
    if not takes:
        DECODE_ATTENTION.declined += 1
    return takes


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
    mesh=None,
    sp: bool = False,
) -> AttnOut:
    """GQA attention with a KV-cache write at offset ``pos`` (prefill T > 1
    or decode T == 1). Queries attend over the whole cache with the mask
    ``pad_len <= key <= pos + query``; padded queries may attend to
    themselves, to keep the softmax finite. ``pos``/``pad_len``: ints, or
    [B] tensors with per-row cos/sin [B, T, hd/2].

    ``window_split`` (serving): (rows, window) pairs over contiguous row
    groups; group g's queries read only the first ``window`` cache rows.
    The projections stay whole-batch; only the attention read splits.
    ``mesh``: the head counts are this rank's; the o projection sums over
    its tp group. ``sp``: x is this rank's T slice (module docstring).

    Between the projections the call runs kernel C or the plain code
    (module docstring)."""
    with trace("qwen3_tts.model.attention"):
        x = _tp_input(x, mesh, sp)
        if "qkv" in p:  # fused projection (fuse_block_projections)
            q_dim = n_heads * head_dim
            kv_dim = n_kv_heads * head_dim
            qkv = linear(x, p["qkv"])
            q = qkv[..., :q_dim]
            k = qkv[..., q_dim:q_dim + kv_dim]
            v = qkv[..., q_dim + kv_dim:]
        else:
            q = linear(x, p["q"])
            k = linear(x, p["k"])
            v = linear(x, p["v"])
        norms = (p["q_norm"], p["k_norm"]) if qk_norm else ()
        attend = _attend_kernel if _takes_decode_kernel(
            q, k, v, norms, cache_k, cache_v, pos, pad_len, window_split,
            n_heads, n_kv_heads, head_dim, mesh) else _attend_plain
        ctx = attend(p, q, k, v, cos=cos, sin=sin, cache_k=cache_k,
                     cache_v=cache_v, pos=pos, n_heads=n_heads,
                     n_kv_heads=n_kv_heads, head_dim=head_dim,
                     rms_eps=rms_eps, qk_norm=qk_norm, pad_len=pad_len,
                     window_split=window_split, out_dtype=x.dtype)
        return AttnOut(linear(ctx, p["o"], mesh, sp), cache_k, cache_v)


def _attend_kernel(p: dict, q, k, v, *, cos, sin, cache_k, cache_v, pos,
                   n_heads: int, n_kv_heads: int, head_dim: int,
                   rms_eps: float, qk_norm: bool, pad_len, window_split,
                   out_dtype) -> torch.Tensor:
    """``_attend_plain``'s work in one launch of kernel C, for a call that
    ``_takes_decode_kernel`` (bf16 out, head_dim 128)."""
    table = None
    if window_split is not None:
        if not isinstance(window_split, WindowSplit):  # made per call
            window_split = WindowSplit(window_split)
        table = window_split.table(q.shape[0], q.device)
    max_win = _max_window(window_split, cache_k.shape[1])
    q_norm, k_norm = (p["q_norm"], p["k_norm"]) if qk_norm else (None, None)
    return decode_attention_cuda(q, k, v, q_norm, k_norm, cos, sin, cache_k,
                                 cache_v, pos, pad_len, table, max_win,
                                 n_heads, n_kv_heads, rms_eps)


def _attend_plain(p: dict, q, k, v, *, cos, sin, cache_k, cache_v, pos,
                  n_heads: int, n_kv_heads: int, head_dim: int,
                  rms_eps: float, qk_norm: bool, pad_len, window_split,
                  out_dtype) -> torch.Tensor:
    """Attention's plain code between the projections: q [B, T, H * hd],
    k/v [B, T, H_kv * hd] -> the context [B, T, H * hd] in ``out_dtype``
    (the layer input's), with
    the per-head norm, RoPE, the cache write and the masked read
    (``attention``'s arguments)."""
    B, T, _ = q.shape
    groups = n_heads // n_kv_heads
    q = q.reshape(B, T, n_heads, head_dim)
    k = k.reshape(B, T, n_kv_heads, head_dim)
    v = v.reshape(B, T, n_kv_heads, head_dim)

    if qk_norm:  # per-head RMSNorm over head_dim (Qwen3)
        q = rmsnorm(q, p["q_norm"], rms_eps)
        k = rmsnorm(k, p["k_norm"], rms_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    _write_rows(cache_k, k, pos)
    _write_rows(cache_v, v, pos)

    qg = q.reshape(B, T, n_kv_heads, groups, head_dim)
    steps = torch.arange(T, device=q.device)
    if isinstance(pos, torch.Tensor):
        qry_idx = (pos[:, None] + steps[None, :])[:, :, None]  # [B, T, 1]
    else:
        qry_idx = (pos + steps)[None, :, None]                 # [1, T, 1]
    pad_b = pad_len[:, None, None] if isinstance(pad_len, torch.Tensor) \
        else pad_len
    if window_split is None:
        ctx = _scores_ctx(qg, cache_k, cache_v, qry_idx, pad_b, head_dim,
                          out_dtype)
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
                head_dim, out_dtype))
            lo = hi
        if lo != B:
            raise ValueError(f"window_split {window_split} covers {lo} of "
                             f"{B} rows")
        ctx = torch.cat(parts, dim=0)
    return ctx.reshape(B, T, n_heads * head_dim)


def _tp_input(x: torch.Tensor, mesh, sp: bool) -> torch.Tensor:
    """The input of column-parallel projections: the whole sequence on
    every tp rank."""
    return gather_seq(x, mesh) if sp else copy_to_tp(x, mesh)


def swiglu_mlp(p: dict, x: torch.Tensor, mesh=None,
               sp: bool = False) -> torch.Tensor:
    x = _tp_input(x, mesh, sp)
    if "gate_up" in p:  # fused [gate; up] projection
        gate, up = linear(x, p["gate_up"]).chunk(2, dim=-1)
    else:
        gate = linear(x, p["gate"])
        up = linear(x, p["up"])
    return linear(F.silu(gate) * up, p["down"], mesh, sp)


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
    (views, one ``unbind`` a leaf: under autograd its backward stacks the
    layers' gradients into the stacked leaf once, where indexing would add
    a zero-filled stack-sized gradient per layer). A list passes through."""
    if isinstance(blocks, list):
        return blocks

    def unbind(node):
        if isinstance(node, dict):
            return {k: unbind(v) for k, v in node.items()}
        return node.unbind(0)

    def index(node, i):
        if isinstance(node, dict):
            return {k: index(v, i) for k, v in node.items()}
        return node[i]

    def n_layers(node):
        return n_layers(next(iter(node.values()))) if isinstance(node, dict) \
            else len(node)

    per_leaf = unbind(blocks)
    return [index(per_leaf, i) for i in range(n_layers(per_leaf))]


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
    mesh=None,
    sp: bool = False,
) -> torch.Tensor:
    """Pre-norm residual block: x + Attn(LN(x)); x + MLP(LN(x)). Writes this
    block's keys/values into ``cache_k``/``cache_v`` in place. ``mesh``:
    a tp-sharded block (local head counts; ``attention``); ``sp``: x is
    this rank's T slice, and so is the result."""
    attn_out = attention(
        p["attn"], rmsnorm(x, p["ln1"], rms_eps),
        cos=cos, sin=sin, cache_k=cache_k, cache_v=cache_v, pos=pos,
        n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
        rms_eps=rms_eps, qk_norm=qk_norm, pad_len=pad_len,
        window_split=window_split, mesh=mesh, sp=sp,
    )
    x = x + attn_out.out
    return x + swiglu_mlp(p["mlp"], rmsnorm(x, p["ln2"], rms_eps), mesh, sp)


def run_blocks(blocks, x: torch.Tensor, *, cos, sin, n_heads: int,
               n_kv_heads: int, head_dim: int, rms_eps: float,
               qk_norm: bool, pad_len=0, remat: bool = False, mesh=None,
               sp: bool = False) -> torch.Tensor:
    """A full-sequence pass of stacked blocks from position 0 (training),
    each block with a zero KV cache of its own allocated inside the
    (checkpointed, with ``remat``: recomputed in the backward pass) block
    function, so a recompute writes fresh buffers. ``mesh``: tp-sharded
    blocks (the head counts given are the whole model's); ``sp``: x is this
    rank's T slice, the cache spans the whole sequence."""
    tp = 1 if mesh is None else mesh.tp
    B, S = x.shape[0], x.shape[1] * (tp if sp else 1)
    heads, kv_heads = n_heads // tp, n_kv_heads // tp

    def block(bp, x):
        ck = torch.zeros((B, S, kv_heads, head_dim), dtype=x.dtype,
                         device=x.device)
        return transformer_block(
            bp, x, cos=cos, sin=sin, cache_k=ck, cache_v=torch.zeros_like(ck),
            pos=0, n_heads=heads, n_kv_heads=kv_heads, head_dim=head_dim,
            rms_eps=rms_eps, qk_norm=qk_norm, pad_len=pad_len, mesh=mesh,
            sp=sp,
        )

    for bp in unstack_layers(blocks):
        x = checkpoint(block, bp, x, use_reentrant=False) if remat \
            else block(bp, x)
    return x
