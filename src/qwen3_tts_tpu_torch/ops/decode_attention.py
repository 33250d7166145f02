"""Decode attention in one launch: kernel C (``csrc/decode_attention.cu``).

``models/layers.py::attention`` hands the kernel everything between its
q/k/v projections and its o projection when the call decodes (T <= 2
positions a row) in bf16 on the card over a dense bf16 cache, with no
autograd and no mesh (``layers._takes_decode_kernel``): the per-head q/k
RMSNorm, RoPE, the cache write at ``pos`` and the masked GQA read, written
as bf16 [B, T, H * hd]. Every other call keeps the plain code
(``layers._attend_plain``), which is also what the kernel is held to.

The wrapper validates the layout, allocates the output and launches; the
per-row positions, pads and windows stay on the device (a window split's
table is made once, ``layers.WindowSplit``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..profiling import trace
from .cuda_kernels import DECODE_ATTENTION

HEAD_DIM = 128       # the kernel's head_dim: the talker's and the predictor's


@functools.lru_cache(maxsize=1024)
def fits(queries: int, window: int, device: int) -> bool:
    """Whether ``queries`` (T * g) score rows over ``window`` keys fit the
    kernel's shared memory on card ``device``; the kernel's own layout and
    the card's limit decide (``decode_attention_fits`` in the source)."""
    rc = DECODE_ATTENTION.function(
        "decode_attention_fits", [ctypes.c_int] * 3)(device, queries, window)
    if rc < 0:
        raise RuntimeError(f"decode_attention_fits: cudaError {-rc}")
    return rc == 1


def _token_stride(t: torch.Tensor, name: str) -> int:
    """Elements between consecutive (row, position) tokens of a [B, T, N]
    view whose last dimension is contiguous."""
    B, T, _ = t.shape
    if t.stride(2) != 1 or (T > 1 and t.stride(0) != T * t.stride(1)):
        raise ValueError(f"decode_attention: {name} {tuple(t.shape)} with "
                         f"strides {t.stride()} is not a run of tokens")
    stride = t.stride(0) // T if T > 1 else t.stride(0)
    if stride % 8 or t.data_ptr() % 16:
        raise ValueError(f"decode_attention: {name} is not 16-byte aligned")
    return stride


def _ptr(t) -> int:
    """A tensor's device address; 0 (null) for an int or None."""
    return t.data_ptr() if isinstance(t, torch.Tensor) else 0


def decode_attention_cuda(q, k, v, q_norm, k_norm, cos, sin, cache_k,
                          cache_v, pos, pad_len, win, max_win: int,
                          n_heads: int, n_kv_heads: int,
                          rms_eps: float) -> torch.Tensor:
    """Kernel C on the card. q [B, T, n_heads * hd], k/v [B, T, n_kv_heads
    * hd] bf16 (views of a fused product allowed); q_norm/k_norm [hd] bf16
    or None (no qk norm); cos/sin f32 [T, hd/2] or [B, T, hd/2]; cache_k/v
    [B, S, n_kv_heads, hd] bf16, written in place; pos/pad_len ints or
    int64 [B]; win an int64 [B] table of row windows or None (all S), and
    max_win the widest. Returns the context [B, T, n_heads * hd] bf16."""
    with trace("qwen3_tts.kernel.decode_attention"):
        B, T, _ = q.shape
        S = cache_k.shape[1]
        hd = HEAD_DIM
        dev = q.get_device()
        strides = cache_k.stride()
        if cache_k.shape != (B, S, n_kv_heads, hd) \
                or cache_v.shape != cache_k.shape \
                or strides[1:] != (n_kv_heads * hd, hd, 1) \
                or cache_v.stride() != strides or strides[0] % 8 \
                or (cache_k.data_ptr() | cache_v.data_ptr()) % 16 \
                or cache_k.get_device() != dev or cache_v.get_device() != dev:
            raise ValueError(
                f"decode_attention: caches {tuple(cache_k.shape)} with strides "
                f"{strides} are not [B, S, H_kv, {hd}] rows on q's device")
        if cos.dtype != torch.float32 or sin.dtype != torch.float32 \
                or cos.shape != sin.shape or cos.shape[-2:] != (T, hd // 2) \
                or not (cos.is_contiguous() and sin.is_contiguous()) \
                or cos.get_device() != dev or sin.get_device() != dev:
            raise ValueError(f"decode_attention: cos/sin {tuple(cos.shape)} "
                             f"{cos.dtype} are not f32 [(B,) {T}, {hd // 2}]")
        for r in (pos, pad_len, win):
            if isinstance(r, torch.Tensor) and (
                    r.dtype != torch.int64 or r.shape != (B,)
                    or r.get_device() != dev or not r.is_contiguous()):
                raise ValueError("decode_attention: pos, pad_len and the "
                                 "window table must be int64 [B] on q's "
                                 "device")
        for w in (q_norm, k_norm):
            if w is not None and (w.shape != (hd,) or w.dtype != q.dtype
                                  or w.get_device() != dev
                                  or not w.is_contiguous()):
                raise ValueError(f"decode_attention: q_norm/k_norm must be "
                                 f"{q.dtype} [{hd}] on q's device")
        out = torch.empty((B, T, n_heads * hd), dtype=q.dtype, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(dev):
            DECODE_ATTENTION.call("bfloat16", (
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_norm),
                _ptr(k_norm), cos.data_ptr(), sin.data_ptr(),
                cache_k.data_ptr(), cache_v.data_ptr(), _ptr(pos),
                _ptr(pad_len), _ptr(win), out.data_ptr(),
                _token_stride(q, "q"), _token_stride(k, "k"),
                _token_stride(v, "v"), strides[0],
                (T * hd // 2) if cos.dim() == 3 else 0, B, T, n_heads,
                n_kv_heads, S, 0 if isinstance(pos, torch.Tensor) else pos,
                0 if isinstance(pad_len, torch.Tensor) else pad_len,
                max_win, rms_eps, hd ** -0.5, stream,
            ), (B, T, n_heads, n_kv_heads, max_win, int(q_norm is not None),
                int(isinstance(pos, torch.Tensor)), int(win is not None)))
        return out
