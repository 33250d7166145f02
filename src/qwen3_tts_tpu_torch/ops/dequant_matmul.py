"""Row-major int8 weight-only matmul: plain version and kernel B.

``x [..., K] @ W^T`` with ``W[n, k] = q[n, k] * scale[n, k//gs] +
bias[n, k//gs]`` formed in f32 and rounded to the activation type before
the product (f32 accumulation, output in x.dtype): the JAX package's
``ops/linear.py::quantized_matmul_xla`` numerics.

``quantized_matmul`` dispatches on the tensor's device: a CPU tensor takes
the plain version ``quantized_matmul_ref``; a CUDA tensor launches kernel B
(``csrc/dequant_matmul.cu``) or raises. ``plan_kernel_b`` picks, from the
shape alone, kernel B's path, its rows of M per block and its split of K.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .cuda_kernels import DEQUANT_MATMUL
from .quant import dequantize

TILE_N = 64                # weight rows (output columns) per block
SLICE_K = 64               # K of one ring slice
M_FRAGS = (1, 2, 3, 4, 8, 16)  # the ring's instances: 8-row fragments of M
BLOCKS_PER_SM = 2          # split K until about this many blocks per SM
MIN_SPLIT_UNITS = 4        # units of K a split holds at least (M <= 64)
MAX_SPLITS_WIDE = 8        # splits at most at 128 rows (one wave there)
SB_GROUPS_MAX = 128        # groups of one split (its scale/bias table)
_COUNTERS_MIN = 1 << 12    # tile counters allocated at first use
_WORKSPACE_MIN = 1 << 20   # f32 partials allocated at first use


class KernelBPlan(NamedTuple):
    ring: bool        # False: the simple kernel (ragged K or gs, unaligned)
    m_frags: int      # 8-row fragments of M per block (0: simple kernel)
    tile_m: int       # rows of M per block
    k_unit: int       # a split's K is a whole number of these (slices, groups)
    k_splits: int
    sb_groups: int    # most groups in one split (0 on the simple path)
    blocks: int
    # f32 partial tiles [k_splits, tiles, tile_m, 64] and one ticket counter
    # per (N, M) tile; both 0 without a split
    workspace_floats: int
    counters: int


@functools.lru_cache(maxsize=4096)
def plan_kernel_b(m: int, n: int, k: int, gs: int, sm_count: int,
                  aligned: bool = True) -> KernelBPlan:
    """Kernel B's launch for x [m, k] and W [n, k] in groups of gs.

    The ring path takes K a multiple of SLICE_K, gs a multiple of 16 and
    16-byte aligned x and q. It covers up to 128 rows of M per block in the
    fewest fragments of M_FRAGS, and splits K in units of whole slices and
    whole groups, as evenly as the units allow, into a power of two of
    splits:

    - up to 64 rows: the fewest that run BLOCKS_PER_SM * sm_count blocks,
      but none holding fewer than MIN_SPLIT_UNITS units;
    - at 128 rows (99 KB of ring, 2 blocks an SM): the most whose blocks
      run in one wave of BLOCKS_PER_SM per SM, at most MAX_SPLITS_WIDE

    (the rule nearest the fastest split counts that tools/sweep_kernel_b.py
    measured on an H100, PERF.md), never more splits than units and never
    fewer than keep a split's scale/bias table within SB_GROUPS_MAX groups.
    Every other shape takes the simple kernel: 64 output columns by 16 or
    64 rows a block, all of K."""
    n_tiles = -(-n // TILE_N)
    if not aligned or k % SLICE_K or gs % 16:
        tile_m = 16 if m <= 16 else 64
        return KernelBPlan(False, 0, tile_m, k, 1, 0,
                           n_tiles * -(-m // tile_m), 0, 0)
    m_frags = next((f for f in M_FRAGS if 8 * f >= m), M_FRAGS[-1])
    tile_m = 8 * m_frags
    tiles = n_tiles * -(-m // tile_m)
    k_unit = math.lcm(SLICE_K, gs)
    units = k // k_unit
    groups_per_unit = k_unit // gs
    per_sm = BLOCKS_PER_SM * sm_count / tiles
    splits = 1
    if m_frags == M_FRAGS[-1]:
        while 2 * splits <= min(per_sm, MAX_SPLITS_WIDE):
            splits *= 2
    else:
        while splits < per_sm:
            splits *= 2
        splits = min(splits, units // MIN_SPLIT_UNITS)
    splits = max(1, min(splits, units),
                 -(-units * groups_per_unit // SB_GROUPS_MAX))
    sb_groups = -(-units // splits) * groups_per_unit
    if splits == 1:
        return KernelBPlan(True, m_frags, tile_m, k_unit, 1, sb_groups, tiles,
                           0, 0)
    part = tiles * tile_m * TILE_N               # f32 partials of one split
    return KernelBPlan(True, m_frags, tile_m, k_unit, splits, sb_groups,
                       tiles * splits, splits * part, tiles)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream) -> (f32 workspace, int32 tile counters)
_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device: torch.device, stream: int, plan: KernelBPlan):
    """Kernel B's split-K workspace and tile counters on one (device,
    stream). Allocated at first use and grown to the next power of two when
    a plan needs more; the counters are zeroed when allocated and every
    launch leaves them at 0, so a call allocates and launches nothing else.
    Calls on one stream run in order, so they share the buffers."""
    key = (device.index, stream)
    ws, cnt = _SCRATCH.get(key, (None, None))
    if ws is None or ws.numel() < plan.workspace_floats:
        size = 1 << (plan.workspace_floats - 1).bit_length()
        ws = torch.empty(max(_WORKSPACE_MIN, size), dtype=torch.float32,
                         device=device)
    if cnt is None or cnt.numel() < plan.counters:
        size = 1 << (plan.counters - 1).bit_length()
        cnt = torch.zeros(max(_COUNTERS_MIN, size), dtype=torch.int32,
                          device=device)
    _SCRATCH[key] = (ws, cnt)
    return ws, cnt


def dense_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w[out, in]^T -> [..., out] in x.dtype, f32 accumulation
    (cuBLAS accumulates bf16 products in f32; the CPU path upcasts)."""
    w = w.to(x.dtype)
    if x.is_cuda or x.dtype == torch.float32:
        return torch.matmul(x, w.transpose(-1, -2))
    return torch.matmul(x.float(), w.float().transpose(-1, -2)).to(x.dtype)


def quantized_matmul_ref(x, q, scale, bias):
    """Plain version of kernel B: dequantize to x.dtype, then a dense
    matmul with f32 accumulation."""
    w = dequantize({"q": q, "scale": scale, "bias": bias}, dtype=x.dtype)
    return dense_matmul(x, w)


def dequant_matmul_cuda(x2: torch.Tensor, q, scale, bias) -> torch.Tensor:
    """Kernel B on the card: x2 [M, K] bf16 or f32 x row-major int8 W ->
    [M, N] in x2.dtype (bf16: as ``plan_kernel_b`` plans it; f32: the
    CUDA-core f32 instance, no plan)."""
    n, k = q.shape
    g = scale.shape[-1]
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(
            f"dequant_matmul: x must be bfloat16 or float32, got {x2.dtype}")
    if q.dtype != torch.uint8 or scale.dtype != torch.float32 \
            or bias.dtype != torch.float32:
        raise TypeError(
            f"dequant_matmul: expected q uint8, scale/bias float32; got "
            f"{q.dtype}, {scale.dtype}, {bias.dtype}"
        )
    if x2.dim() != 2 or x2.shape[1] != k or scale.shape != (n, g) \
            or bias.shape != (n, g) or g == 0 or k % g:
        raise ValueError(
            f"dequant_matmul: shapes x {tuple(x2.shape)}, q {tuple(q.shape)}, "
            f"scale {tuple(scale.shape)}, bias {tuple(bias.shape)} do not match"
        )
    tensors = (x2, q, scale, bias)
    if any(not t.is_cuda or t.device != x2.device for t in tensors):
        raise ValueError("dequant_matmul: all tensors must be on one CUDA device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("dequant_matmul: tensors must be contiguous")
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    if m == 0:
        return out
    gs = k // g
    dev = x2.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    if x2.dtype == torch.float32:
        entry, ws_ptr, cnt_ptr, plan_ints = "float32", 0, 0, (0, 0, 0, 0)
    else:
        aligned = x2.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
        plan = plan_kernel_b(m, n, k, gs, _sm_count(dev.index), aligned)
        ws, cnt = _scratch(dev, stream, plan)
        entry, ws_ptr, cnt_ptr = "bfloat16", ws.data_ptr(), cnt.data_ptr()
        plan_ints = (plan.m_frags, plan.k_splits, plan.k_unit, plan.sb_groups)
    with torch.cuda.device(dev):
        DEQUANT_MATMUL.call(
            entry,
            (x2.data_ptr(), q.data_ptr(), scale.data_ptr(), bias.data_ptr(),
             out.data_ptr(), ws_ptr, cnt_ptr, m, k, n, gs, *plan_ints,
             stream),
            (m, n, k, gs),
        )
    return out


def quantized_matmul(x, q, scale, bias):
    """x [..., K] x affine-quantized W[N, K] -> [..., N]. CPU tensors take
    the plain version; CUDA tensors launch kernel B."""
    if not x.is_cuda:
        return quantized_matmul_ref(x, q, scale, bias)
    n, k = q.shape
    out = dequant_matmul_cuda(x.reshape(-1, k).contiguous(), q, scale, bias)
    return out.reshape(*x.shape[:-1], n)
