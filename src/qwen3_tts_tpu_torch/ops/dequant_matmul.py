"""Row-major int8 weight-only matmul: plain version and kernel B.

``x [..., K] @ W^T`` with ``W[n, k] = q[n, k] * scale[n, k//gs] +
bias[n, k//gs]`` formed in f32 and rounded to the activation type before
the product (f32 accumulation, output in x.dtype): the JAX package's
``ops/linear.py::quantized_matmul_xla`` numerics.

``quantized_matmul`` dispatches on the tensor's device: a CPU tensor takes
the plain version ``quantized_matmul_ref``; a CUDA tensor launches kernel B
(``csrc/dequant_matmul.cu``, its bf16 or its float32 instance) or raises.
``plan_kernel_b`` (bf16 x) and ``plan_kernel_b_f32`` (float32 x) pick, from
the shape alone, kernel B's path, its rows of M per block and its split of
K.
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
# the float32 ring: rows of M a block covers, by instance (32 with 4 weight
# rows a lane, the others with 2), the row tile above 64 rows; splits at most
F32_ROWS = (1, 2, 4, 8, 16, 32, 64)
F32_WIDE_ROWS = 32
F32_MAX_SPLITS = 16
# a split's fixed cost (prologue, partial tile, ticket), in slices of work;
# the float32 ring's 32- and 64-row instances sum 4-8 parts of a larger
# tile in the block first
SPLIT_OVERHEAD_SLICES = 0.5
F32_WIDE_SPLIT_OVERHEAD_SLICES = 1.0
_COUNTERS_MIN = 1 << 12    # tile counters allocated at first use
_WORKSPACE_MIN = 1 << 20   # f32 partials allocated at first use


def split_cost(splits: int, tiles: int, units: int, slots: int,
               overhead: float = SPLIT_OVERHEAD_SLICES) -> float:
    """A plan's time model of a split of ``units`` slices: the waves of
    ``tiles * splits`` blocks over ``slots`` resident blocks, times the
    slices of the longest split plus a split's ``overhead``."""
    waves = -(-tiles * splits // slots)
    return waves * (-(-units // splits) + overhead)


def f32_blocks_per_sm(rows: int) -> int:
    """Blocks of a float32 ring instance that ``split_cost`` counts as one
    wave on an SM: as many as it holds (the kernel's ``__launch_bounds__``
    minimum), 3 at rows <= 16, else 2."""
    return 3 if rows <= 16 else 2


def f32_split_overhead(rows: int) -> float:
    """A split's fixed cost in the float32 plan, in slices."""
    return SPLIT_OVERHEAD_SLICES if rows <= 16 else F32_WIDE_SPLIT_OVERHEAD_SLICES


class KernelBPlan(NamedTuple):
    ring: bool        # False: the simple kernel (ragged K or gs, unaligned)
    m_frags: int      # 8-row fragments of M per block (bf16 ring; else 0)
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
    """Kernel B's launch for bf16 x [m, k] and W [n, k] in groups of gs.

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


@functools.lru_cache(maxsize=4096)
def plan_kernel_b_f32(m: int, n: int, k: int, gs: int, sm_count: int,
                      aligned: bool = True) -> KernelBPlan:
    """Kernel B's launch for float32 x [m, k] and W [n, k] in groups of gs.

    The f32 ring takes the bf16 ring's shapes (K a multiple of SLICE_K, gs
    of 16, 16-byte aligned x and q). A block covers the fewest rows of
    F32_ROWS that hold m; above 64 rows, grid.y walks tiles of
    F32_WIDE_ROWS. K is split in units of whole slices and whole groups
    into the number of splits, at most F32_MAX_SPLITS, that ``split_cost``
    rates cheapest over ``f32_blocks_per_sm * sm_count`` resident blocks
    with ``f32_split_overhead`` a split (the fewest among equals), but
    never fewer than keep a split's scale/bias table within SB_GROUPS_MAX
    groups (constants fitted to tools/sweep_kernel_b.py --f32 on an H100,
    PERF.md). Every other shape takes the simple f32 kernel: 64 output
    columns by 4 (m <= 4) or 16 rows a block, all of K."""
    n_tiles = -(-n // TILE_N)
    if not aligned or k % SLICE_K or gs % 16:
        tile_m = 4 if m <= 4 else 16
        return KernelBPlan(False, 0, tile_m, k, 1, 0,
                           n_tiles * -(-m // tile_m), 0, 0)
    tile_m = next((r for r in F32_ROWS if r >= m), F32_WIDE_ROWS)
    tiles = n_tiles * -(-m // tile_m)
    k_unit = math.lcm(SLICE_K, gs)
    units = k // k_unit
    groups_per_unit = k_unit // gs
    fewest = -(-units * groups_per_unit // SB_GROUPS_MAX)
    slots = f32_blocks_per_sm(tile_m) * sm_count
    overhead = f32_split_overhead(tile_m)
    splits = min(range(fewest, max(fewest, min(units, F32_MAX_SPLITS)) + 1),
                 key=lambda s: split_cost(s, tiles, units, slots, overhead))
    sb_groups = -(-units // splits) * groups_per_unit
    if splits == 1:
        return KernelBPlan(True, 0, tile_m, k_unit, 1, sb_groups, tiles, 0, 0)
    return KernelBPlan(True, 0, tile_m, k_unit, splits, sb_groups,
                       tiles * splits, splits * tiles * tile_m * TILE_N, tiles)


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


def launch_plan(x2: torch.Tensor, q: torch.Tensor, gs: int,
                sm_count: int) -> KernelBPlan:
    """Kernel B's plan for these tensors (``plan_kernel_b_f32`` for a
    float32 x2): their shapes and whether x2 and q start on 16-byte
    boundaries."""
    n, k = q.shape
    aligned = x2.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
    plan = plan_kernel_b_f32 if x2.dtype == torch.float32 else plan_kernel_b
    return plan(x2.shape[0], n, k, gs, sm_count, aligned)


def dequant_matmul_cuda(x2: torch.Tensor, q, scale, bias) -> torch.Tensor:
    """Kernel B on the card: x2 [M, K] bf16 or f32 x row-major int8 W ->
    [M, N] in x2.dtype, launched as ``launch_plan`` plans it (the bf16
    instance's tensor-core ring, or the f32 instance's CUDA-core ring, each
    with its simple kernel for the other shapes)."""
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
    f32 = x2.dtype == torch.float32
    plan = launch_plan(x2, q, gs, _sm_count(dev.index))
    ws, cnt = _scratch(dev, stream, plan)
    # the first plan int: the bf16 ring's fragments, the f32 ring's rows (0:
    # the simple kernel)
    first = (plan.tile_m if plan.ring else 0) if f32 else plan.m_frags
    with torch.cuda.device(dev):
        DEQUANT_MATMUL.call(
            "float32" if f32 else "bfloat16",
            (x2.data_ptr(), q.data_ptr(), scale.data_ptr(), bias.data_ptr(),
             out.data_ptr(), ws.data_ptr(), cnt.data_ptr(), m, k, n, gs, first,
             plan.k_splits, plan.k_unit, plan.sb_groups, stream),
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
