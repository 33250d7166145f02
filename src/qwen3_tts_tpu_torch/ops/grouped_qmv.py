"""Grouped-layout int8 weight-only matmul: layout, plain version, kernel A.

Weights are relaid ONCE at load from the row-major quantized linear
``{"q" [N, K], "scale"/"bias" [N, G]}`` into

    qg [G, gs, N]  uint8    (w[n, g*gs+j] codes, transposed per group)
    sg [G, N]      float32  scale per (group, out-col)
    bg [G, N]      float32  affine bias per (group, out-col)

and the matmul applies the affine step to f32 per-group PARTIAL SUMS
instead of to the weight:

    out[m, n] = sum_g sg[g, n] * (x[m, g*gs:]) . (qg[g, :, n])
              + sum_g bg[g, n] * xsum[m, g]

This keeps s/b in f32 (no rounding of the weight to the activation type),
so it is close to, but not bit-identical with, the row-major path
(``dequant_matmul.quantized_matmul_ref``).

``quantized_matmul_grouped`` dispatches on the tensor's device: a CPU tensor
takes the plain version ``quantized_matmul_grouped_ref``; a CUDA tensor
launches kernel A (``csrc/grouped_qmv.cu``) or raises. Rows above
``MAX_M`` are compute-heavy (prefill): there the weight is dequantized once
and multiplied densely, on either device, as the JAX package does.
``plan_kernel_a`` picks, from the shape alone, kernel A's path, its bands
of M and its split of K.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from ..profiling import trace
from .cuda_kernels import GROUPED_QMV
from .dequant_matmul import _scratch, _sm_count, split_cost
from .quant import is_quantized

MAX_M = 64  # above this the op is compute-heavy: dequantize once, dense matmul
TILE_N = 128               # output columns per ring block
SLICE_K = 64               # K of one ring slice (whole groups: gs divides it)
# (rows a band holds, bands) of the ring's instances, by the rows they cover
BANDS = ((1, 1), (2, 1), (4, 1), (8, 1), (8, 2), (8, 3), (8, 4), (8, 8))
MAX_SPLITS = 16            # splits of K at most
SB_GROUPS_MAX = 64         # groups of one split (its scale/bias table)
SIMPLE_TILE_N = 32         # output columns per block of the simple kernel


def blocks_per_sm(bands: int) -> int:
    """Blocks of a ring instance that ``split_cost`` counts as one wave on
    an SM: as many as it holds (the kernel's ``__launch_bounds__`` minimum,
    3 at M <= 8, else 2) up to 24 rows, where the time is the weight's
    loads; above, the FMAs of the blocks on an SM share it, so one."""
    return 3 if bands == 1 else 2 if bands <= 3 else 1


class KernelAPlan(NamedTuple):
    ring: bool        # False: the simple kernel (ragged K or gs, unaligned)
    ragged: bool      # N % 16 != 0: code rows copied as aligned windows
    band_rows: int    # rows of M a warp band holds (0 on the simple path)
    bands: int        # bands of a block (0: the simple kernel)
    rows: int         # rows of M per block
    k_unit: int       # a split's K is a whole number of these (slices)
    k_splits: int
    sb_groups: int    # most groups in one split (0 on the simple path)
    blocks: int
    # f32 partial tiles [k_splits, tiles, rows, 128] and one ticket counter
    # per 128-column tile; both 0 without a split
    workspace_floats: int
    counters: int


@functools.lru_cache(maxsize=4096)
def plan_kernel_a(m: int, n: int, k: int, gs: int, sm_count: int,
                  aligned: bool = True) -> KernelAPlan:
    """Kernel A's launch for x [m, k] (1 <= m <= MAX_M) and qg [k/gs, gs, n],
    the same at bf16 and at float32 x (the two instances share the ring's
    geometry, residency and time model).

    The ring path takes K a multiple of SLICE_K, gs in {16, 32, 64} (whole
    groups in a slice) and 16-byte aligned x and qg; a ragged N takes it
    too, through aligned-down row windows. One block covers all m rows, in
    the smallest instance of BANDS that holds them, and TILE_N columns. K is
    split in whole slices into the number of splits, at most MAX_SPLITS,
    that ``split_cost`` rates cheapest over the instance's ``blocks_per_sm
    * sm_count`` resident blocks (the fewest among equals, so the splits are
    as even as the slices allow), but never fewer than keep a split's
    scale/bias table within SB_GROUPS_MAX groups (rule and constants fitted
    to tools/sweep_kernel_a.py on an H100, and held at float32 by its
    --f32 sweep, PERF.md). Every other shape takes
    the simple kernel: 32 output columns by 1 row (m = 1) or 8 rows a block,
    all of K."""
    if not 1 <= m <= MAX_M:
        raise ValueError(f"kernel A takes 1..{MAX_M} rows, got {m}")
    if not aligned or k % SLICE_K or gs % 16 or SLICE_K % gs:
        rows = 1 if m == 1 else 8
        return KernelAPlan(False, False, 0, 0, rows, k, 1, 0,
                           -(-n // SIMPLE_TILE_N) * -(-m // rows), 0, 0)
    band_rows, bands = next(b for b in BANDS if b[0] * b[1] >= m)
    rows = band_rows * bands
    tiles = -(-n // TILE_N)
    units = k // SLICE_K
    fewest = -(-units // (SB_GROUPS_MAX * gs // SLICE_K))
    slots = blocks_per_sm(bands) * sm_count
    splits = min(range(fewest, max(fewest, min(units, MAX_SPLITS)) + 1),
                 key=lambda s: split_cost(s, tiles, units, slots))
    sb_groups = -(-units // splits) * (SLICE_K // gs)
    ragged = n % 16 != 0
    if splits == 1:
        return KernelAPlan(True, ragged, band_rows, bands, rows, SLICE_K, 1,
                           sb_groups, tiles, 0, 0)
    return KernelAPlan(True, ragged, band_rows, bands, rows, SLICE_K, splits,
                       sb_groups, tiles * splits,
                       splits * tiles * rows * TILE_N, tiles)


def grouped_layout(device) -> bool:
    """Whether quantized linears are relaid into the grouped layout at
    engine construction. QWEN3_TTS_INT8_LAYOUT = auto|grouped|rowmajor;
    auto = grouped on CUDA (kernel A carries decode there), row-major on
    the CPU, as the JAX package keeps row-major off the TPU."""
    mode = os.environ.get("QWEN3_TTS_INT8_LAYOUT", "auto")
    if mode in ("grouped", "rowmajor"):
        return mode == "grouped"
    if mode != "auto":
        raise ValueError(
            f"QWEN3_TTS_INT8_LAYOUT={mode!r}: expected auto|grouped|rowmajor"
        )
    return torch.device(device).type == "cuda"


def is_grouped(p) -> bool:
    """True for a grouped-layout quantized linear param dict."""
    return isinstance(p, dict) and "qg" in p and "sg" in p and "bg" in p


def pack_grouped(p: dict) -> dict:
    """Row-major quantized linear {"q" [*, N, K], "scale"/"bias" [*, N, G]}
    -> grouped {"qg" [*, G, gs, N], "sg"/"bg" [*, G, N]}, contiguous.
    Leading (stacked layer) axes pass through; other keys (additive "b",
    LoRA adapters) are kept. Works on tensors or numpy arrays."""
    q, scale, bias = p["q"], p["scale"], p["bias"]
    *lead, n, k = q.shape
    g = scale.shape[-1]
    gs = k // g
    nd = len(lead)
    perm_q = tuple(range(nd)) + (nd + 1, nd + 2, nd)
    perm_s = tuple(range(nd)) + (nd + 1, nd)
    q4 = q.reshape(*lead, n, g, gs)
    if isinstance(q, torch.Tensor):
        out = {
            "qg": q4.permute(perm_q).contiguous(),
            "sg": scale.permute(perm_s).float().contiguous(),
            "bg": bias.permute(perm_s).float().contiguous(),
        }
    else:
        out = {
            "qg": np.ascontiguousarray(np.transpose(q4, perm_q)),
            "sg": np.ascontiguousarray(np.transpose(scale, perm_s), np.float32),
            "bg": np.ascontiguousarray(np.transpose(bias, perm_s), np.float32),
        }
    out.update({key: v for key, v in p.items()
                if key not in ("q", "scale", "bias")})
    return out


def pack_grouped_tree(params):
    """Convert every row-major quantized linear in a tree to the grouped
    layout (identity on everything else, leaves shared)."""
    def convert(node):
        if isinstance(node, dict):
            if is_quantized(node):
                return pack_grouped(node)
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(convert(v) for v in node)
        return node

    return convert(params)


def _dense_route(x2, qg, sg, bg):
    """M > MAX_M: reconstruct the dense weight [K, N] once (rounded to the
    activation type) and run one full-rate matmul with f32 accumulation."""
    g, gs, n = qg.shape
    w = (qg.float() * sg[:, None, :] + bg[:, None, :]).reshape(g * gs, n)
    w = w.to(x2.dtype)
    if x2.is_cuda or x2.dtype == torch.float32:
        return torch.matmul(x2, w)
    return torch.matmul(x2.float(), w.float()).to(x2.dtype)


def quantized_matmul_grouped_ref(x, qg, sg, bg):
    """Plain version of kernel A (the JAX quantized_matmul_grouped_xla's
    numerics): per-group partial products with f32 accumulation, the f32
    affine step on the partials, output cast to x.dtype; M > MAX_M takes
    the dense route."""
    g, gs, n = qg.shape
    k = g * gs
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    if m > MAX_M:
        return _dense_route(x2, qg, sg, bg).reshape(*lead, n).to(x.dtype)
    x3 = x2.reshape(m, g, gs)
    xsum = x3.float().sum(-1)                               # [M, G]
    # u8 and the activation are exact in f32: the batched product is the
    # x.dtype product with f32 accumulation
    p = torch.bmm(x3.transpose(0, 1).float(), qg.float())   # [G, M, N]
    out = (p * sg[:, None, :]).sum(0) + xsum @ bg
    return out.reshape(*lead, n).to(x.dtype)


# the C entry point of each activation type, and the largest group its
# simple path stages (a 4 KB row of x)
_ENTRY = {torch.bfloat16: ("bfloat16", 2048), torch.float32: ("float32", 1024)}


def launch_plan(x2: torch.Tensor, qg: torch.Tensor, sm_count: int) -> KernelAPlan:
    """``plan_kernel_a`` for these tensors: their shapes and whether x2
    and qg start on 16-byte boundaries."""
    g, gs, n = qg.shape
    aligned = x2.data_ptr() % 16 == 0 and qg.data_ptr() % 16 == 0
    return plan_kernel_a(x2.shape[0], n, g * gs, gs, sm_count, aligned)


def grouped_qmv_cuda(x2: torch.Tensor, qg, sg, bg) -> torch.Tensor:
    """Kernel A on the card: x2 [M <= MAX_M, K] bf16 or f32 x grouped
    weight -> [M, N] in x2.dtype, launched as ``plan_kernel_a`` plans it
    (the instance of x2's type)."""
    g, gs, n = qg.shape
    k = g * gs
    if x2.dtype not in _ENTRY:
        raise TypeError(
            f"grouped_qmv: x must be bfloat16 or float32, got {x2.dtype}")
    entry, max_gs = _ENTRY[x2.dtype]
    if qg.dtype != torch.uint8 or sg.dtype != torch.float32 \
            or bg.dtype != torch.float32:
        raise TypeError(
            f"grouped_qmv: expected qg uint8, sg/bg float32; got "
            f"{qg.dtype}, {sg.dtype}, {bg.dtype}"
        )
    if x2.dim() != 2 or x2.shape[1] != k or sg.shape != (g, n) \
            or bg.shape != (g, n):
        raise ValueError(
            f"grouped_qmv: shapes x {tuple(x2.shape)}, qg {tuple(qg.shape)}, "
            f"sg {tuple(sg.shape)}, bg {tuple(bg.shape)} do not match"
        )
    if not 1 <= gs <= max_gs:
        raise ValueError(
            f"grouped_qmv: group size {gs} outside 1..{max_gs} ({entry})")
    tensors = (x2, qg, sg, bg)
    if any(not t.is_cuda or t.device != x2.device for t in tensors):
        raise ValueError("grouped_qmv: all tensors must be on one CUDA device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("grouped_qmv: tensors must be contiguous")
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    if m == 0:
        return out
    dev = x2.device
    plan = launch_plan(x2, qg, _sm_count(dev.index))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws, cnt = _scratch(dev, stream, plan)
    with torch.cuda.device(dev):
        GROUPED_QMV.call(
            entry, (x2.data_ptr(), qg.data_ptr(), sg.data_ptr(), bg.data_ptr(),
             out.data_ptr(), ws.data_ptr(), cnt.data_ptr(), m, k, n, gs,
             plan.band_rows, plan.bands, plan.k_splits, plan.sb_groups,
             stream),
            (m, n, k, gs),
        )
    return out


def quantized_matmul_grouped(x, qg, sg, bg):
    """x [..., K] x grouped-quantized W -> [..., N] (decode entry point).
    CPU tensors take the plain version; CUDA tensors launch kernel A, or
    take the dense route above MAX_M rows."""
    with trace("qwen3_tts.kernel.grouped_qmv"):
        if not x.is_cuda:
            return quantized_matmul_grouped_ref(x, qg, sg, bg)
        g, gs, n = qg.shape
        lead = x.shape[:-1]
        x2 = x.reshape(-1, g * gs).contiguous()
        if x2.shape[0] > MAX_M:
            out = _dense_route(x2, qg, sg, bg)
        else:
            out = grouped_qmv_cuda(x2, qg, sg, bg)
        return out.reshape(*lead, n)
