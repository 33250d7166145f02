"""The port's two CUDA kernels against their plain PyTorch versions, and
their launch plans.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with a GPU and no JAX:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tests that need the card carry the ``cuda`` marker and skip without one;
the CPU tests check the device dispatch (a CPU tensor never reaches a
kernel, a kernel wrapper refuses CPU tensors).
"""

import math

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch.ops import cuda_kernels, dequant_matmul
from qwen3_tts_tpu_torch.ops.dequant_matmul import (
    F32_MAX_SPLITS,
    F32_ROWS,
    F32_WIDE_ROWS,
    MAX_SPLITS_WIDE,
    MIN_SPLIT_UNITS,
    SB_GROUPS_MAX,
    SLICE_K,
    TILE_N,
    dequant_matmul_cuda,
    f32_blocks_per_sm,
    plan_kernel_b,
    plan_kernel_b_f32,
    quantized_matmul,
    quantized_matmul_ref,
    split_cost,
)
from qwen3_tts_tpu_torch.ops import grouped_qmv
from qwen3_tts_tpu_torch.ops.grouped_qmv import (
    MAX_M,
    grouped_qmv_cuda,
    pack_grouped,
    plan_kernel_a,
    quantized_matmul_grouped,
    quantized_matmul_grouped_ref,
)
from qwen3_tts_tpu_torch.ops.quant import quantize_weights

# bf16 output from f32 sums taken in another order than the plain version's
REL_TOL = 1e-2
H100_SMS = 132
# (N, K) of every int8 linear of the flagship (as chip_smoke.py's FLAGSHIP_NK)
FLAGSHIP_NK = (
    (2048, 2048), (1024, 2048), (6144, 2048), (2048, 6144), (2051, 2048),
    (3072, 1024), (1024, 1024), (6144, 1024), (1024, 3072),
)
FLAGSHIP_CASES = [(m, n, k, 64) for n, k in FLAGSHIP_NK
                  for m in (1, 8, 24, 32, 128)]
RAGGED_CASES = [(3, 67, 64, 16), (5, 33, 36, 12), (2, 40, 96, 48),
                (200, 1024, 1024, 64)]


def _quant(seed, n, k, gs):
    w = np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)
    return {key: torch.from_numpy(v)
            for key, v in quantize_weights(w, group_size=gs).items()}


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor never reaches a kernel: the launch counts stay put."""
    p = _quant(0, 64, 64, 16)
    gp = pack_grouped(p)
    before = [k.launches for k in cuda_kernels.KERNELS]
    x = torch.randn(2, 64)
    torch.testing.assert_close(
        quantized_matmul(x, p["q"], p["scale"], p["bias"]),
        quantized_matmul_ref(x, p["q"], p["scale"], p["bias"]))
    torch.testing.assert_close(
        quantized_matmul_grouped(x, gp["qg"], gp["sg"], gp["bg"]),
        quantized_matmul_grouped_ref(x, gp["qg"], gp["sg"], gp["bg"]))
    assert [k.launches for k in cuda_kernels.KERNELS] == before


@pytest.mark.parametrize("grouped", [True, False], ids=["kernel_a", "kernel_b"])
def test_kernel_wrappers_refuse_cpu_tensors(grouped):
    p = _quant(1, 64, 64, 16)
    w = pack_grouped(p) if grouped else p
    fn, keys = ((grouped_qmv_cuda, ("qg", "sg", "bg")) if grouped
                else (dequant_matmul_cuda, ("q", "scale", "bias")))
    with pytest.raises(ValueError, match="CUDA"):
        fn(torch.randn(2, 64).to(torch.bfloat16), *(w[k] for k in keys))


@pytest.mark.parametrize("m,n,k,gs", FLAGSHIP_CASES + RAGGED_CASES)
def test_plan_kernel_b_splits_k_in_whole_units_and_fills_the_card(m, n, k, gs):
    plan = plan_kernel_b(m, n, k, gs, H100_SMS)
    assert plan.ring == (k % SLICE_K == 0 and gs % 16 == 0)
    if (m, n, k, gs) in FLAGSHIP_CASES:
        assert plan.ring
    units = k // plan.k_unit
    assert units * plan.k_unit == k and plan.k_unit % gs == 0
    if plan.ring:
        assert plan.k_unit % SLICE_K == 0
        assert plan.tile_m == 8 * plan.m_frags >= min(m, 128)
    else:
        assert plan.m_frags == 0 and plan.k_splits == 1
    # split s covers units [s * units // S, (s + 1) * units // S), as the
    # kernel forms it: every split holds at least one whole unit
    bounds = [s * units // plan.k_splits * plan.k_unit
              for s in range(plan.k_splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == k
    assert all(b - a >= plan.k_unit for a, b in zip(bounds, bounds[1:]))
    tiles = math.ceil(n / TILE_N) * math.ceil(m / plan.tile_m)
    assert plan.blocks == tiles * plan.k_splits
    part = tiles * plan.tile_m * TILE_N  # f32 partials of one split
    if plan.ring:
        widest = max(b - a for a, b in zip(bounds, bounds[1:]))
        assert plan.sb_groups == widest // gs <= SB_GROUPS_MAX
        splits = plan.k_splits
        assert splits & (splits - 1) == 0 or splits == units // MIN_SPLIT_UNITS
        if plan.tile_m < 128:
            # the fewest splits for 2 blocks per SM, unless K runs out
            assert (plan.blocks >= 2 * H100_SMS > plan.blocks // 2
                    or splits == max(1, units // MIN_SPLIT_UNITS))
        else:
            # 128 rows: the most splits in one wave of 2 blocks per SM
            assert splits <= MAX_SPLITS_WIDE
            assert plan.blocks <= 2 * H100_SMS or splits == 1
            assert splits == MAX_SPLITS_WIDE or 2 * plan.blocks > 2 * H100_SMS
    split = plan.k_splits > 1
    assert plan.workspace_floats == (plan.k_splits * part if split else 0)
    assert plan.workspace_floats >= (plan.k_splits * m * n if split else 0)
    assert plan.counters == (tiles if split else 0)


def test_plan_kernel_b_sends_unaligned_pointers_to_the_simple_kernel():
    plan = plan_kernel_b(1, 1024, 3072, 64, H100_SMS, aligned=False)
    assert not plan.ring and plan.k_splits == 1 and plan.blocks == 16


@pytest.mark.parametrize("m,n,k,gs", FLAGSHIP_CASES + RAGGED_CASES)
def test_plan_kernel_b_float32_splits_k_in_whole_units_and_fills_the_card(
        m, n, k, gs):
    """The float32 ring takes the bf16 ring's shapes, covers m in the
    fewest rows of F32_ROWS (tiles of F32_WIDE_ROWS above 64 rows) and
    splits K in whole units into the count split_cost rates cheapest (the
    fewest among equals) over its resident blocks."""
    plan = plan_kernel_b_f32(m, n, k, gs, H100_SMS)
    assert plan.ring == (k % SLICE_K == 0 and gs % 16 == 0)
    assert plan.m_frags == 0
    n_tiles = math.ceil(n / TILE_N)
    if not plan.ring:
        assert plan.tile_m == (4 if m <= 4 else 16)
        assert plan.k_splits == 1 and plan.sb_groups == 0
        assert plan.blocks == n_tiles * math.ceil(m / plan.tile_m)
        assert plan.workspace_floats == plan.counters == 0
        return
    if m <= F32_ROWS[-1]:
        assert plan.tile_m == min(r for r in F32_ROWS if r >= m)
    else:
        assert plan.tile_m == F32_WIDE_ROWS
    tiles = n_tiles * math.ceil(m / plan.tile_m)
    assert plan.k_unit == math.lcm(SLICE_K, gs)
    units = k // plan.k_unit
    splits = plan.k_splits
    bounds = [s * units // splits * plan.k_unit for s in range(splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == k
    widths = [b - a for a, b in zip(bounds, bounds[1:])]
    assert min(widths) >= plan.k_unit
    assert plan.sb_groups == max(widths) // gs <= SB_GROUPS_MAX
    fewest = math.ceil(k // gs / SB_GROUPS_MAX)
    assert fewest <= splits <= max(fewest, min(units, F32_MAX_SPLITS))
    slots = f32_blocks_per_sm(plan.tile_m) * H100_SMS
    overhead = dequant_matmul.f32_split_overhead(plan.tile_m)
    cost = split_cost(splits, tiles, units, slots, overhead)
    for other in range(fewest, min(units, F32_MAX_SPLITS) + 1):
        alt = split_cost(other, tiles, units, slots, overhead)
        assert alt >= cost and (alt > cost or other >= splits)
    assert plan.blocks == tiles * splits
    split = splits > 1
    assert plan.workspace_floats == (
        splits * tiles * plan.tile_m * TILE_N if split else 0)
    assert plan.counters == (tiles if split else 0)


@pytest.mark.parametrize("offset,ring", [(0, True), (1, False), (2, False),
                                         (4, True)])
def test_plan_kernel_b_float32_sends_unaligned_x_to_the_simple_kernel(
        offset, ring):
    """launch_plan reads x's address: a float32 x that starts off a
    16-byte boundary takes the simple f32 kernel, one that starts on it
    the ring."""
    flat = torch.zeros(8 * 2048 + 4, dtype=torch.float32)
    assert flat.data_ptr() % 16 == 0
    x = flat[offset:offset + 8 * 2048].view(8, 2048)
    q = torch.zeros((1024, 2048), dtype=torch.uint8)
    plan = dequant_matmul.launch_plan(x, q, 64, H100_SMS)
    assert plan.ring == ring
    assert plan == plan_kernel_b_f32(8, 1024, 2048, 64, H100_SMS, ring)


def test_plan_kernel_b_splits_long_k_for_its_scale_bias_table():
    """gs=16 at K=6144: 384 groups need three splits even where the card
    is already full (64 tiles of 128 rows: one split by the wave rule)."""
    plan = plan_kernel_b(128, 8192, 6144, 16, H100_SMS)
    assert plan.k_splits == 3 and plan.sb_groups == SB_GROUPS_MAX


def test_kernel_b_scratch_is_kept_per_stream_and_grows_by_powers_of_two():
    """The split-K workspace and counters: allocated once per (device,
    stream), reused while large enough, grown to the next power of two."""
    dev = torch.device("cpu")
    small = plan_kernel_b(1, 1024, 3072, 64, H100_SMS)
    big = plan_kernel_b(128, 6144, 2048, 64, H100_SMS)
    assert small.workspace_floats < big.workspace_floats
    stream = -12345  # a stream handle no other test uses
    try:
        ws, cnt = dequant_matmul._scratch(dev, stream, small)
        assert ws.numel() >= small.workspace_floats and not cnt.any()
        assert dequant_matmul._scratch(dev, stream, small)[0] is ws
        ws2, cnt2 = dequant_matmul._scratch(dev, stream, big)
        assert ws2.numel() == 1 << (big.workspace_floats - 1).bit_length()
        assert cnt2 is cnt and ws2.dtype == torch.float32
        assert dequant_matmul._scratch(dev, stream + 1, small)[0] is not ws2
    finally:
        for key in [(None, stream), (None, stream + 1)]:
            dequant_matmul._SCRATCH.pop(key, None)


def test_kernel_sources_are_named_for_their_libraries():
    for k in cuda_kernels.KERNELS:
        assert k.source.is_file()
        assert k.library_path().parent == cuda_kernels.BUILD_DIR
        assert k.library_path().name.startswith(k.name + "-")
        assert [h.name for h in k.headers()] == ["cp_async.cuh"]


def test_library_name_hashes_the_headers_a_source_includes(tmp_path):
    """An edited header must rebuild: its bytes are in the library's name."""
    src = tmp_path / "k.cu"
    src.write_text('#include <stdint.h>\n#include "h.cuh"\nint f();\n')
    (tmp_path / "h.cuh").write_text("#pragma once\n")
    kern = cuda_kernels.Kernel("k", str(src), {"bfloat16": "f"}, [])
    assert kern.headers() == [tmp_path / "h.cuh"]
    before = kern.library_path()
    (tmp_path / "h.cuh").write_text("#pragma once\n// edited\n")
    assert kern.library_path() != before


# every flagship (N, K) at the rows the main path gives kernel A (decode,
# the code predictor's chunks, up to MAX_M prefill rows), the tiny ragged
# shape and shapes only the simple kernel takes
FLAGSHIP_A_CASES = [(m, n, k, 64) for n, k in FLAGSHIP_NK
                    for m in (1, 8, 24, 32, 64)]
PLAN_A_CASES = FLAGSHIP_A_CASES + [
    (3, 67, 64, 16), (5, 33, 36, 12), (2, 40, 96, 48), (1, 1040, 128, 32),
    (40, 2051, 6144, 16)]


@pytest.mark.parametrize("m,n,k,gs", PLAN_A_CASES)
def test_plan_kernel_a_splits_k_in_whole_slices_and_fills_the_card(m, n, k, gs):
    plan = plan_kernel_a(m, n, k, gs, H100_SMS)
    ring = k % grouped_qmv.SLICE_K == 0 and gs in (16, 32, 64)
    assert plan.ring == ring
    if (m, n, k, gs) in FLAGSHIP_A_CASES:
        assert plan.ring
    if not plan.ring:
        assert plan.bands == 0 and plan.k_splits == 1
        assert plan.rows == (1 if m == 1 else 8)
        assert plan.blocks == math.ceil(n / 32) * math.ceil(m / plan.rows)
        return
    # the smallest instance that holds every row: the weight is read once
    assert (plan.band_rows, plan.bands) in grouped_qmv.BANDS
    assert plan.rows == plan.band_rows * plan.bands >= m
    smaller = [r * b for r, b in grouped_qmv.BANDS if r * b < plan.rows]
    assert all(rows < m for rows in smaller)
    assert plan.ragged == (n % 16 != 0)
    # split s covers slices [s * units // S, (s + 1) * units // S), as the
    # kernel forms them: whole slices of whole groups
    assert plan.k_unit == grouped_qmv.SLICE_K and plan.k_unit % gs == 0
    units = k // plan.k_unit
    splits = plan.k_splits
    fewest = math.ceil(k // gs / grouped_qmv.SB_GROUPS_MAX)
    assert 1 <= splits <= max(fewest, min(units, grouped_qmv.MAX_SPLITS))
    bounds = [s * units // splits * plan.k_unit for s in range(splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == k
    widths = [b - a for a, b in zip(bounds, bounds[1:])]
    assert min(widths) >= plan.k_unit
    assert max(widths) - min(widths) <= plan.k_unit  # as even as slices go
    assert plan.sb_groups == max(widths) // gs <= grouped_qmv.SB_GROUPS_MAX
    tiles = math.ceil(n / grouped_qmv.TILE_N)
    assert plan.blocks == tiles * splits
    # no other split count the plan allows is rated cheaper, and none with
    # fewer splits as cheap
    slots = grouped_qmv.blocks_per_sm(plan.bands) * H100_SMS
    cost = grouped_qmv.split_cost(splits, tiles, units, slots)
    for other in range(fewest, min(units, grouped_qmv.MAX_SPLITS) + 1):
        alt = grouped_qmv.split_cost(other, tiles, units, slots)
        assert alt >= cost and (alt > cost or other >= splits)
    split = splits > 1
    assert plan.workspace_floats == (
        splits * tiles * plan.rows * grouped_qmv.TILE_N if split else 0)
    assert plan.counters == (tiles if split else 0)


def test_plan_kernel_a_fills_the_card_in_one_wave_at_decode():
    """At M=1 the talker's linears take the most splits, up to MAX_SPLITS,
    that fit one wave of resident blocks (3 an SM)."""
    for (n, k), want in {(6144, 2048): 8, (2048, 6144): 16, (2048, 2048): 16,
                         (2051, 2048): 16, (6144, 1024): 8}.items():
        plan = plan_kernel_a(1, n, k, 64, H100_SMS)
        assert plan.k_splits == want
        assert plan.blocks <= 3 * H100_SMS


def test_plan_kernel_a_sends_unaligned_pointers_to_the_simple_kernel():
    plan = plan_kernel_a(1, 1024, 3072, 64, H100_SMS, aligned=False)
    assert not plan.ring and plan.k_splits == 1 and plan.blocks == 32


def _f32_tensors(m, n, k, gs, x_offset=0, q_offset=0):
    """Float32 x [m, k] and codes qg [k/gs, gs, n] on the CPU whose first
    elements lie x_offset floats and q_offset bytes past 64-byte
    allocations."""
    xf = torch.zeros(m * k + x_offset, dtype=torch.float32)
    qf = torch.zeros(k * n + q_offset, dtype=torch.uint8)
    assert xf.data_ptr() % 16 == qf.data_ptr() % 16 == 0
    return (xf[x_offset:].view(m, k),
            qf[q_offset:].view(k // gs, gs, n))


@pytest.mark.parametrize("m,n,k,gs", FLAGSHIP_A_CASES[:5] + [
    (3, 67, 64, 16), (1, 6144, 2048, 64), (8, 2048, 6144, 64),
    (64, 2051, 2048, 64), (4, 1024, 2048, 32)])
def test_plan_kernel_a_takes_aligned_float32_x_through_the_ring(m, n, k, gs):
    """A float32 x on 16-byte boundaries takes the ring, planned as bf16's:
    the smallest instance that holds m, whole-slice splits and a workspace
    of one partial tile a split and tile."""
    x, qg = _f32_tensors(m, n, k, gs)
    plan = grouped_qmv.launch_plan(x, qg, H100_SMS)
    assert plan == plan_kernel_a(m, n, k, gs, H100_SMS)
    assert plan.ring and plan.bands >= 1 and plan.rows >= m
    assert plan.ragged == (n % 16 != 0)
    units = k // plan.k_unit
    bounds = [s * units // plan.k_splits * plan.k_unit
              for s in range(plan.k_splits + 1)]
    assert bounds[-1] == k and all(
        b - a >= grouped_qmv.SLICE_K for a, b in zip(bounds, bounds[1:]))
    tiles = math.ceil(n / grouped_qmv.TILE_N)
    assert plan.blocks == tiles * plan.k_splits
    assert plan.workspace_floats == (
        plan.k_splits * tiles * plan.rows * grouped_qmv.TILE_N
        if plan.k_splits > 1 else 0)


@pytest.mark.parametrize("m,n,k,gs,x_offset,q_offset", [
    (1, 2048, 2048, 64, 1, 0), (8, 6144, 2048, 64, 2, 0),
    (3, 1024, 2048, 64, 0, 4), (5, 33, 36, 12, 0, 0), (2, 40, 96, 48, 0, 0),
    (1, 1024, 1024, 128, 0, 0), (8, 512, 1056, 32, 0, 0)])
def test_plan_kernel_a_sends_unaligned_or_ragged_float32_x_to_the_simple_kernel(
        m, n, k, gs, x_offset, q_offset):
    """Unaligned x or qg, K not a multiple of 64, or gs not dividing 64
    take the simple kernel: 1 row a block at M=1, else 8, no split."""
    x, qg = _f32_tensors(m, n, k, gs, x_offset, q_offset)
    plan = grouped_qmv.launch_plan(x, qg, H100_SMS)
    assert not plan.ring and plan.bands == 0 and plan.k_splits == 1
    assert plan.rows == (1 if m == 1 else 8) and plan.workspace_floats == 0


def test_kernels_bind_a_bfloat16_and_a_float32_entry():
    assert cuda_kernels.GROUPED_QMV.symbols == {
        "bfloat16": "qmv_grouped_bf16", "float32": "qmv_grouped_f32"}
    assert cuda_kernels.DEQUANT_MATMUL.symbols == {
        "bfloat16": "dequant_matmul_bf16", "float32": "dequant_matmul_f32"}
    for k in cuda_kernels.KERNELS:
        text = k.source.read_text()
        assert all(f'extern "C" int {sym}(' in text for sym in k.symbols.values())


@pytest.mark.parametrize("grouped", [True, False], ids=["kernel_a", "kernel_b"])
def test_kernel_wrappers_refuse_other_activation_types(grouped):
    p = _quant(1, 64, 64, 16)
    w = pack_grouped(p) if grouped else p
    fn, keys = ((grouped_qmv_cuda, ("qg", "sg", "bg")) if grouped
                else (dequant_matmul_cuda, ("q", "scale", "bias")))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fn(torch.randn(2, 64).to(torch.float16), *(w[k] for k in keys))


def test_plan_kernel_a_takes_at_most_max_m_rows():
    assert plan_kernel_a(MAX_M, 1024, 1024, 64, H100_SMS).rows == MAX_M
    for m in (0, MAX_M + 1):
        with pytest.raises(ValueError, match="rows"):
            plan_kernel_a(m, 1024, 1024, 64, H100_SMS)


def test_plan_kernel_a_splits_long_k_for_its_scale_bias_table():
    """gs=16 at K=6144: 384 groups need six splits of 16 slices even where
    the 128 tiles already fill the card."""
    plan = plan_kernel_a(1, 16384, 6144, 16, H100_SMS)
    assert plan.k_splits == 6 and plan.sb_groups == grouped_qmv.SB_GROUPS_MAX


def test_kernels_a_and_b_share_one_streams_scratch():
    """Both wrappers take the split-K workspace and counters of the stream
    they launch on from one buffer pair, grown by powers of two."""
    dev = torch.device("cpu")
    a_small = plan_kernel_a(1, 2048, 2048, 64, H100_SMS)
    a_big = plan_kernel_a(64, 6144, 2048, 64, H100_SMS)
    b = plan_kernel_b(128, 6144, 2048, 64, H100_SMS)
    assert a_small.workspace_floats < b.workspace_floats < a_big.workspace_floats
    stream = -23456  # a stream handle no other test uses
    try:
        ws, cnt = dequant_matmul._scratch(dev, stream, a_small)
        assert grouped_qmv._scratch is dequant_matmul._scratch
        ws_b, cnt_b = dequant_matmul._scratch(dev, stream, b)
        assert ws_b.numel() == 1 << (b.workspace_floats - 1).bit_length()
        assert cnt_b is cnt and not cnt.any()
        ws_a, cnt_a = dequant_matmul._scratch(dev, stream, a_big)
        assert ws_a.numel() == 1 << (a_big.workspace_floats - 1).bit_length()
        assert cnt_a is cnt
        assert dequant_matmul._scratch(dev, stream, a_small)[0] is ws_a
        assert dequant_matmul._scratch(dev, stream, b)[0] is ws_a
    finally:
        dequant_matmul._SCRATCH.pop((None, stream), None)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    return torch.device("cuda")


def _card_weights(dev, seed, n, k, gs):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(0, 256, (n, k), dtype=torch.uint8, generator=g, device=dev)
    s = torch.rand((n, k // gs), generator=g, device=dev) * 1e-3
    b = -torch.rand((n, k // gs), generator=g, device=dev) * 1e-2
    return g, q, s, b


def _close(got, want):
    err = (got.float() - want.float()).abs().max()
    assert err <= REL_TOL * want.float().abs().max(), err


def _card_grouped(dev, seed, m, n, k, gs):
    g, q, s, b = _card_weights(dev, seed, n, k, gs)
    gp = pack_grouped({"q": q, "scale": s, "bias": b})
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    return x, gp["qg"], gp["sg"], gp["bg"]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,gs", [
    (1, 2048, 2048, 64), (8, 2051, 2048, 64), (32, 3072, 1024, 64),
    (64, 1024, 3072, 64), (3, 67, 64, 16), (2, 40, 96, 48),
    # split-K at M = 1, 8, 64; every instance of the ring; the head
    (1, 6144, 2048, 64), (1, 2048, 6144, 64), (8, 6144, 1024, 64),
    (64, 6144, 2048, 64), (2, 1024, 1024, 64), (4, 1024, 2048, 32),
    (16, 2048, 2048, 64), (24, 1024, 3072, 64), (40, 3072, 1024, 64),
    (1, 2051, 2048, 64), (64, 2051, 2048, 64), (5, 1040, 6144, 16),
    # the simple kernel: K not a multiple of 64, gs not dividing 64
    (5, 33, 36, 12), (1, 1024, 1056, 32), (8, 512, 768, 48),
])
def test_kernel_a_matches_plain_on_cuda(cuda_device, m, n, k, gs):
    x, qg, sg, bg = _card_grouped(cuda_device, 0, m, n, k, gs)
    before = cuda_kernels.GROUPED_QMV.launches
    got = quantized_matmul_grouped(x, qg, sg, bg)
    assert cuda_kernels.GROUPED_QMV.launches == before + 1
    assert (m, n, k, gs) in cuda_kernels.GROUPED_QMV.shapes
    _close(got, quantized_matmul_grouped_ref(x, qg, sg, bg))


@pytest.mark.cuda
def test_kernel_a_takes_unaligned_x_through_the_simple_kernel_on_cuda(
        cuda_device):
    _, qg, sg, bg = _card_grouped(cuda_device, 4, 1, 1024, 2048, 64)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    flat = torch.randn((3 * 2048 + 1,), generator=g, device=cuda_device)
    x = flat.to(torch.bfloat16)[1:].view(3, 2048)  # 2 bytes past alignment
    assert x.data_ptr() % 16 != 0
    assert not plan_kernel_a(3, 1024, 2048, 64, H100_SMS, aligned=False).ring
    _close(grouped_qmv_cuda(x, qg, sg, bg),
           quantized_matmul_grouped_ref(x, qg, sg, bg))


@pytest.mark.cuda
def test_kernel_a_repeats_bit_for_bit_between_kernel_b_launches_on_cuda(
        cuda_device):
    """Split-K partials are summed in split order whichever block finishes
    last; kernels A and B share one stream's workspace and counters, and A,
    B, A on that stream give A's bits again."""
    cases = [(1, 6144, 2048, 64), (8, 2048, 6144, 64), (64, 2051, 2048, 64)]
    assert all(plan_kernel_a(*c, H100_SMS).k_splits > 1 for c in cases)
    g, q, s, b = _card_weights(cuda_device, 6, 6144, 2048, 64)
    xb = torch.randn((128, 2048), generator=g, device=cuda_device)
    b_in = (xb.to(torch.bfloat16), q, s, b)
    for seed, case in enumerate(cases):
        a_in = _card_grouped(cuda_device, 20 + seed, *case)
        first = grouped_qmv_cuda(*a_in)
        assert torch.equal(first, grouped_qmv_cuda(*a_in))
        big = quantized_matmul(*b_in)
        assert torch.equal(first, grouped_qmv_cuda(*a_in))
        _close(first, quantized_matmul_grouped_ref(*a_in))
        _close(big, quantized_matmul_ref(*b_in))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,gs", [(1, 2048, 2048, 64), (32, 2051, 2048, 64),
                                      (128, 1024, 3072, 64), (3, 67, 64, 16),
                                      (2, 40, 96, 48), (5, 33, 36, 12),
                                      (1, 1024, 3072, 64), (24, 1024, 2048, 64),
                                      (128, 6144, 2048, 64),
                                      (200, 1024, 1024, 64)])
def test_kernel_b_matches_plain_on_cuda(cuda_device, m, n, k, gs):
    g, q, s, b = _card_weights(cuda_device, 1, n, k, gs)
    x = torch.randn((m, k), generator=g, device=cuda_device).to(torch.bfloat16)
    before = cuda_kernels.DEQUANT_MATMUL.launches
    got = quantized_matmul(x, q, s, b)
    assert cuda_kernels.DEQUANT_MATMUL.launches == before + 1
    assert (m, n, k, gs) in cuda_kernels.DEQUANT_MATMUL.shapes
    _close(got, quantized_matmul_ref(x, q, s, b))


@pytest.mark.cuda
def test_grouped_prefill_rows_take_the_dense_route_on_cuda(cuda_device):
    """M > 64 rows: dequantize once and one dense matmul, as the JAX
    package leaves prefill outside its kernel; no kernel launch."""
    g, q, s, b = _card_weights(cuda_device, 2, 256, 128, 64)
    gp = pack_grouped({"q": q, "scale": s, "bias": b})
    x = torch.randn((100, 128), generator=g, device=cuda_device).to(torch.bfloat16)
    before = cuda_kernels.GROUPED_QMV.launches
    got = quantized_matmul_grouped(x, gp["qg"], gp["sg"], gp["bg"])
    assert cuda_kernels.GROUPED_QMV.launches == before
    _close(got, quantized_matmul_grouped_ref(x, gp["qg"], gp["sg"], gp["bg"]))


@pytest.mark.cuda
def test_kernel_b_takes_unaligned_x_through_the_simple_kernel_on_cuda(
        cuda_device):
    g, q, s, b = _card_weights(cuda_device, 3, 1024, 2048, 64)
    flat = torch.randn((2 * 2048 + 1,), generator=g, device=cuda_device)
    x = flat.to(torch.bfloat16)[1:].view(2, 2048)  # 2 bytes past alignment
    assert x.data_ptr() % 16 != 0
    _close(quantized_matmul(x, q, s, b), quantized_matmul_ref(x, q, s, b))


@pytest.mark.cuda
def test_kernel_b_repeats_bit_for_bit_and_reuses_its_workspace_on_cuda(
        cuda_device):
    """Split-K partials are summed in split order whichever block finishes
    last; a later, larger shape grows the workspace and the first shape
    still gives the same bits."""
    shapes = [(1, 1024, 3072, 64), (128, 6144, 2048, 64)]
    assert all(plan_kernel_b(m, n, k, gs, H100_SMS).k_splits > 1
               for m, n, k, gs in shapes)
    inputs = []
    for seed, (m, n, k, gs) in enumerate(shapes):
        g, q, s, b = _card_weights(cuda_device, 10 + seed, n, k, gs)
        x = torch.randn((m, k), generator=g, device=cuda_device)
        inputs.append((x.to(torch.bfloat16), q, s, b))
    first = quantized_matmul(*inputs[0])
    assert torch.equal(first, quantized_matmul(*inputs[0]))
    big = quantized_matmul(*inputs[1])
    _close(big, quantized_matmul_ref(*inputs[1]))
    assert torch.equal(big, quantized_matmul(*inputs[1]))
    assert torch.equal(first, quantized_matmul(*inputs[0]))
    _close(first, quantized_matmul_ref(*inputs[0]))


# float32 instances: f32 products and sums in another order than the plain
# version's; 1e-5 of the output's range is ~100 f32 ulps of it
F32_REL_TOL = 1e-5
# the rings: split-K at M = 1 and 8, M = 16, 24, 32 and 64, the ragged N =
# 2051, gs = 16 and 32; then the simple kernels (ragged K or gs)
F32_CASES = [(1, 6144, 2048, 64), (8, 2048, 6144, 64), (40, 2051, 2048, 64),
             (64, 6144, 2048, 64), (32, 1024, 3072, 64), (1, 2051, 2048, 64),
             (16, 6144, 2048, 64), (24, 2048, 6144, 64),
             (2, 1040, 6144, 16), (4, 1024, 2048, 32),
             (3, 67, 64, 16), (5, 33, 36, 12)]
# kernel B's rows above kernel A's 64: the prefill bucket and a tp = 2
# gate/up shard at 512 rows
F32_B_CASES = [(128, 1024, 3072, 64), (128, 6144, 2048, 64),
               (512, 3072, 2048, 64)]


def _close_f32(got, want):
    assert got.dtype == want.dtype == torch.float32
    err = (got - want).abs().max()
    assert err <= F32_REL_TOL * want.abs().max(), err


@pytest.fixture
def no_tf32(cuda_device):
    """Full float32 in cuBLAS and cuDNN for the plain versions."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield cuda_device
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,gs", F32_CASES)
def test_kernel_a_float32_matches_plain_and_repeats_on_cuda(no_tf32, m, n, k, gs):
    x, qg, sg, bg = _card_grouped(no_tf32, 30, m, n, k, gs)
    x = x.float() + 1e-3 * torch.randn(x.shape, device=no_tf32)
    assert grouped_qmv.launch_plan(x, qg, H100_SMS).ring == (
        k % 64 == 0 and gs in (16, 32, 64))
    before = dict(cuda_kernels.GROUPED_QMV.by_dtype)
    got = quantized_matmul_grouped(x, qg, sg, bg)
    assert cuda_kernels.GROUPED_QMV.by_dtype == {**before, "float32": before["float32"] + 1}
    assert torch.equal(got, grouped_qmv_cuda(x, qg, sg, bg))
    _close_f32(got, quantized_matmul_grouped_ref(x, qg, sg, bg))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,gs", F32_CASES + F32_B_CASES)
def test_kernel_b_float32_matches_plain_and_repeats_on_cuda(no_tf32, m, n, k, gs):
    g, q, s, b = _card_weights(no_tf32, 31, n, k, gs)
    x = torch.randn((m, k), generator=g, device=no_tf32)
    assert dequant_matmul.launch_plan(x, q, gs, H100_SMS).ring == (
        k % 64 == 0 and gs % 16 == 0)
    before = dict(cuda_kernels.DEQUANT_MATMUL.by_dtype)
    got = quantized_matmul(x, q, s, b)
    assert cuda_kernels.DEQUANT_MATMUL.by_dtype == {**before, "float32": before["float32"] + 1}
    assert torch.equal(got, dequant_matmul_cuda(x, q, s, b))
    _close_f32(got, quantized_matmul_ref(x, q, s, b))


@pytest.mark.cuda
def test_float32_instances_repeat_bit_for_bit_between_each_others_launches_on_cuda(
        no_tf32):
    """Both float32 rings split K and share one stream's workspace and
    counters: A, B, A and B, A, B on that stream give each one's bits
    again, and both hold their plain versions."""
    a_in = _card_grouped(no_tf32, 40, 8, 6144, 2048, 64)
    a_in = (a_in[0].float(), *a_in[1:])
    g, q, s, b = _card_weights(no_tf32, 41, 2048, 6144, 64)
    b_in = (torch.randn((1, 6144), generator=g, device=no_tf32), q, s, b)
    big_in = (torch.randn((128, 6144), generator=g, device=no_tf32), q, s, b)
    assert grouped_qmv.launch_plan(a_in[0], a_in[1], H100_SMS).k_splits > 1
    for x in (b_in[0], big_in[0]):
        assert dequant_matmul.launch_plan(x, q, 64, H100_SMS).k_splits > 1
    a_first = grouped_qmv_cuda(*a_in)
    b_first = dequant_matmul_cuda(*b_in)
    big = dequant_matmul_cuda(*big_in)  # grows the shared workspace
    assert torch.equal(a_first, grouped_qmv_cuda(*a_in))
    assert torch.equal(b_first, dequant_matmul_cuda(*b_in))
    assert torch.equal(a_first, grouped_qmv_cuda(*a_in))
    assert torch.equal(big, dequant_matmul_cuda(*big_in))
    _close_f32(a_first, quantized_matmul_grouped_ref(*a_in))
    _close_f32(b_first, quantized_matmul_ref(*b_in))
    _close_f32(big, quantized_matmul_ref(*big_in))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["grouped", "rowmajor"])
def test_float32_int8_model_greedy_codes_equal_the_cpus_on_cuda(
        no_tf32, layout, monkeypatch):
    """A tiny float32 model with int8 weights (numpy-seeded): on the card
    its linears run on the f32 kernel instances, on the CPU on the plain
    versions; greedy codes equal token for token."""
    import dataclasses

    from qwen3_tts_tpu_torch.engine import configs
    from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
    from qwen3_tts_tpu_torch.engine.weights import tree_to
    from qwen3_tts_tpu_torch.runtime.generate import Generator
    from qwen3_tts_tpu_torch.runtime.prompts import build_prompt
    from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig

    monkeypatch.setenv("QWEN3_TTS_INT8_LAYOUT", layout)
    cfg = dataclasses.replace(configs.tiny(quant=True), dtype="float32")
    host = Qwen3TTSModel.synthetic(cfg, seed=0, device="cpu")
    prompt = build_prompt(host.tokenizer, cfg.mode, "Hello there.",
                          voice="ryan", speakers=cfg.speakers)
    kernel = (cuda_kernels.GROUPED_QMV if layout == "grouped"
              else cuda_kernels.DEQUANT_MATMUL)
    codes = {}
    for dev in ("cpu", no_tf32):
        trees = (tree_to(t, dev) for t in
                 (host.params, host.cp_params, host.codec_params))
        gen = Generator(cfg, *trees, sampling=SamplingConfig(greedy=True))
        before = kernel.launches
        res = gen.synthesize(prompt, max_frames=16, collect_codes=True)
        codes[str(dev)] = res.codes
        assert (kernel.launches > before) == (dev != "cpu")
    assert codes["cuda"].shape[1] > 4
    np.testing.assert_array_equal(codes["cuda"], codes["cpu"])


@pytest.mark.cuda
def test_float32_serving_codes_equal_the_cpus_on_cuda(no_tf32, monkeypatch):
    """The serving engine over a tiny float32 int8 model (grouped layout):
    three streams, one joining mid-flight, give on the card (kernel A at
    M = 4) the CPU's greedy codes."""
    import dataclasses

    from qwen3_tts_tpu_torch.engine import configs
    from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
    from qwen3_tts_tpu_torch.runtime.prompts import PromptSpec
    from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig

    monkeypatch.setenv("QWEN3_TTS_INT8_LAYOUT", "grouped")
    cfg = dataclasses.replace(configs.tiny(quant=True), dtype="float32")
    prompts = [PromptSpec(text_tokens=np.arange(6 + i, dtype=np.int32) * 7 % 200,
                          speaker_id=i) for i in range(3)]
    codes = {}
    for dev in ("cpu", no_tf32):
        model = Qwen3TTSModel.synthetic(cfg, seed=0, device="cpu").to(dev)
        model.sampling = SamplingConfig(greedy=True)
        eng = model.serving_engine(4)
        before = cuda_kernels.GROUPED_QMV.launches
        ids = [eng.submit(p, max_frames=12) for p in prompts[:2]]
        eng.step()
        ids.append(eng.submit(prompts[2], max_frames=8))
        while not all(eng.streams[i].done for i in ids):
            eng.step()
        codes[str(dev)] = [np.concatenate(eng.collect(i)[1].codes, axis=1)
                           for i in ids]
        assert (cuda_kernels.GROUPED_QMV.launches > before) == (dev != "cpu")
    for got, want in zip(codes["cuda"], codes["cpu"]):
        assert want.shape[1] > 0
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_int8_kv_cache_codes_equal_the_cpus_on_cuda(no_tf32, monkeypatch):
    """QWEN3_TTS_KV=int8 on a tiny float32 int8 model (grouped layout):
    single-stream and serving (a stream joining mid-flight) greedy codes on
    the card equal the CPU's."""
    import dataclasses

    from qwen3_tts_tpu_torch.engine import configs
    from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
    from qwen3_tts_tpu_torch.models.layers import KVQuant
    from qwen3_tts_tpu_torch.runtime.prompts import PromptSpec
    from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig

    monkeypatch.setenv("QWEN3_TTS_INT8_LAYOUT", "grouped")
    monkeypatch.setenv("QWEN3_TTS_KV", "int8")
    cfg = dataclasses.replace(configs.tiny(quant=True), dtype="float32")
    prompts = [PromptSpec(text_tokens=np.arange(6 + i, dtype=np.int32) * 7 % 200,
                          speaker_id=i) for i in range(3)]
    codes = {}
    for dev in ("cpu", no_tf32):
        model = Qwen3TTSModel.synthetic(cfg, seed=0, device="cpu").to(dev)
        model.sampling = SamplingConfig(greedy=True)
        eng = model.serving_engine(4)
        assert isinstance(eng.cache_k, KVQuant)
        ids = [eng.submit(p, max_frames=12) for p in prompts[:2]]
        eng.step()
        ids.append(eng.submit(prompts[2], max_frames=8))
        while not all(eng.streams[i].done for i in ids):
            eng.step()
        codes[str(dev)] = [np.concatenate(eng.collect(i)[1].codes, axis=1)
                           for i in ids] + [model.generator.synthesize(
                               prompts[0], max_frames=12,
                               collect_codes=True).codes]
    for got, want in zip(codes["cuda"], codes["cpu"]):
        assert want.shape[1] > 0
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_float32_clone_codes_equal_the_cpus_on_cuda(no_tf32, monkeypatch,
                                                    tmp_path):
    """synthetic:tiny:base at float32 (grouped layout) clones a fixed 1 s
    reference: its reference codes and greedy codes on the card equal the
    CPU's (the reference leaves the RVQ argmins a relative margin of
    3.5e-3)."""
    import dataclasses

    from qwen3_tts_tpu_torch.audio import write_wav
    from qwen3_tts_tpu_torch.engine import configs, prepare_segments
    from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
    from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig

    monkeypatch.setenv("QWEN3_TTS_INT8_LAYOUT", "grouped")
    rng = np.random.default_rng(3)
    t = np.arange(24000) / 24000
    f = 110 + 40 * np.sin(2 * np.pi * 0.7 * t)
    clip = (0.3 * np.sin(2 * np.pi * np.cumsum(f) / 24000)
            + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    ref = str(tmp_path / "ref.wav")
    write_wav(ref, clip, 24000)
    cfg = dataclasses.replace(configs.tiny("base", quant=True), dtype="float32")
    out = {}
    for dev in ("cpu", no_tf32):
        model = Qwen3TTSModel.synthetic(cfg, seed=0, device="cpu").to(dev)
        model.sampling = SamplingConfig(greedy=True)
        prompt = prepare_segments(model, "Hello there.", ref_audio=ref,
                                  ref_text="A reference.")[0][0]
        out[str(dev)] = (prompt.acoustic_codes, model.generator.synthesize(
            prompt, max_frames=12, collect_codes=True).codes)
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
