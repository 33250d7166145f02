"""The port's two CUDA kernels against their plain PyTorch versions, and
kernel B's launch plan.

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
    MAX_SPLITS_WIDE,
    MIN_SPLIT_UNITS,
    SB_GROUPS_MAX,
    SLICE_K,
    TILE_N,
    dequant_matmul_cuda,
    plan_kernel_b,
    quantized_matmul,
    quantized_matmul_ref,
)
from qwen3_tts_tpu_torch.ops.grouped_qmv import (
    grouped_qmv_cuda,
    pack_grouped,
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


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,gs", [(1, 2048, 2048, 64), (8, 2051, 2048, 64),
                                      (32, 3072, 1024, 64), (64, 1024, 3072, 64),
                                      (3, 67, 64, 16), (2, 40, 96, 48)])
def test_kernel_a_matches_plain_on_cuda(cuda_device, m, n, k, gs):
    g, q, s, b = _card_weights(cuda_device, 0, n, k, gs)
    gp = pack_grouped({"q": q, "scale": s, "bias": b})
    x = torch.randn((m, k), generator=g, device=cuda_device).to(torch.bfloat16)
    before = cuda_kernels.GROUPED_QMV.launches
    got = quantized_matmul_grouped(x, gp["qg"], gp["sg"], gp["bg"])
    assert cuda_kernels.GROUPED_QMV.launches == before + 1
    assert (m, n, k, gs) in cuda_kernels.GROUPED_QMV.shapes
    _close(got, quantized_matmul_grouped_ref(x, gp["qg"], gp["sg"], gp["bg"]))


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
