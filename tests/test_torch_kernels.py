"""The port's two CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with a GPU and no JAX:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tests that need the card carry the ``cuda`` marker and skip without one;
the CPU tests check the device dispatch (a CPU tensor never reaches a
kernel, a kernel wrapper refuses CPU tensors).
"""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch.ops import cuda_kernels
from qwen3_tts_tpu_torch.ops.dequant_matmul import (
    dequant_matmul_cuda,
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
                                      (2, 40, 96, 48), (5, 33, 36, 12)])
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
