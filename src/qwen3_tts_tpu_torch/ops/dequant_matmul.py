"""Row-major int8 weight-only matmul: plain version and kernel B.

``x [..., K] @ W^T`` with ``W[n, k] = q[n, k] * scale[n, k//gs] +
bias[n, k//gs]`` formed in f32 and rounded to the activation type before
the product (f32 accumulation, output in x.dtype): the JAX package's
``ops/linear.py::quantized_matmul_xla`` numerics.

``quantized_matmul`` dispatches on the tensor's device: a CPU tensor takes
the plain version ``quantized_matmul_ref``; a CUDA tensor launches kernel B
(``csrc/dequant_matmul.cu``) or raises.
"""

from __future__ import annotations

import torch

from .cuda_kernels import DEQUANT_MATMUL
from .quant import dequantize


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
    """Kernel B on the card: x2 [M, K] bf16 x row-major int8 W -> [M, N]."""
    n, k = q.shape
    g = scale.shape[-1]
    if x2.dtype != torch.bfloat16:
        raise TypeError(f"dequant_matmul: x must be bfloat16, got {x2.dtype}")
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
    with torch.cuda.device(x2.device):
        DEQUANT_MATMUL.launch(
            x2.data_ptr(), q.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), m, k, n, k // g,
            torch.cuda.current_stream(x2.device).cuda_stream,
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
