"""Compute ops. Two hand-written CUDA kernels carry every int8 linear:

- kernel A, ``grouped_qmv.quantized_matmul_grouped`` (grouped layout,
  decode rows), from ``csrc/grouped_qmv.cu``;
- kernel B, ``dequant_matmul.quantized_matmul`` (row-major layout), from
  ``csrc/dequant_matmul.cu``.

Each dispatches on the tensor's device: the kernel for a CUDA tensor, its
plain PyTorch version (same module) for a CPU tensor. Attention, norms,
RoPE, sampling and the codec convs are plain PyTorch ops.
"""

from .linear import linear  # noqa: F401
from .quant import dequantize, quantize_weights  # noqa: F401
