"""``linear``: the single matmul entry point of the model layers.

Weights follow the ``[out, in]`` convention; activations are ``[..., in]``.
The branch is picked by the parameter dict's layout (dense, row-major int8,
grouped int8), and the device by the tensor: int8 layouts launch their CUDA
kernel for a CUDA tensor and take their plain version for a CPU tensor.
Under tensor parallelism an in-sharded linear (o, down) gives partial
sums; ``linear(..., mesh=mesh)`` sums them over the tp group before its
additive bias, which is added once (``comm.reduce_from_tp``: identity
backward). With ``sp`` (sequence parallelism) the sum is a reduce-scatter
along T instead (``comm.scatter_seq``).
"""

from __future__ import annotations

import torch

from ..parallel.comm import reduce_from_tp, scatter_seq
from .dequant_matmul import dense_matmul, quantized_matmul
from .grouped_qmv import is_grouped, quantized_matmul_grouped
from .quant import is_quantized


def linear(x: torch.Tensor, params: dict, mesh=None,
           sp: bool = False) -> torch.Tensor:
    """Apply a (possibly quantized) linear layer parameter dict to x.

    LoRA adapters (``lora_a`` [r, in], ``lora_b`` [out, r], ``lora_scale``)
    add ``scale * (x A^T) B^T``; an additive ``b`` is added last. ``mesh``
    (an in-sharded linear's): the product is summed over its tp group
    before ``b``; with ``sp``, reduce-scattered along T (dim 1)."""
    if is_grouped(params):
        out = quantized_matmul_grouped(x, params["qg"], params["sg"], params["bg"])
    elif is_quantized(params):
        out = quantized_matmul(x, params["q"], params["scale"], params["bias"])
    else:
        out = dense_matmul(x, params["w"])
    if "lora_a" in params:
        delta = dense_matmul(dense_matmul(x, params["lora_a"]), params["lora_b"])
        scale = torch.as_tensor(params["lora_scale"]).to(x.dtype)
        out = out + scale * delta
    out = scatter_seq(out, mesh) if sp else reduce_from_tp(out, mesh)
    if "b" in params:
        out = out + params["b"].to(out.dtype)
    return out
