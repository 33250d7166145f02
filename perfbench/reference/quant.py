"""Weights as the reference reads them, and the control's lower precision.

A raw linear is ``{"w": dense}`` or the 8-bit snapshot's affine groups
``{"q": uint8 codes [..., N, K], "scale", "bias": [..., N, K / gs]}`` with
``W[n, k] = scale[n, k // gs] * q[n, k] + bias[n, k // gs]``. The
reference forms that product in float32.

``Precision`` says how a run computes: the reference takes every weight as
stated and float32 activations. The controls take bfloat16 activations,
the program's activation type, and lower the weights:

- ``lower`` (``CONTROL``): each weight one step below its stated precision
  (8-bit codes requantized to 4 bits in affine groups of 64 along the
  input; dense bfloat16 weights rounded to float8 e4m3 with a scale a row);
- ``int8`` (``INT8``): the program's own 8-bit path for a dense
  configuration: every dense linear through affine 8-bit groups of 64, as
  the 8-bit snapshot stores them, the tables left as stated.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

GROUP = 64


def dequant(node: dict) -> torch.Tensor:
    """The float32 weight of a raw linear (any leading stacked axes)."""
    if "w" in node:
        return node["w"].float()
    q, scale, bias = node["q"], node["scale"], node["bias"]
    *lead, n, k = q.shape
    g = scale.shape[-1]
    w = q.float().reshape(*lead, n, g, k // g)
    w = w * scale.float()[..., None] + bias.float()[..., None]
    return w.reshape(*lead, n, k)


def fp8_requant(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded to float8 e4m3 with one scale a row (its largest
    magnitude at e4m3's largest finite value, 448), returned in float32."""
    rows = w.float().reshape(-1, w.shape[-1])
    scale = (rows.abs().amax(dim=-1, keepdim=True) / 448.0).clamp_min(1e-30)
    q = (rows / scale).to(torch.float8_e4m3fn).float()
    return (q * scale).reshape(w.shape)


def affine_requant(w: torch.Tensor, bits: int, group: int = GROUP) -> torch.Tensor:
    """``w`` through affine min/max quantization to ``bits`` in groups of
    ``group`` consecutive elements of its last axis (the whole row when the
    row does not divide), returned dequantized in float32."""
    shape = w.shape
    row = shape[-1]
    g = group if row % group == 0 else row
    x = w.float().reshape(-1, row // g, g)
    lo = x.amin(dim=-1, keepdim=True)
    hi = x.amax(dim=-1, keepdim=True)
    levels = (1 << bits) - 1
    scale = ((hi - lo) / levels).clamp_min(1e-12)
    q = torch.clamp(torch.round((x - lo) / scale), 0, levels)
    return (q * scale + lo).reshape(shape)


@dataclass(frozen=True)
class Precision:
    """How the teacher-forced pass computes: ``act`` is the activation type;
    ``lower`` moves every weight matrix one step below its stated
    precision."""

    name: str
    act: torch.dtype
    lower: str = ""          # "", "step" or "int8"

    def weight(self, node: dict) -> torch.Tensor:
        """A raw linear's weight at this precision, in float32."""
        w = dequant(node)
        if self.lower == "int8":
            return w if "q" in node else affine_requant(w, 8)
        if self.lower != "step":
            return w
        return affine_requant(w, 4) if "q" in node else fp8_requant(w)

    def table(self, t: torch.Tensor) -> torch.Tensor:
        """A dense matrix that is not a linear (an embedding table, the
        predictor's heads, a convolution) at this precision, in float32."""
        w = t.float()
        if self.lower != "step" or w.dim() < 2:
            return w
        return fp8_requant(w.reshape(w.shape[0], -1)).reshape(w.shape)


REFERENCE = Precision("reference", torch.float32)
CONTROL = Precision("lower", torch.bfloat16, "step")
INT8 = Precision("int8", torch.bfloat16, "int8")
CONTROLS = {p.name: p for p in (CONTROL, INT8)}
