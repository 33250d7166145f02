"""Parameter initialisers shared by the talker, code predictor and codec.

Two sources of synthetic values behind one interface:

- ``HostInit``: numpy draws from ``np.random.default_rng(seed)`` in the
  JAX package's order, so a float32 config gives the JAX initialisers'
  values exactly; leaves end as CPU tensors.
- ``DeviceInit``: fast draws from a seeded ``torch.Generator`` on the
  device (uniform u8 codes with a constant scale/bias grid for quantized
  linears, as the JAX package's ``fast`` path) — a 1.7B-parameter model is
  made in place on the card instead of built on the host and uploaded.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.quant import quantize_weights


class HostInit:
    def __init__(self, seed: int, dtype: torch.dtype):
        self.rng = np.random.default_rng(seed)
        self.dtype = dtype
        self.device = torch.device("cpu")

    def normal(self, shape, std: float) -> torch.Tensor:
        a = self.rng.normal(0.0, std, size=shape).astype(np.float32)
        return torch.from_numpy(a).to(self.dtype)

    def linear(self, out_dim: int, in_dim: int, *, quantize: bool,
               group_size: int, bits: int = 8, std: float = 0.02) -> dict:
        w = self.rng.normal(0.0, std, size=(out_dim, in_dim)).astype(np.float32)
        if quantize:
            return {k: torch.from_numpy(v) for k, v in
                    quantize_weights(w, group_size=group_size, bits=bits).items()}
        return {"w": torch.from_numpy(w).to(self.dtype)}

    def ones(self, n: int) -> torch.Tensor:
        return torch.ones(n, dtype=self.dtype)

    def zeros(self, n: int) -> torch.Tensor:
        return torch.zeros(n, dtype=self.dtype)

    def full(self, n: int, value: float) -> torch.Tensor:
        return torch.full((n,), value, dtype=self.dtype)


class DeviceInit:
    def __init__(self, seed: int, dtype: torch.dtype, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.dtype = dtype

    def normal(self, shape, std: float) -> torch.Tensor:
        x = torch.randn(shape, generator=self.gen, device=self.device)
        return (x * std).to(self.dtype)

    def linear(self, out_dim: int, in_dim: int, *, quantize: bool,
               group_size: int, bits: int = 8, std: float = 0.02) -> dict:
        if quantize:
            levels = (1 << bits) - 1
            g = in_dim // group_size
            return {
                "q": torch.randint(0, levels + 1, (out_dim, in_dim),
                                   dtype=torch.uint8, generator=self.gen,
                                   device=self.device),
                "scale": torch.full((out_dim, g), 2.0 * std / levels,
                                    dtype=torch.float32, device=self.device),
                "bias": torch.full((out_dim, g), -std, dtype=torch.float32,
                                   device=self.device),
            }
        # U(-a, a) with the variance of N(0, std): a = std * sqrt(3)
        u = torch.rand((out_dim, in_dim), generator=self.gen, device=self.device)
        return {"w": ((u - 0.5) * (2.0 * std * 1.7320508)).to(self.dtype)}

    def ones(self, n: int) -> torch.Tensor:
        return torch.ones(n, dtype=self.dtype, device=self.device)

    def zeros(self, n: int) -> torch.Tensor:
        return torch.zeros(n, dtype=self.dtype, device=self.device)

    def full(self, n: int, value: float) -> torch.Tensor:
        return torch.full((n,), value, dtype=self.dtype, device=self.device)


def make_init(seed: int, dtype: torch.dtype, device=None):
    """HostInit for ``device=None``, DeviceInit otherwise."""
    return HostInit(seed, dtype) if device is None else DeviceInit(seed, dtype, device)


def stack_trees(trees: list):
    """Stack a list of identical param trees along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees, dim=0)
