"""Parameter initialisers shared by the talker, code predictor and codec.

Sources of leaves behind one interface (``normal`` and ``linear`` draw;
``ones``, ``zeros`` and ``full`` are exact in every source):

- ``HostInit``: numpy draws from ``np.random.default_rng(seed)`` in the
  JAX package's order, so the JAX initialisers' values exactly (bf16
  leaves are rounded from float32 as the JAX package rounds them); leaves
  end as CPU tensors. ``limit`` stops drawing after that many draws and
  leaves the rest uninitialised.
- ``DeviceInit``: fast draws from a seeded ``torch.Generator`` on the
  device (uniform u8 codes with a constant scale/bias grid for quantized
  linears, as the JAX package's ``fast`` path) — a 1.7B-parameter model is
  made in place on the card instead of built on the host and uploaded.
- ``TemplateInit``: leaves of the right shape and type on the host with
  no values drawn (uninitialised memory), the tree a checkpoint import
  fills.
- ``IndexInit``: each drawn leaf is the number of its draw, one value
  (stacked leaves: one a row), so an importer can tell which draws made
  the leaves a checkpoint left unfilled.

The init functions take ``device``: None for ``HostInit``, a device for
``DeviceInit``, or an ``InitPlan``, which makes one source per random
stream (per ``make_init`` call, in call order).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.quant import quantize_weights


class TemplateInit:
    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.device = torch.device("cpu")

    def normal(self, shape, std: float) -> torch.Tensor:
        return torch.empty(shape, dtype=self.dtype)

    def linear(self, out_dim: int, in_dim: int, *, quantize: bool,
               group_size: int, bits: int = 8, std: float = 0.02) -> dict:
        if quantize:
            g = in_dim // group_size
            return {"q": torch.empty((out_dim, in_dim), dtype=torch.uint8),
                    "scale": torch.empty((out_dim, g), dtype=torch.float32),
                    "bias": torch.empty((out_dim, g), dtype=torch.float32)}
        return {"w": torch.empty((out_dim, in_dim), dtype=self.dtype)}

    def ones(self, n: int) -> torch.Tensor:
        return torch.ones(n, dtype=self.dtype)

    def zeros(self, n: int) -> torch.Tensor:
        return torch.zeros(n, dtype=self.dtype)

    def full(self, n: int, value: float) -> torch.Tensor:
        return torch.full((n,), value, dtype=self.dtype)


class HostInit(TemplateInit):
    def __init__(self, seed: int, dtype: torch.dtype, limit: int | None = None):
        super().__init__(dtype)
        self.rng = np.random.default_rng(seed)
        self.limit = limit
        self.draws = 0

    def _draw(self) -> bool:
        self.draws += 1
        return self.limit is None or self.draws <= self.limit

    def normal(self, shape, std: float) -> torch.Tensor:
        if not self._draw():
            return super().normal(shape, std)
        a = self.rng.normal(0.0, std, size=shape).astype(np.float32)
        return torch.from_numpy(a).to(self.dtype)

    def linear(self, out_dim: int, in_dim: int, *, quantize: bool,
               group_size: int, bits: int = 8, std: float = 0.02) -> dict:
        if not self._draw():
            return super().linear(out_dim, in_dim, quantize=quantize,
                                  group_size=group_size, bits=bits)
        w = self.rng.normal(0.0, std, size=(out_dim, in_dim)).astype(np.float32)
        if quantize:
            return {k: torch.from_numpy(v) for k, v in
                    quantize_weights(w, group_size=group_size, bits=bits).items()}
        return {"w": torch.from_numpy(w).to(self.dtype)}


class IndexInit:
    """Draw i of stream s as ``s * 2**32 + i`` in a float64 [1] tensor;
    exact leaves as -1."""

    def __init__(self, stream: int):
        self.base = stream * 2**32
        self.draws = 0

    def normal(self, shape, std: float) -> torch.Tensor:
        self.draws += 1
        return torch.full((1,), float(self.base + self.draws - 1),
                          dtype=torch.float64)

    def linear(self, out_dim: int, in_dim: int, *, quantize: bool,
               group_size: int, bits: int = 8, std: float = 0.02) -> dict:
        i = self.normal((), std)
        return ({"q": i, "scale": i, "bias": i} if quantize else {"w": i})

    def ones(self, n: int) -> torch.Tensor:
        return torch.full((1,), -1.0, dtype=torch.float64)

    zeros = ones

    def full(self, n: int, value: float) -> torch.Tensor:
        return self.ones(n)


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


class InitPlan:
    """The source of every random stream of one init call: ``"template"``
    (TemplateInit), ``"index"`` (IndexInit) or ``"host"`` (HostInit, the
    k-th stream drawing its first ``limits[k]`` draws only)."""

    def __init__(self, kind: str, limits: dict | None = None):
        if kind not in ("template", "index", "host"):
            raise ValueError(f"InitPlan kind {kind!r}")
        self.kind = kind
        self.limits = limits or {}
        self.streams = 0

    def stream(self, seed: int, dtype: torch.dtype):
        k = self.streams
        self.streams += 1
        if self.kind == "template":
            return TemplateInit(dtype)
        if self.kind == "index":
            return IndexInit(k)
        return HostInit(seed, dtype, limit=self.limits.get(k, 0))


def make_init(seed: int, dtype: torch.dtype, device=None):
    """HostInit for ``device=None``, a plan's source for an ``InitPlan``,
    DeviceInit otherwise."""
    if device is None:
        return HostInit(seed, dtype)
    if isinstance(device, InitPlan):
        return device.stream(seed, dtype)
    return DeviceInit(seed, dtype, device)


def stack_trees(trees: list):
    """Stack a list of identical param trees along a new leading axis, dict
    keys in sorted order (``jax.tree.map``'s order, so a tree walk visits
    the leaves in the JAX package's order: training.lora.add_lora draws)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in sorted(first)}
    return torch.stack(trees, dim=0)
