"""On-device token sampling (greedy / temperature / top-k / top-p).

Random draws come from an explicit ``torch.Generator`` on the logits'
device (Gumbel-max over the filtered logits, the same distribution as the
JAX package's ``jax.random.categorical``; the bits differ).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.9
    top_k: int = 50          # 0 disables
    top_p: float = 1.0       # 1.0 disables
    greedy: bool = False


def filtered_logits(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """Temperature/top-k/top-p filtered logits over the LAST axis (kept
    entries scaled by 1/temperature, dropped entries -inf): the categorical
    distribution ``sample_token`` draws from. Undefined (raises) for greedy
    or temperature <= 0 configs."""
    if cfg.greedy or cfg.temperature <= 0.0:
        raise ValueError(
            "filtered_logits is undefined for greedy/temperature<=0 "
            "configs (argmax has no filtered distribution)"
        )
    logits = logits / cfg.temperature
    neg_inf = float("-inf")
    if cfg.top_k and 0 < cfg.top_k < logits.shape[-1]:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, neg_inf)
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p
        cutoff_idx = (cum < cfg.top_p).sum(dim=-1, keepdim=True)
        cutoff_idx = cutoff_idx.clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, neg_inf)
    return logits


def sample_token(
    logits: torch.Tensor,                  # [B, V] float32
    generator: torch.Generator | None,
    cfg: SamplingConfig,
) -> torch.Tensor:
    """One token id per row (int64): argmax for greedy configs, otherwise a
    draw from the filtered distribution with ``generator``."""
    if cfg.greedy or cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    fl = filtered_logits(logits.float(), cfg)
    u = torch.rand(fl.shape, generator=generator, device=fl.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(fl + gumbel, dim=-1)
