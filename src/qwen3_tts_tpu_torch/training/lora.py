"""LoRA fine-tuning: low-rank adapters for parameter-efficient voice
adaptation (the JAX package's training/lora.py).

Full fine-tuning of the 1.7B talker costs the weights three times over in
optimizer moments and full-size gradients; adapting a voice rarely needs
that. LoRA trains rank-``r`` deltas ``scale * B @ A`` per linear (Hu et
al. 2021, arXiv:2106.09685), as a transformation of the parameter tree:

- :func:`add_lora` returns a new params tree where each targeted linear
  dict gains ``lora_a`` / ``lora_b`` / ``lora_scale`` leaves;
  ``ops.linear`` applies the delta whenever those keys are present, so no
  model code changes (stacked layers included: adapters stack along the
  same leading layer axis).
- :func:`split_lora` / :func:`merge_trees` partition the tree into
  (adapters, frozen base): the train step differentiates only the
  adapter leaves, so gradients and Adam moments are adapter-sized.
- :func:`merge_lora` folds trained deltas into the base weights and strips
  the adapter leaves: the deployed tree runs at the base model's cost.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..engine.configs import ModelConfig
from .loss import joint_loss
from .data import dp_rows
from .train import (
    GradSync,
    Optimizer,
    _optimizer_update,
    _sharded,
    detach_tree,
    device_batch,
    global_metrics,
    trainable_leaves,
)

# default adaptation surface: attention + MLP projections (every linear in
# the decoder blocks). Top-level linears (embeddings, heads) stay frozen.
DEFAULT_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")


def _is_linear_dict(node: Any) -> bool:
    """A linear param dict: dense ({"w": tensor}) or int8-quantized
    ({"q", "scale", "bias"}). Not an attention block dict: its "q" key is
    the q-projection sub-dict, which is why the quantized test needs the
    full key triple (ops.quant.is_quantized)."""
    from ..ops.quant import is_quantized

    if not isinstance(node, dict):
        return False
    if "w" in node and not isinstance(node["w"], dict):
        return True
    return is_quantized(node)


def add_lora(
    params: Any,
    *,
    rank: int = 8,
    alpha: float = 16.0,
    targets: tuple[str, ...] = DEFAULT_TARGETS,
    seed: int = 0,
) -> Any:
    """Return a copy of ``params`` with LoRA adapters on targeted linears.

    ``lora_a`` is Gaussian(0, 1/r), ``lora_b`` zeros: the standard init
    that makes the adapted model equal the base model at step 0. The draws
    are the JAX package's (``numpy.random.default_rng(seed)``, in tree
    order, rounded to the weight's dtype on the host), so the adapters
    equal its adapters bit for bit on any device; they are placed on the
    weight's device. Stacked layer leaves get one adapter per layer along
    the same axis. Quantized linears are rejected: training runs dense
    (``QWEN3_TTS_COMPUTE=bf16``, ops/quant.dequantize_tree)."""
    rng = np.random.default_rng(seed)

    def to(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(like.dtype).to(like.device)

    def walk(node: Any, name: str) -> Any:
        if _is_linear_dict(node):
            if name not in targets:
                return node
            if "w" not in node:
                raise ValueError(
                    f"LoRA target {name!r} is int8-quantized; dequantize the "
                    "tree to dense weights before add_lora (training runs "
                    "dense — see ops.quant.dequantize_tree)"
                )
            w = node["w"]
            if w.ndim == 2:            # [out, in]
                out_d, in_d = w.shape
                a = rng.normal(0.0, 1.0 / rank, (rank, in_d))
                b = np.zeros((out_d, rank))
                scale = np.asarray(alpha / rank)
            elif w.ndim == 3:          # stacked: [L, out, in]
                L, out_d, in_d = w.shape
                a = rng.normal(0.0, 1.0 / rank, (L, rank, in_d))
                b = np.zeros((L, out_d, rank))
                scale = np.full((L,), alpha / rank)
            else:
                raise ValueError(
                    f"unexpected weight ndim for {name!r}: {tuple(w.shape)}")
            return {**node, "lora_a": to(a, w), "lora_b": to(b, w),
                    "lora_scale": to(scale, w)}
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return node

    return walk(params, "")


def merge_lora(params: Any) -> Any:
    """Fold every adapter's delta into its base weight and strip the
    adapter leaves: W' = W + scale * (B @ A), in float32, rounded once to
    W's dtype. The result runs at the base model's inference cost. A
    stacked leaf merges one layer at a time, so the float32 temporaries
    are one layer's, not the stack's."""

    def merged(w, a, b, s):
        return (w.float() + s.float() * (b.float() @ a.float())).to(w.dtype)

    def walk(node: Any) -> Any:
        if _is_linear_dict(node) and "lora_a" in node:
            w, a, b, s = (node[k].detach() for k in
                          ("w", "lora_a", "lora_b", "lora_scale"))
            if w.ndim == 2:
                out = merged(w, a, b, s)
            else:  # stacked [L, out, in]
                out = torch.empty_like(w)
                for i in range(w.shape[0]):
                    out[i] = merged(w[i], a[i], b[i], s[i])
            rest = {k: v for k, v in node.items()
                    if k not in ("lora_a", "lora_b", "lora_scale")}
            return {**rest, "w": out}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    with torch.no_grad():
        return walk(params)


def split_lora(tree: Any) -> tuple[Any, Any]:
    """Partition a params tree into (adapters, base): two trees of nested
    dicts whose union of leaves is the input's. The adapter tree holds the
    trainable ``lora_a``/``lora_b`` leaves only; ``lora_scale`` stays in
    the frozen base (a constant of the parameterization, which AdamW's
    weight decay would otherwise shrink)."""
    lora: dict = {}
    base: dict = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sub_l, sub_b = split_lora(v)
            if sub_l:
                lora[k] = sub_l
            base[k] = sub_b
        elif k in ("lora_a", "lora_b"):
            lora[k] = v
        else:
            base[k] = v
    return lora, base


def split_subtree(params: Any, key: str) -> tuple[Any, Any]:
    """Partition by a top-level key: the named subtree becomes the
    trainable tree, everything else the frozen base (the adapter state
    machinery then trains grafted modules, e.g. MTP heads on an imported
    checkpoint, with head-sized optimizer state)."""
    if key not in params:
        raise KeyError(f"params have no {key!r} subtree")
    return {key: params[key]}, {k: v for k, v in params.items() if k != key}


def merge_trees(base: Any, lora: Any) -> Any:
    """Inverse of :func:`split_lora`: recombine adapters with the base."""
    out = dict(base)
    for k, v in lora.items():
        if isinstance(v, dict):
            out[k] = merge_trees(base.get(k, {}), v)
        else:
            out[k] = v
    return out


@dataclass
class LoraTrainState:
    """Adapter-only optimizer state: gradients and Adam moments are sized
    by the adapters (rank * dims), not the 1.7B base."""

    lora: Any              # talker adapter subtree (split_lora output)
    opt_state: Any         # torch.optim.AdamW over the adapter leaves
    step: int
    mesh: Any = None       # the trees' mesh (None: one device)


def init_lora_train_state(lora: Any, optimizer: Optimizer,
                          mesh=None) -> LoraTrainState:
    """``mesh``: the adapters are this rank's slices on it (they split
    with the linears they adapt, ``parallel.sharding``)."""
    leaves = trainable_leaves((lora,), None)
    return LoraTrainState(lora=lora, opt_state=optimizer.build(leaves),
                          step=0, mesh=mesh)


def make_lora_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    *,
    cp_weight: float = 1.0,
    remat: bool = True,
    mesh=None,
) -> Callable:
    """``step(state, base_params, cp_params, batch) -> (state, metrics)``.

    Differentiates the same joint loss as the full train step
    (training/train.py) but only through the adapter leaves: the base and
    the whole code predictor enter detached, so no gradient of their size
    is ever allocated. ``mesh``: a dp x tp mesh whose slices the trees are
    (the adapters' grads summed as the full step's, ``GradSync``); the
    batch is the global one."""
    if mesh is not None and mesh.plan.pp > 1:
        raise ValueError("the LoRA step runs on a dp x tp mesh: its "
                         "adapter-sized step has no layer pipeline")

    def step(state: LoraTrainState, base_params: Any, cp_params: Any,
             batch: dict) -> tuple[LoraTrainState, dict]:
        device = state.opt_state.param_groups[0]["params"][0].device
        params = merge_trees(detach_tree(base_params), state.lora)
        loss, metrics = joint_loss(params, detach_tree(cp_params), cfg,
                                   device_batch(dp_rows(batch, mesh), device),
                                   cp_weight=cp_weight, remat=remat,
                                   mesh=mesh)
        loss.backward()
        sync = GradSync.of([(True, state.lora)], mesh) \
            if _sharded(mesh) else None
        norm = _optimizer_update(state.opt_state, optimizer.clip, sync)
        state.step += 1
        metrics = global_metrics({k: v.detach() for k, v in metrics.items()},
                                 mesh, device)
        metrics["grad_norm"] = norm
        return state, metrics

    return step
