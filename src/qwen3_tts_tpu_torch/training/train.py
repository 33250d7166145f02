"""The train step (the JAX package's training/train.py) on one device.

``make_train_step`` returns ``step(state, batch) -> (state, metrics)``, as
in the JAX package: loss and grads of the talker and code predictor
jointly, global-norm clipping, an AdamW update and the step counter, with
the state updated in place (the JAX step donates its input state) and
returned. Per step: ``loss.backward()``, the clip, ``optimizer.step()``,
then ``zero_grad(set_to_none=True)``.

Parameters stay the port's dict trees of tensors; the trainable leaves get
``requires_grad``. The optimizer is ``torch.optim.AdamW`` with optax
``adamw``'s decoupled decay and hyper-parameters, its moments in the
parameters' dtype (optax keeps them so; there are no float32 master
weights), after a clip written to optax's ``clip_by_global_norm`` formula
(``g * clip / |g|`` only when ``|g| >= clip``; torch's ``clip_grad_norm_``
divides by ``|g| + 1e-6`` instead).

``remat`` recomputes each transformer block in the backward pass
(``training.loss``); the JAX package wraps the whole loss in one
``jax.checkpoint``. Training across several devices (a mesh, pipeline
microbatches, sequence parallelism) is ROADMAP item 15.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..engine.configs import ModelConfig
from ..engine.weights import flatten_tree
from .loss import joint_loss


@dataclass
class TrainState:
    params: Any            # talker
    cp_params: Any         # code predictor
    opt_state: Any         # torch.optim.AdamW over the trainable leaves
    step: int


@dataclass(frozen=True)
class Optimizer:
    """optax ``chain(clip_by_global_norm(clip), adamw(lr, b1, b2, eps,
    weight_decay))`` as a recipe: ``build(leaves)`` makes the torch
    optimizer over a list of leaves. ``trainable``: one tuple of path
    substrings per tree of the state ((talker, code predictor) for
    ``TrainState``); only leaves whose ``a/b/c`` path contains one of its
    tree's substrings train, and the clip's norm covers those alone (the
    JAX package's ``optax.masked`` of the whole chain). None trains every
    floating-point leaf."""

    lr: float = 1e-4
    clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    trainable: tuple | None = None

    def build(self, leaves: list) -> torch.optim.AdamW:
        return torch.optim.AdamW(
            leaves, lr=self.lr, betas=(self.b1, self.b2), eps=self.eps,
            weight_decay=self.weight_decay)


def default_optimizer(lr: float = 1e-4, clip: float = 1.0) -> Optimizer:
    return Optimizer(lr=lr, clip=clip)


def tree_leaves(tree: Any) -> list[tuple[str, torch.Tensor]]:
    """(``a/b/c`` path, leaf) of every leaf, in the tree's order."""
    return list(flatten_tree(tree).items())


def tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def detach_tree(tree: Any) -> Any:
    """The tree with every leaf detached (views: no copy)."""
    return tree_map(torch.Tensor.detach, tree)


def clone_tree(tree: Any) -> Any:
    """A detached copy of every leaf (the frozen anchor/teacher trees)."""
    return tree_map(lambda x: x.detach().clone(), tree)


def freeze_tree(tree: Any) -> Any:
    """Clear ``requires_grad`` on every leaf (in place) and return the
    tree: inference then builds no autograd graph over trained weights."""
    for _, leaf in tree_leaves(tree):
        if leaf.requires_grad:
            leaf.requires_grad_(False)
    return tree


def trainable_leaves(trees: tuple, masks: tuple | None) -> list[torch.Tensor]:
    """Mark the trainable floating-point leaves of ``trees`` (per-tree
    path-substring masks, None = every leaf) ``requires_grad`` and clear
    it on the rest; returns the trainable leaves in tree order."""
    out = []
    for i, tree in enumerate(trees):
        subs = None if masks is None else masks[i]
        for path, leaf in tree_leaves(tree):
            train = leaf.is_floating_point() and (
                subs is None or any(s in path.lower() for s in subs))
            leaf.requires_grad_(train)
            if train:
                out.append(leaf)
    if not out:
        raise ValueError("no trainable leaves")
    return out


def device_batch(batch: dict, device) -> dict:
    """A host (numpy) batch -> tensors on ``device``: integer arrays as
    int64 (index tensors), masks as bool."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                            else v)
        if not (t.is_floating_point() or t.dtype == torch.bool):
            t = t.long()
        out[k] = t.to(device)
    return out


def init_train_state(params: Any, cp_params: Any,
                     optimizer: Optimizer) -> TrainState:
    """A TrainState over the live trees (not copied): the trainable leaves
    get ``requires_grad`` and an AdamW of ``optimizer`` over them, in tree
    order (a restore rebuilds the same order)."""
    leaves = trainable_leaves((params, cp_params), optimizer.trainable)
    return TrainState(params=params, cp_params=cp_params,
                      opt_state=optimizer.build(leaves), step=0)


def anchor_penalty(tree, ref, skip: tuple = ("mtp",)) -> torch.Tensor:
    """Mean squared distance to the anchor weights (detached), skipping
    leaves whose path contains any ``skip`` substring (freshly grafted
    recovery params, the MTP chain, must move freely from their random
    init)."""
    refs = dict(tree_leaves(ref))
    total = None
    n = 0
    for path, x in tree_leaves(tree):
        if any(s in path.lower() for s in skip):
            continue
        d = (x - refs[path].detach()).float()
        s = torch.sum(d * d)
        total = s if total is None else total + s
        n += x.numel()
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return total / max(n, 1)


def _optimizer_update(opt: torch.optim.Optimizer, clip: float) -> torch.Tensor:
    """Zero-fill missing grads (optax updates every leaf: a zero grad still
    decays the moments and the weight), clip to optax's formula, step, and
    clear the grads. Returns the pre-clip global norm (f32)."""
    leaves = [p for g in opt.param_groups for p in g["params"]]
    grads = []
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    norm = torch.sqrt(torch.stack([g.float().square().sum()
                                   for g in grads]).sum())
    clipped = norm >= clip
    for g in grads:
        g.copy_(torch.where(clipped, g / norm.to(g.dtype) * clip, g))
    opt.step()
    opt.zero_grad(set_to_none=True)
    return norm


def _base_config(cfg: ModelConfig) -> ModelConfig:
    """The sequential decode shape (fps=1, dg=1) of ``cfg``."""
    return dataclasses.replace(
        cfg,
        talker=dataclasses.replace(cfg.talker, frames_per_step=1,
                                   mtp_cp_batch=False),
        code_predictor=dataclasses.replace(cfg.code_predictor, depth_group=1,
                                           spec_decode=False),
    )


def _check_single_device(mesh, sequence_parallel: bool) -> None:
    axes = dict(getattr(mesh, "shape", mesh) or {})
    if sequence_parallel or int(np.prod(list(axes.values()) or [1])) > 1:
        raise NotImplementedError(
            f"training across devices (mesh {axes}, sequence_parallel="
            f"{sequence_parallel}) is not ported: ROADMAP item 15 (the "
            "port trains on one device)")


def make_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    *,
    cp_weight: float = 1.0,
    remat: bool = True,
    mesh=None,
    microbatches: int = 0,
    sequence_parallel: bool = False,
    anchor: tuple | None = None,
    anchor_weight: float = 0.0,
    distill: tuple | None = None,
    distill_weight: float = 0.0,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Returns ``step(state, batch) -> (state, metrics)``.

    ``batch``: text_tokens [B,Tt], codes [B,Q,Tf], frame_mask [B,Tf] (and
    text_mask, speaker_id), host arrays or tensors; moved to the
    parameters' device. ``anchor`` (frozen (params, cp_params)) adds
    ``anchor_weight`` times ``anchor_penalty``; ``distill`` (frozen
    teacher trees) adds ``distill_weight`` times
    ``loss.sequential_distill_loss``. metrics: talker_loss, cp_loss, loss,
    grad_norm (the pre-clip norm of the trainable leaves' grads) and
    anchor_pen / distill_kl when on, as detached tensors.

    ``mesh`` (axis sizes, e.g. ``{"dp": 1, "tp": 1, "pp": 2}``) over more
    than one device and ``sequence_parallel`` raise NotImplementedError:
    ROADMAP item 15. ``microbatches`` only applies to a pipeline."""
    if mesh is not None or sequence_parallel:
        _check_single_device(mesh, sequence_parallel)

    def loss_fn(params, cp_params, batch):
        return joint_loss(params, cp_params, cfg, batch, cp_weight=cp_weight,
                          remat=remat)

    if distill is not None and distill_weight > 0.0:
        # function-space anchor: KL to the frozen base model on the
        # sequential (fps=1, dg=1) path (loss.sequential_distill_loss)
        from .loss import sequential_distill_loss

        cfg_base = _base_config(cfg)
        ce_loss_fn = loss_fn

        def loss_fn(params, cp_params, batch):  # noqa: F811
            loss, metrics = ce_loss_fn(params, cp_params, batch)
            kl = sequential_distill_loss(params, cp_params, distill,
                                         cfg_base, batch, remat=remat)
            return loss + distill_weight * kl, {**metrics, "distill_kl": kl}

    if anchor is not None and anchor_weight > 0.0:
        # L2-SP anchored recovery: penalise distance to the pre-fine-tune
        # weights (the MTP chain free through the skip list)
        a_params, a_cp = anchor
        inner_loss_fn = loss_fn

        def loss_fn(params, cp_params, batch):  # noqa: F811
            loss, metrics = inner_loss_fn(params, cp_params, batch)
            pen = anchor_penalty(params, a_params) + anchor_penalty(
                cp_params, a_cp, skip=())
            return loss + anchor_weight * pen, {**metrics, "anchor_pen": pen}

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        device = state.opt_state.param_groups[0]["params"][0].device
        loss, metrics = loss_fn(state.params, state.cp_params,
                                device_batch(batch, device))
        loss.backward()
        norm = _optimizer_update(state.opt_state, optimizer.clip)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = norm
        return state, metrics

    return step


def synthetic_batch(
    cfg: ModelConfig, batch_size: int, t_text: int, t_frames: int, seed: int = 0
) -> dict:
    """Random teacher-forcing batch with the training layout (numpy, the
    JAX package's draws)."""
    rng = np.random.default_rng(seed)
    t = cfg.talker
    cc = cfg.codec
    codes = np.stack(
        [rng.integers(0, cc.codebook_size, (batch_size, t_frames))]
        + [
            rng.integers(0, cc.residual_codebook_size, (batch_size, t_frames))
            for _ in range(cc.num_codebooks - 1)
        ],
        axis=1,
    ).astype(np.int32)
    return {
        "text_tokens": rng.integers(
            0, t.vocab_size, (batch_size, t_text)
        ).astype(np.int32),
        "text_mask": np.ones((batch_size, t_text), dtype=bool),
        "codes": codes,
        "frame_mask": np.ones((batch_size, t_frames), dtype=bool),
        # alternate conditioned / unconditioned rows so the speaker-aware
        # training layout (training/loss.py) is always exercised
        "speaker_id": _alternating_speakers(batch_size, t.n_speakers),
    }


def _alternating_speakers(batch_size: int, n_speakers: int):
    sid = np.arange(batch_size, dtype=np.int32) % n_speakers
    sid[1::2] = -1  # odd rows train unconditioned
    return sid
