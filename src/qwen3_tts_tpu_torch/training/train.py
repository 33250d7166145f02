"""The train step (the JAX package's training/train.py), on one device or
over the ranks of a (pp, dp, tp) mesh.

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
``jax.checkpoint``.

Over a mesh (``parallel/``; every rank makes the same calls) the state's
trees are this rank's slices (``parallel.sharding.shard_for_training``)
and each rank takes its dp rows of the global batch. What XLA inserted
is written out: the tp collectives inside the blocks (``parallel.comm``),
the GPipe schedule at pp > 1 (``parallel.pipeline``), the loss's global
masked mean over dp, then after the backward pass the grad sums
(``GradSync``): over tp for replicated leaves used inside the tp region,
over the pp line for leaves every stage holds (each stage computed its
own share), over dp for all. The global norm is the full, unsharded
grads' norm: a split leaf's squares summed over its axes, a replicated
leaf counted once, so the clip and ``grad_norm`` are optax's on one
device. Every rank then applies the same AdamW update to its slices.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..engine.configs import ModelConfig
from ..engine.weights import flatten_tree
from .data import dp_rows
from .loss import joint_loss


@dataclass
class TrainState:
    params: Any            # talker
    cp_params: Any         # code predictor
    opt_state: Any         # torch.optim.AdamW over the trainable leaves
    step: int
    mesh: Any = None       # the trees' mesh (None: whole trees, one device)


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
    # torch's multi-tensor update (None: its default, on for CUDA leaves)
    # makes temporaries the size of all the leaves; False updates one
    # leaf at a time (equal values)
    foreach: bool | None = None

    def build(self, leaves: list) -> torch.optim.AdamW:
        return torch.optim.AdamW(
            leaves, lr=self.lr, betas=(self.b1, self.b2), eps=self.eps,
            weight_decay=self.weight_decay, foreach=self.foreach)


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


def init_train_state(params: Any, cp_params: Any, optimizer: Optimizer,
                     mesh=None) -> TrainState:
    """A TrainState over the live trees (not copied): the trainable leaves
    get ``requires_grad`` and an AdamW of ``optimizer`` over them, in tree
    order (a restore rebuilds the same order). ``mesh``: the trees are
    this rank's slices on it (``parallel.sharding.shard_for_training``)."""
    leaves = trainable_leaves((params, cp_params), optimizer.trainable)
    return TrainState(params=params, cp_params=cp_params,
                      opt_state=optimizer.build(leaves), step=0, mesh=mesh)


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


def mesh_anchor_penalty(tree, ref, mesh, *, skip: tuple = ("mtp",),
                        talker: bool = True,
                        sequence_parallel: bool = False) -> tuple:
    """``anchor_penalty`` over ``mesh``, where ``tree`` and ``ref`` are this
    rank's slices (split as the training talker spec when ``talker``, else
    replicated). Returns (term, value):

    - ``value``: the JAX package's global mean, the squared distance summed
      over every element of the whole trees over their whole count, equal
      on every rank (a split leaf's partial sums summed over the axes that
      split it; replicated leaves and dp replicas counted once);
    - ``term``: what this rank's loss adds, each leaf's squared sum over
      the whole count AND over the ranks whose grad sums (``GradSync``) add
      this leaf's grad (dp; the pp line for a leaf every stage holds; tp for
      a ``tp_partial`` leaf), so each leaf receives the penalty's grad once.
    """
    from ..parallel.comm import sum_
    from ..parallel.sharding import (REPLICATED, leaf_splits,
                                     talker_param_spec, tp_partial)

    plan = mesh.plan
    spec = leaf_splits(tree, talker_param_spec(tree, pp=plan.pp > 1)) \
        if talker else {}
    refs = dict(tree_leaves(ref))
    term = None
    parts = []          # (split kind: 0 whole, 1 tp, 2 pp, 3 both; sum)
    n = 0
    for path, x in tree_leaves(tree):
        if any(s in path.lower() for s in skip):
            continue
        split = spec.get(path, REPLICATED)
        tp_cut = split.tp is not None and plan.tp > 1
        pp_cut = split.pp is not None and plan.pp > 1
        d = (x - refs[path].detach()).float()
        sq = torch.sum(d * d)
        shares = plan.dp * (1 if pp_cut else plan.pp) * (
            plan.tp if talker and tp_partial(tuple(path.split("/")),
                                             sequence_parallel) else 1)
        term = sq / shares if term is None else term + sq / shares
        parts.append((tp_cut + 2 * pp_cut, sq.detach()))
        n += x.numel() * (plan.tp if tp_cut else 1) * (
            plan.pp if pp_cut else 1)
    if term is None:
        zero = torch.zeros((), dtype=torch.float32, device=mesh.device)
        return zero, zero
    sums = torch.zeros(4, dtype=torch.float32, device=term.device)
    for k, sq in parts:
        sums[k] += sq
    if plan.tp > 1:
        sums[1::2] = sum_(sums[1::2].clone(), mesh.tp_group, mesh, "dp_sum")
    if plan.pp > 1:
        sums[2:] = sum_(sums[2:].clone(), mesh.pp_group, mesh, "dp_sum")
    return term / n, sums.sum() / n


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.plan.n_devices > 1


# elementwise work on a grad goes in pieces of at most this many elements,
# so no temporary of an embedding-sized leaf (311 M at the flagship's text
# vocabulary) is made in float32
CHUNK = 1 << 24


def _pieces(g: torch.Tensor) -> list[torch.Tensor]:
    flat = g.view(-1)
    return [flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK)]


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    """sum(g^2) in float32 (by pieces for a leaf above CHUNK elements)."""
    if g.numel() <= CHUNK:
        return g.float().square().sum()
    return torch.stack([p.float().square().sum() for p in _pieces(g)]).sum()


class GradSync:
    """The cross-rank half of a step over ``mesh``: ``entries`` holds, for
    each trainable leaf in optimizer order, its ``Split`` and whether it
    is a tp-replicated leaf used inside the tp region
    (``parallel.sharding.tp_partial``). Calling it on the leaves' grads
    sums them in place (module docstring) and returns the global norm."""

    def __init__(self, entries: list, mesh):
        self.entries, self.mesh = entries, mesh

    @classmethod
    def of(cls, trees: list, mesh, sequence_parallel: bool = False):
        """From (talker-like?, tree) pairs in optimizer order: the talker
        and LoRA trees split as ``training_specs``'s talker spec, the code
        predictor replicated."""
        from ..parallel.sharding import (REPLICATED, leaf_splits,
                                         talker_param_spec, tp_partial)

        entries = []
        for talker, tree in trees:
            spec = leaf_splits(tree, talker_param_spec(
                tree, pp=mesh.plan.pp > 1)) if talker else {}
            for path, leaf in tree_leaves(tree):
                if leaf.requires_grad:
                    parts = tuple(path.split("/"))
                    entries.append((spec.get(path, REPLICATED),
                                    talker and tp_partial(parts,
                                                          sequence_parallel)))
        return cls(entries, mesh)

    def _sum(self, grads: list, group) -> None:
        """Sum ``grads`` over ``group`` in place, as float32 chunks."""
        from ..parallel.comm import sum_

        pieces = [p for g in grads for p in _pieces(g)]
        while pieces:   # float32 all_reduces of at most CHUNK elements
            batch, n = [], 0
            while pieces and (not batch or n + pieces[0].numel() <= CHUNK):
                n += pieces[0].numel()
                batch.append(pieces.pop(0))
            flat = sum_(torch.cat([p.float() for p in batch]), group,
                        self.mesh, "grad_sum")
            off = 0
            for p in batch:
                p.copy_(flat[off:off + p.numel()])
                off += p.numel()

    def __call__(self, grads: list) -> torch.Tensor:
        from ..parallel.comm import sum_

        mesh, plan = self.mesh, self.mesh.plan
        if len(grads) != len(self.entries):
            raise ValueError(f"{len(grads)} grads for {len(self.entries)} "
                             "trainable leaves")
        pairs = list(zip(grads, self.entries))
        for n, group, pick in (
                (plan.tp, mesh.tp_group, lambda e: e[1]),
                (plan.pp, mesh.pp_group, lambda e: e[0].pp is None),
                (plan.dp, mesh.dp_group, lambda e: True)):
            if n > 1:
                self._sum([g for g, e in pairs if pick(e)], group)
        # squares of leaves split over (neither, tp, pp, both) axes
        sq = torch.zeros(4, dtype=torch.float32, device=grads[0].device)
        for g, (split, _) in pairs:
            k = (split.tp is not None and plan.tp > 1) \
                + 2 * (split.pp is not None and plan.pp > 1)
            sq[k] += _square_sum(g)
        if plan.tp > 1:
            sq[1::2] = sum_(sq[1::2].clone(), mesh.tp_group, mesh, "grad_sum")
        if plan.pp > 1:
            sq[2:] = sum_(sq[2:].clone(), mesh.pp_group, mesh, "grad_sum")
        return torch.sqrt(sq.sum())


def _optimizer_update(opt: torch.optim.Optimizer, clip: float,
                      sync: GradSync | None = None) -> torch.Tensor:
    """Zero-fill missing grads (optax updates every leaf: a zero grad still
    decays the moments and the weight), sum them across ranks (``sync``),
    clip to optax's formula, step, and clear the grads. Returns the
    pre-clip global norm (f32)."""
    leaves = [p for g in opt.param_groups for p in g["params"]]
    grads = []
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    if sync is None:
        norm = torch.sqrt(torch.stack([_square_sum(g) for g in grads]).sum())
    else:
        norm = sync(grads)
    clipped = norm >= clip
    for g in grads:
        for p in _pieces(g):
            p.copy_(torch.where(clipped, p / norm.to(p.dtype) * clip, p))
    opt.step()
    opt.zero_grad(set_to_none=True)
    return norm


METRIC_KEYS = ("talker_loss", "cp_loss", "loss")


def global_metrics(metrics: dict, mesh, device,
                   keys: tuple = METRIC_KEYS) -> dict:
    """This rank's loss metrics ``keys`` (its dp rows' share of the global
    means; absent on a pipeline stage other than the last) -> the global
    ones on every rank: summed over the pp line, then over dp. Other
    metrics (``anchor_pen``, global already) pass through."""
    from ..parallel.comm import sum_

    if not _sharded(mesh):
        return metrics
    zero = torch.zeros((), dtype=torch.float32, device=device)
    vec = torch.stack([metrics[k].detach().float() if k in metrics else zero
                       for k in keys])
    for n, group in ((mesh.plan.pp, mesh.pp_group),
                     (mesh.plan.dp, mesh.dp_group)):
        if n > 1:
            vec = sum_(vec.clone(), group, mesh, "dp_sum")
    return {**metrics, **dict(zip(keys, vec))}


def _base_config(cfg: ModelConfig) -> ModelConfig:
    """The sequential decode shape (fps=1, dg=1) of ``cfg``."""
    return dataclasses.replace(
        cfg,
        talker=dataclasses.replace(cfg.talker, frames_per_step=1,
                                   mtp_cp_batch=False),
        code_predictor=dataclasses.replace(cfg.code_predictor, depth_group=1,
                                           spec_decode=False),
    )


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

    ``mesh`` (``parallel.mesh``; the state's trees are this rank's slices
    on it): the step of the module docstring, whose batch is the global
    batch (each rank takes its dp rows) and whose metrics are global on
    every rank. At pp > 1 the talker's blocks run as a GPipe pipeline of
    ``microbatches`` microbatches (default 4 * pp; the batch must divide
    by it). ``sequence_parallel`` (needs a tp > 1 mesh) splits the
    residual stream along T over tp between the talker's blocks. The
    anchor and distillation terms train over a mesh too (their frozen trees
    are this rank's slices, placed as the state's): the distillation's
    student and teacher passes run through the pipeline (the teacher's
    without autograd, so no backward tick runs for it) and its KL on the
    last stage, beside the loss; ``mesh_anchor_penalty`` gives each leaf
    the penalty's grad once."""
    stack_fn = None
    if mesh is not None:
        from ..parallel.pipeline import talker_stack_fn

        if sequence_parallel and mesh.tp <= 1:
            raise ValueError("sequence_parallel needs a tp > 1 mesh")
        if mesh.plan.pp > 1:
            stack_fn = talker_stack_fn(
                cfg, mesh=mesh, microbatches=microbatches or 4 * mesh.plan.pp,
                remat=remat, sequence_parallel=sequence_parallel)
    elif sequence_parallel:
        raise ValueError("sequence_parallel needs a mesh")
    # the pipeline recomputes each stage already (parallel.pipeline)
    hooks = {"remat": remat and stack_fn is None, "stack_fn": stack_fn,
             "mesh": mesh, "sequence_parallel": sequence_parallel}
    summed = METRIC_KEYS

    def loss_fn(params, cp_params, batch):
        return joint_loss(params, cp_params, cfg, batch, cp_weight=cp_weight,
                          **hooks)

    if distill is not None and distill_weight > 0.0:
        # function-space anchor: KL to the frozen base model on the
        # sequential (fps=1, dg=1) path (loss.sequential_distill_loss)
        from .loss import sequential_distill_loss

        cfg_base = _base_config(cfg)
        ce_loss_fn = loss_fn
        summed = METRIC_KEYS + ("distill_kl",)

        def loss_fn(params, cp_params, batch):  # noqa: F811
            loss, metrics = ce_loss_fn(params, cp_params, batch)
            kl = sequential_distill_loss(params, cp_params, distill,
                                         cfg_base, batch, **hooks)
            if kl is None:   # a pipeline stage other than the last
                return loss, metrics
            return loss + distill_weight * kl, {**metrics, "distill_kl": kl}

    if anchor is not None and anchor_weight > 0.0:
        # L2-SP anchored recovery: penalise distance to the pre-fine-tune
        # weights (the MTP chain free through the skip list)
        a_params, a_cp = anchor
        inner_loss_fn = loss_fn

        def loss_fn(params, cp_params, batch):  # noqa: F811
            loss, metrics = inner_loss_fn(params, cp_params, batch)
            if _sharded(mesh):
                t_p, v_p = mesh_anchor_penalty(
                    params, a_params, mesh,
                    sequence_parallel=sequence_parallel)
                t_cp, v_cp = mesh_anchor_penalty(cp_params, a_cp, mesh,
                                                 skip=(), talker=False)
                term, pen = t_p + t_cp, v_p + v_cp
            else:
                term = pen = anchor_penalty(params, a_params) + \
                    anchor_penalty(cp_params, a_cp, skip=())
            # every stage adds its term (loss is None off the last stage)
            loss = anchor_weight * term if loss is None \
                else loss + anchor_weight * term
            return loss, {**metrics, "anchor_pen": pen}

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        device = state.opt_state.param_groups[0]["params"][0].device
        loss, metrics = loss_fn(state.params, state.cp_params,
                                device_batch(dp_rows(batch, mesh), device))
        if loss is not None:
            loss.backward()
        if stack_fn is not None:
            stack_fn.backward()
        sync = GradSync.of([(True, state.params), (False, state.cp_params)],
                           mesh, sequence_parallel) if _sharded(mesh) else None
        norm = _optimizer_update(state.opt_state, optimizer.clip, sync)
        state.step += 1
        metrics = global_metrics({k: v.detach() for k, v in metrics.items()},
                                 mesh, device, summed)
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
