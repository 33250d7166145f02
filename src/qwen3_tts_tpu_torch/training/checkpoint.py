"""Training checkpoint/resume (the JAX package's training/checkpoint.py,
without orbax).

A crashed or preempted fine-tune resumes from the last saved state:
params, optimizer moments and step counter. One ``step_%08d`` directory a
save holds ``state.pt`` (``torch.save`` of the state's parameter trees,
the optimizer's ``state_dict()`` and the step). It is written under a
``-tmp`` name and renamed when complete, so ``latest_checkpoint`` never
returns a half-written save (orbax's in-flight naming, which the JAX
package's ``latest_checkpoint`` skips the same way). The format is the
port's own: an orbax checkpoint of the JAX package does not load here.

One format whatever the mesh, as the JAX package's orbax checkpoint: a
state on a mesh (``state.mesh``) is gathered to rank 0, parameters and
AdamW moments alike (``parallel.sharding.gather_params``), which writes
the file a one-device run writes; every rank calls ``save_train_state``
and returns once the file is complete. ``restore_train_state`` onto any
mesh (the template's) cuts the saved whole leaves and moments to the
rank's slices.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any

import torch

from ..engine.weights import flatten_tree
from .train import detach_tree

STATE_FILE = "state.pt"


def _tree_fields(state: Any) -> list[str]:
    """The parameter-tree fields of a TrainState / LoraTrainState."""
    return [f.name for f in dataclasses.fields(state)
            if f.name not in ("opt_state", "step", "mesh")]


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.plan.n_devices > 1


def _specs(state: Any) -> dict:
    """Each tree field's spec on ``state.mesh`` (the code predictor
    replicated, the talker and LoRA trees as the talker)."""
    from ..parallel.sharding import replicated_spec, talker_param_spec

    pp = state.mesh.plan.pp > 1
    return {name: replicated_spec(getattr(state, name))
            if name == "cp_params"
            else talker_param_spec(getattr(state, name), pp=pp)
            for name in _tree_fields(state)}


def _moment_splits(state: Any, specs: dict) -> list:
    """The ``Split`` of each optimizer parameter, in optimizer order (the
    trainable leaves of the tree fields in tree order)."""
    from ..parallel.sharding import leaf_splits

    out = []
    for name in _tree_fields(state):
        tree = getattr(state, name)
        splits = leaf_splits(tree, specs[name])
        out += [splits[path] for path, leaf in flatten_tree(tree).items()
                if leaf.requires_grad]
    return out


def _map_moments(opt_state: dict, splits: list, fn) -> dict:
    """``opt_state`` (a state_dict) with ``fn(tensor, split)`` applied to
    every per-parameter tensor of a parameter's shape (the moments)."""
    state = {i: {k: fn(v, splits[i]) if torch.is_tensor(v) and v.dim() else v
                 for k, v in st.items()}
             for i, st in opt_state["state"].items()}
    return {**opt_state, "state": state}


def save_train_state(state: Any, directory: str, step: int | None = None) -> str:
    """Save ``state`` under ``directory`` (one subdir per step). Returns the
    checkpoint path."""
    if step is None:
        step = int(state.step)
    path = os.path.abspath(os.path.join(directory, f"step_{step:08d}"))
    trees = {name: detach_tree(getattr(state, name))
             for name in _tree_fields(state)}
    opt_state = state.opt_state.state_dict()
    mesh = getattr(state, "mesh", None)
    if _sharded(mesh):
        from ..parallel.sharding import gather_leaf, gather_params

        specs = _specs(state)
        opt_state = _map_moments(opt_state, _moment_splits(state, specs),
                                 lambda v, split: gather_leaf(v, split, mesh))
        trees = {name: gather_params(tree, mesh, specs[name])
                 for name, tree in trees.items()}
    if not _sharded(mesh) or mesh.rank == 0:
        tmp = path + "-tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"kind": type(state).__name__, "trees": trees,
                    "opt_state": opt_state, "step": step},
                   os.path.join(tmp, STATE_FILE))
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    if _sharded(mesh):
        import torch.distributed as dist

        dist.barrier()   # the file is complete for every rank
    return path


def latest_checkpoint(directory: str) -> str | None:
    if not os.path.isdir(directory):
        return None
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_")
        and "-tmp" not in d  # in-flight saves ("-tmp" or "-tmp-<ts>")
        and os.path.isdir(os.path.join(directory, d))
    )
    return os.path.join(directory, steps[-1]) if steps else None


def _copy_into(dst: Any, src: Any, name: str) -> None:
    want, got = flatten_tree(dst), flatten_tree(src)
    if want.keys() != got.keys():
        raise ValueError(f"checkpoint tree {name} differs from the "
                         f"template's: {sorted(set(want) ^ set(got))[:5]}")
    for path, leaf in want.items():
        saved = got[path]
        if saved.shape != leaf.shape or saved.dtype != leaf.dtype:
            raise ValueError(
                f"checkpoint leaf {name}/{path}: {saved.dtype} "
                f"{tuple(saved.shape)}, the template holds {leaf.dtype} "
                f"{tuple(leaf.shape)}")
        leaf.copy_(saved)


def restore_train_state(path: str, template: Any) -> Any:
    """Restore a train state into ``template``, a live state of the same
    kind and structure (e.g. a freshly initialised one): its leaves are
    overwritten in place on their device, and its optimizer, built over
    the same leaves in the same order, loads the saved ``state_dict()``.
    On a mesh (``template.mesh``) each rank keeps its slices of the saved
    whole leaves and moments. Returns the template."""
    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True, mmap=True)
    if saved["kind"] != type(template).__name__:
        raise ValueError(f"{path} holds a {saved['kind']}, the template is a "
                         f"{type(template).__name__}")
    trees, opt_state = saved["trees"], saved["opt_state"]
    mesh = getattr(template, "mesh", None)
    if _sharded(mesh):
        from ..parallel.sharding import shard_leaf, shard_params

        specs = _specs(template)
        trees = {name: shard_params(trees[name], mesh, specs[name])
                 for name in _tree_fields(template)}
        opt_state = _map_moments(opt_state, _moment_splits(template, specs),
                                 lambda v, split: shard_leaf(v, split, mesh))
    with torch.no_grad():
        for name in _tree_fields(template):
            _copy_into(getattr(template, name), trees[name], name)
    template.opt_state.load_state_dict(opt_state)
    template.step = int(saved["step"])
    return template
