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
            if f.name not in ("opt_state", "step")]


def save_train_state(state: Any, directory: str, step: int | None = None) -> str:
    """Save ``state`` under ``directory`` (one subdir per step). Returns the
    checkpoint path."""
    if step is None:
        step = int(state.step)
    path = os.path.abspath(os.path.join(directory, f"step_{step:08d}"))
    tmp = path + "-tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({
        "kind": type(state).__name__,
        "trees": {name: detach_tree(getattr(state, name))
                  for name in _tree_fields(state)},
        "opt_state": state.opt_state.state_dict(),
        "step": step,
    }, os.path.join(tmp, STATE_FILE))
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
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
    Returns the template."""
    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    if saved["kind"] != type(template).__name__:
        raise ValueError(f"{path} holds a {saved['kind']}, the template is a "
                         f"{type(template).__name__}")
    with torch.no_grad():
        for name in _tree_fields(template):
            _copy_into(getattr(template, name), saved["trees"][name], name)
    template.opt_state.load_state_dict(saved["opt_state"])
    template.step = int(saved["step"])
    return template
