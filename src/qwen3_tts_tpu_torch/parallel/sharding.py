"""Tensor-parallel sharding rules for the model's parameter trees.

The JAX package's ``parallel/sharding.py``, Megatron-style:

- q/k/v and gate/up projections: output dimension over ``tp`` (each rank
  owns a head / ffn slice; no communication);
- o and down projections: input dimension over ``tp`` (the contraction
  gives partial sums, summed by ``comm.tp_all_reduce`` before the
  residual add: the psum XLA inserts in JAX);
- per-head norms, layer norms, embeddings, the head, the MTP heads:
  replicated;
- KV cache: batch over ``dp``, kv heads over ``tp``;
- quantized linears split codes and per-group scale/bias along the same
  logical dimension, so dequantization stays rank-local.

Where JAX annotates a placement and lets XLA slice, every rank here
builds (or loads) the same full tree and keeps its own contiguous slice
of each split leaf (``shard_params``). A spec is a tree of ``Split``
records: the dim of a leaf that splits over tp, and over pp. Two
departures from the JAX specs, both where the port computes locally what
GSPMD resolved: only leaves under ``blocks`` split over tp (JAX's suffix
rule also splits the MTP block's ``mlp``; here the MTP chain runs whole
on every rank, without a collective), and an out-sharded linear's
additive ``b`` splits with its output (JAX replicates it).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .mesh import DP_AXIS, PP_AXIS, TP_AXIS, Mesh

# leaf-path suffixes of the linears split over tp. Paths are "/"-joined
# dict keys, e.g. "blocks/attn/q/scale".
_OUT_SHARDED = ("attn/q", "attn/k", "attn/v", "mlp/gate", "mlp/up")
_IN_SHARDED = ("attn/o", "mlp/down")
_LINEAR_LEAVES = ("w", "q", "scale", "bias", "b")


class Split(NamedTuple):
    """The dims of one leaf split over tp and over pp (None: whole)."""

    tp: int | None = None
    pp: int | None = None


REPLICATED = Split()


def _linear_split(path: str, leaf: str, pp: bool) -> Split:
    """Split of one tensor of a stacked linear at ``path``.

    Layouts ([L] the stacked layer axis):
      w / q   [L, out, in]
      scale   [L, out, groups]   (groups track the *in* dimension)
      bias    [L, out, groups]
      b       [L, out]           (additive; added after the tp sum)
    """
    pp_dim = 0 if pp else None
    if any(path.endswith(s) for s in _OUT_SHARDED):
        return Split(1, pp_dim)
    if any(path.endswith(s) for s in _IN_SHARDED) and leaf != "b":
        # codes split the in axis; scale/bias split the group axis, both
        # the last dim
        return Split(2, pp_dim)
    return Split(None, pp_dim)


def _map(fn, tree: Any, *rest: Any, path: tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest),
                               path=path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def talker_param_spec(params: Any, *, pp: bool = False) -> Any:
    """``Split`` tree matching a talker (or code predictor) parameter tree.
    ``pp=True`` also splits every stacked-block leaf's layer axis over the
    pipeline axis."""

    def spec(path, _leaf) -> Split:
        # "blocks" anywhere in the path: the cp's draft adapter nests its
        # stacked block copy at draft/blocks
        if "blocks" not in path:
            return REPLICATED
        if path[-1] in _LINEAR_LEAVES:
            return _linear_split("/".join(path[:-1]), path[-1], pp)
        return Split(None, 0 if pp else None)

    return _map(spec, params)


def replicated_spec(params: Any) -> Any:
    return _map(lambda _path, _leaf: REPLICATED, params)


class Sharding(NamedTuple):
    """The mesh axis each dim of a tensor splits over (None: whole)."""

    mesh: Mesh
    axes: tuple

    def local_shape(self, shape: tuple) -> tuple:
        sizes = self.mesh.shape
        out = []
        for n, axis in zip(shape, self.axes):
            k = sizes[axis] if axis else 1
            if n % k:
                raise ValueError(f"dim {n} of {tuple(shape)} does not split "
                                 f"{k} ways over {axis}")
            out.append(n // k)
        return tuple(out)


def cache_sharding(mesh: Mesh) -> Sharding:
    """KV cache [L, B, S, H_kv, hd]: batch over dp, kv heads over tp."""
    return Sharding(mesh, (None, DP_AXIS, None, TP_AXIS, None))


def activation_sharding(mesh: Mesh) -> Sharding:
    """Activations [B, T, D]: batch over dp."""
    return Sharding(mesh, (DP_AXIS, None, None))


def shard_params(params: Any, mesh: Mesh, spec_tree: Any = None) -> Any:
    """This rank's slice of a parameter tree, on ``mesh.device``: each
    split leaf keeps the contiguous block at the rank's coordinate (a copy,
    so the full leaf can be freed), the others are whole. The default spec
    is the talker's, with the layer axis over pp when the mesh has one."""
    if spec_tree is None:
        spec_tree = talker_param_spec(params, pp=mesh.plan.pp > 1)
    axes = ((TP_AXIS, mesh.plan.tp), (PP_AXIS, mesh.plan.pp))

    def place(path, x, split: Split):
        if not isinstance(x, torch.Tensor):
            return x
        cut = False
        for (axis, n), dim in zip(axes, (split.tp, split.pp)):
            if dim is None or n == 1:
                continue
            size = x.shape[dim]
            if size % n:
                raise ValueError(f"{'/'.join(path)}: dim {dim} of "
                                 f"{tuple(x.shape)} does not split {n} ways")
            x = x.narrow(dim, mesh.coord(axis) * (size // n), size // n)
            cut = True
        return x.to(mesh.device, copy=cut, memory_format=torch.contiguous_format)

    return _map(place, params, spec_tree)


def cp_mesh(cfg, mesh: Mesh | None) -> Mesh | None:
    """The mesh the code predictor runs under: ``mesh`` when
    ``shard_model`` splits it over tp (``cp_tp_shardable``), else None
    (replicated, no collective)."""
    from .mesh import cp_tp_shardable

    return mesh if mesh is not None and cp_tp_shardable(cfg, mesh.tp) \
        else None


def shard_model(model, mesh: Mesh):
    """Slice a loaded Qwen3TTSModel's trees for this rank of ``mesh``, in
    place: the talker tensor-parallel; the code predictor tensor-parallel
    too when its depth-transformer geometry divides (``cp_tp_shardable``),
    else replicated; the codec replicated. Records the mesh on the model
    (its generator and serving engine decode over it) and returns it.
    Unmerged LoRA adapters are refused: merge them first
    (``training.lora.merge_lora``)."""
    from ..runtime.generate import _has_lora
    from .mesh import validate_tp

    validate_tp(model.cfg, mesh.tp)
    if _has_lora(model.params) or _has_lora(model.cp_params):
        raise ValueError("shard_model: the trees carry unmerged LoRA "
                         "adapters; merge them first (training.lora."
                         "merge_lora)")
    model.params = shard_params(model.params, mesh)
    cpm = cp_mesh(model.cfg, mesh)
    model.cp_params = shard_params(
        model.cp_params, mesh,
        talker_param_spec(model.cp_params) if cpm is not None
        else replicated_spec(model.cp_params))
    model.codec_params = shard_params(model.codec_params, mesh,
                                      replicated_spec(model.codec_params))
    model.device = mesh.device
    model.mesh = mesh
    model._generator = None
    model._serving = None
    return model
