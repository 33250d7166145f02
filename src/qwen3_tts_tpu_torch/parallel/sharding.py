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
of each split leaf (``shard_params``); ``gather_params`` is the inverse
(the whole tree on rank 0). A spec is a tree of ``Split`` records: the
dim of a leaf that splits over tp, and over pp. Departures from the JAX
specs, where the port computes locally what GSPMD resolved: only leaves
under ``blocks`` split over tp (JAX's suffix rule also splits the MTP
block's ``mlp``; here the MTP chain runs whole on every rank, without a
collective); an out-sharded linear's additive ``b`` splits with its
output (JAX replicates it); and LoRA adapters split with the linear they
adapt (``lora_b`` with an out-sharded linear's rows, ``lora_a`` with an
in-sharded one's columns; JAX replicates them).

Training (``training_specs``) splits the talker's block leaves over tp,
and over pp when the mesh has stages (norms included), and replicates the
code predictor, as the JAX pipeline tests place them.
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
_LORA_LEAVES = ("lora_a", "lora_b")


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
      lora_a  [L, r, in]         lora_b  [L, out, r]
    """
    pp_dim = 0 if pp else None
    if leaf in _LORA_LEAVES:
        out = any(path.endswith(s) for s in _OUT_SHARDED) and leaf == "lora_b"
        into = any(path.endswith(s) for s in _IN_SHARDED) and leaf == "lora_a"
        return Split(1 if out else 2 if into else None, pp_dim)
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
        if path[-1] in _LINEAR_LEAVES + _LORA_LEAVES:
            return _linear_split("/".join(path[:-1]), path[-1], pp)
        return Split(None, 0 if pp else None)

    return _map(spec, params)


def replicated_spec(params: Any) -> Any:
    return _map(lambda _path, _leaf: REPLICATED, params)


def leaf_splits(tree: Any, spec_tree: Any) -> dict:
    """{``a/b/c`` path: ``Split``} of every leaf of ``tree``."""
    out: dict = {}
    _map(lambda path, _x, split: out.__setitem__("/".join(path), split),
         tree, spec_tree)
    return out


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


def _axes(mesh: Mesh, split: Split):
    """(axis, its size, dim) of each axis ``split`` cuts on ``mesh``."""
    return [(axis, n, dim) for axis, n, dim in (
        (TP_AXIS, mesh.plan.tp, split.tp), (PP_AXIS, mesh.plan.pp, split.pp))
        if dim is not None and n > 1]


def shard_leaf(x: torch.Tensor, split: Split, mesh: Mesh,
               name: str = "leaf") -> torch.Tensor:
    """This rank's contiguous block of ``x`` on ``mesh.device`` (a copy
    when cut, so the full leaf can be freed)."""
    cut = False
    for axis, n, dim in _axes(mesh, split):
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"{name}: dim {dim} of {tuple(x.shape)} does "
                             f"not split {n} ways")
        x = x.narrow(dim, mesh.coord(axis) * (size // n), size // n)
        cut = True
    return x.to(mesh.device, copy=cut, memory_format=torch.contiguous_format)


def gather_leaf(x: torch.Tensor, split: Split, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from every rank's block (over tp, then pp): a sum of
    zero-padded copies over each axis's group, exact."""
    from .comm import sum_

    groups = {TP_AXIS: mesh.tp_group, PP_AXIS: mesh.pp_group}
    for axis, n, dim in _axes(mesh, split):
        size = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = size * n
        buf = x.new_zeros(shape)
        buf.narrow(dim, mesh.coord(axis) * size, size).copy_(x)
        x = sum_(buf, groups[axis], mesh, "grad_sum")
    return x


def shard_params(params: Any, mesh: Mesh, spec_tree: Any = None) -> Any:
    """This rank's slice of a parameter tree, on ``mesh.device``: each
    split leaf keeps the contiguous block at the rank's coordinate (a copy,
    so the full leaf can be freed), the others are whole. The default spec
    is the talker's, with the layer axis over pp when the mesh has one."""
    if spec_tree is None:
        spec_tree = talker_param_spec(params, pp=mesh.plan.pp > 1)

    def place(path, x, split: Split):
        if not isinstance(x, torch.Tensor):
            return x
        return shard_leaf(x, split, mesh, "/".join(path))

    return _map(place, params, spec_tree)


def gather_params(tree: Any, mesh: Mesh, spec_tree: Any = None) -> Any:
    """Inverse of ``shard_params``: every rank calls it, and rank 0 gets
    the whole tree (on its device, detached; a leaf no axis splits is the
    rank's own tensor, not a copy); the others get None. The default spec
    is ``shard_params``'s."""
    if spec_tree is None:
        spec_tree = talker_param_spec(tree, pp=mesh.plan.pp > 1)

    def whole(_path, x, split: Split):
        if not isinstance(x, torch.Tensor):
            return x
        full = gather_leaf(x.detach(), split, mesh)
        return full if mesh.rank == 0 else None   # drop it as it comes

    out = _map(whole, tree, spec_tree)
    return out if mesh.rank == 0 else None


def training_specs(params: Any, cp_params: Any, mesh: Mesh) -> tuple:
    """(talker spec, code predictor spec) of training on ``mesh``: the
    talker's blocks over tp, and over pp at pp > 1; the code predictor
    replicated."""
    return (talker_param_spec(params, pp=mesh.plan.pp > 1),
            replicated_spec(cp_params))


def shard_for_training(cfg, params: Any, cp_params: Any, mesh: Mesh) -> tuple:
    """This rank's (talker, code predictor) trees for training ``cfg`` on
    ``mesh`` (``training_specs``). LoRA adapters split with their linears;
    add them to the whole tree first (their draws follow its shapes)."""
    from .mesh import validate_tp

    validate_tp(cfg, mesh.tp)
    specs = training_specs(params, cp_params, mesh)
    return (shard_params(params, mesh, specs[0]),
            shard_params(cp_params, mesh, specs[1]))


def tp_partial(path: tuple, sequence_parallel: bool) -> bool:
    """Whether a tp-replicated talker leaf at ``path`` gets a partial grad
    on each tp rank, to be summed over tp: a leaf used inside the tp
    region. These are the per-head ``q_norm``/``k_norm`` (each rank sees
    its heads), LoRA's ``lora_a`` of an out-sharded linear and ``lora_b``
    of an in-sharded one (each rank sees its rows or columns), and under
    sequence parallelism the block norms ``ln1``/``ln2`` (each rank sees
    its T slice)."""
    if "blocks" not in path:
        return False
    name, parent = path[-1], "/".join(path[:-1])
    if name in ("q_norm", "k_norm"):
        return True
    if name in ("ln1", "ln2"):
        return sequence_parallel
    if name == "lora_a":
        return any(parent.endswith(s) for s in _OUT_SHARDED)
    if name == "lora_b":
        return any(parent.endswith(s) for s in _IN_SHARDED)
    return False


def layer_keeper(mesh: Mesh, n_layers: int):
    """``keep(i, block)`` for ``models.talker.init_talker``: layer i's
    freshly drawn block tree cut to this rank's tp block, or None when the
    layer belongs to another pp stage; the kept layers stack into this
    rank's ``shard_params`` slice of the whole tree, and no rank holds
    more than one whole layer at a time."""
    if n_layers % mesh.plan.pp:
        raise ValueError(f"{n_layers} stacked layers not divisible by "
                         f"pp={mesh.plan.pp}")
    per_stage = n_layers // mesh.plan.pp
    stage = mesh.coord(PP_AXIS)

    def keep(i: int, block: dict):
        if i // per_stage != stage:
            return None
        spec = talker_param_spec({"blocks": block})["blocks"]

        def cut(path, x, split: Split):
            # the spec's dims count the stacked layer axis this leaf lacks
            unstacked = Split(None if split.tp is None else split.tp - 1)
            return shard_leaf(x, unstacked, mesh, "/".join(path))

        return _map(cut, block, spec)

    return keep


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
