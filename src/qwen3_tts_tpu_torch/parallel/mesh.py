"""Mesh construction: a (pp, dp, tp) shape over the ranks of a
``torch.distributed`` process group.

The JAX package's ``parallel/mesh.py``: ``MeshPlan``, ``auto_plan``,
``validate_tp`` and ``cp_tp_shardable`` are the same plain Python. Where
JAX lays devices out in a ``jax.sharding.Mesh`` and XLA inserts the
collectives, here every rank is one process: ``build_mesh`` places this
rank in the (pp, dp, tp) grid (tp innermost, as the JAX axis order) and
creates the process groups that ``parallel.comm`` reduces over: the tp
and dp lines, the pp line (the sums of grads of leaves every stage
holds) and the two-rank groups of adjacent stages (the pipeline's
shifts).
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import timedelta
from typing import Any

import torch

DP_AXIS = "dp"
TP_AXIS = "tp"
PP_AXIS = "pp"
# every process group gets a timeout: a rank that dies mid-collective fails
# the others' wait instead of hanging them
DEFAULT_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class MeshPlan:
    """Logical mesh shape. ``dp * tp * pp`` must equal the rank count."""

    dp: int = 1
    tp: int = 1
    pp: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp * self.pp


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (pp, dp, tp) mesh: its coordinates, the
    process groups it belongs to (None for a 1-rank axis), its device and
    the group's backend (None for the 1-rank mesh). ``rank`` is the global
    rank; ``prev_rank``/``next_rank`` the global ranks of the stages before
    and after it on its pp line (None at the ends), with ``prev_group`` and
    ``next_group`` the two-rank groups it shares with them."""

    plan: MeshPlan
    rank: int
    coords: tuple[int, int, int]      # (pp, dp, tp)
    device: torch.device
    backend: str | None = None
    tp_group: Any = None
    dp_group: Any = None
    pp_group: Any = None
    prev_group: Any = None
    next_group: Any = None
    prev_rank: int | None = None
    next_rank: int | None = None

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name, as a JAX mesh's ``shape``."""
        return {PP_AXIS: self.plan.pp, DP_AXIS: self.plan.dp,
                TP_AXIS: self.plan.tp}

    @property
    def tp(self) -> int:
        return self.plan.tp

    @property
    def dp(self) -> int:
        return self.plan.dp

    @property
    def pp(self) -> int:
        return self.plan.pp

    @property
    def first_stage(self) -> bool:
        return self.coords[0] == 0

    @property
    def last_stage(self) -> bool:
        return self.coords[0] == self.plan.pp - 1

    def coord(self, axis: str) -> int:
        return self.coords[(PP_AXIS, DP_AXIS, TP_AXIS).index(axis)]


def mesh_coords(rank: int, plan: MeshPlan) -> tuple[int, int, int]:
    """(pp, dp, tp) of ``rank`` in the ranks laid out as
    ``reshape(pp, dp, tp)``."""
    return (rank // (plan.dp * plan.tp), rank // plan.tp % plan.dp,
            rank % plan.tp)


def build_mesh(plan: MeshPlan, device, *, replicas: int = 1,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """This rank's mesh over the initialised default process group, whose
    world size must equal ``replicas * plan.n_devices``: ``replicas``
    copies of the mesh, each over consecutive ranks (replica k holds ranks
    k*n .. k*n+n-1), each with groups of its own. Every rank must call it
    (it creates every group collectively, in one order)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs an initialised process group "
            "(parallel.comm.launch, or torchrun and init_process_group)")
    world = dist.get_world_size()
    n = plan.n_devices
    if replicas * n != world:
        have = f"have {world}" if replicas == 1 else \
            f"{replicas} replicas need {replicas * n}, have {world}"
        raise ValueError(f"mesh plan {plan} needs {n} devices, {have}")
    rank = dist.get_rank()
    coords = mesh_coords(rank % n, plan)
    timeout = timedelta(seconds=timeout_s)
    pp, dp, tp = plan.pp, plan.dp, plan.tp

    def rank_of(k: int, p: int, d: int, t: int) -> int:
        return k * n + (p * dp + d) * tp + t

    reps = range(replicas)
    pp_lines = [[rank_of(k, p, d, t) for p in range(pp)]
                for k in reps for d in range(dp) for t in range(tp)]
    # every line of an axis is a group, created by every rank in one order
    lines = {
        TP_AXIS: [[rank_of(k, p, d, t) for t in range(tp)]
                  for k in reps for p in range(pp) for d in range(dp)]
        if tp > 1 else [],
        DP_AXIS: [[rank_of(k, p, d, t) for d in range(dp)]
                  for k in reps for p in range(pp) for t in range(tp)]
        if dp > 1 else [],
        PP_AXIS: pp_lines if pp > 1 else [],
        # adjacent stages: at pp = 2 the pp line is the pair
        "pairs": [line[s:s + 2] for line in pp_lines for s in range(pp - 1)]
        if pp > 2 else [],
    }
    groups: dict = {}
    pairs: dict = {}
    for axis, members_list in lines.items():
        for members in members_list:
            group = dist.new_group(members, timeout=timeout)
            if rank not in members:
                continue
            if axis == "pairs":
                pairs[tuple(members)] = group
            else:
                groups[axis] = group
    if pp == 2:
        pairs[tuple(next(ln for ln in pp_lines if rank in ln))] = \
            groups[PP_AXIS]
    prev_rank = rank - dp * tp if coords[0] > 0 else None
    next_rank = rank + dp * tp if coords[0] < pp - 1 else None
    return Mesh(plan, rank, coords, torch.device(device), dist.get_backend(),
                groups.get(TP_AXIS), groups.get(DP_AXIS), groups.get(PP_AXIS),
                pairs.get((prev_rank, rank)), pairs.get((rank, next_rank)),
                prev_rank, next_rank)


def local_mesh(device="cpu") -> Mesh:
    """The 1-rank mesh: no process group, nothing sharded."""
    return Mesh(MeshPlan(1, 1), 0, (0, 0, 0), torch.device(device))


def auto_plan(n_devices: int, *, max_tp: int = 8, tp_divisors: int = 8) -> MeshPlan:
    """Pick (dp, tp) for ``n_devices``: the largest tp <= max_tp that divides
    both ``n_devices`` and ``tp_divisors`` (the model's kv-head count —
    tensor parallelism cannot exceed it without head replication)."""
    tp = 1
    for cand in range(1, min(max_tp, n_devices, tp_divisors) + 1):
        if n_devices % cand == 0 and tp_divisors % cand == 0:
            tp = cand
    return MeshPlan(dp=n_devices // tp, tp=tp)


def validate_tp(cfg, tp: int) -> None:
    """Raise if the model dimensions can't be tensor-sharded ``tp`` ways."""
    t = cfg.talker
    problems = []
    if t.n_kv_heads % tp:
        problems.append(f"n_kv_heads={t.n_kv_heads} % tp={tp}")
    if t.n_heads % tp:
        problems.append(f"n_heads={t.n_heads} % tp={tp}")
    if t.ffn % tp:
        problems.append(f"ffn={t.ffn} % tp={tp}")
    if cfg.quant.enabled:
        # in-dim sharded quantized linears split the group axis
        for name, in_dim in (("o", t.q_dim), ("down", t.ffn)):
            groups = in_dim // cfg.quant.group_size
            if groups % tp:
                problems.append(
                    f"{name}-proj quant groups={groups} % tp={tp}"
                )
    if problems:
        raise ValueError("model not tp-shardable: " + "; ".join(problems))


def cp_tp_shardable(cfg, tp: int) -> bool:
    """Whether the code predictor's depth transformer can be tensor-sharded
    ``tp`` ways. The cp is MHA (k/v rows == q rows), so the head count is
    the kv constraint; quantized in-dim-sharded linears (o, down)
    additionally need their group axis divisible."""
    cp = cfg.code_predictor
    if tp <= 1:
        return False
    if cp.n_heads % tp or cp.ffn % tp:
        return False
    if cfg.quant.enabled:
        gs = min(cfg.quant.group_size, cp.hidden)
        for in_dim in (cp.n_heads * cp.head_dim, cp.ffn):
            if (in_dim // gs) % tp:
                return False
    return True
