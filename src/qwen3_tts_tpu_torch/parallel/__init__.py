"""Tensor-parallel decode over ``torch.distributed``: the port of the JAX
package's ``parallel/``.

One process a rank. ``mesh.build_mesh`` places the rank in a (pp, dp, tp)
mesh and creates its tp and dp groups; ``sharding.shard_model`` keeps the
rank's slice of the talker (and of the code predictor where its geometry
divides), and the generator and serving engine decode over it with local
head counts and one ``comm.tp_all_reduce`` after each o and down
projection (the psum XLA inserted in JAX). Every host decision (chunk
plan, EOS, budgets, slot admission) is taken from values that are equal
on every rank, so the ranks stay in lockstep. ``comm.launch`` starts
ranks on one host (tests, ``parallel.dryrun``, ``chip_smoke.py``);
under ``torchrun`` the caller initialises the group.

Decode shards over tp only. The dp and pp axes, sequence parallelism and
the GPipe pipeline are training's (ROADMAP item 15b).
"""

from .comm import launch, tp_all_reduce  # noqa: F401
from .mesh import Mesh, MeshPlan, build_mesh, local_mesh  # noqa: F401
from .sharding import (  # noqa: F401
    cache_sharding,
    shard_model,
    shard_params,
    talker_param_spec,
)
