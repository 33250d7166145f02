"""Parallel decode and training over ``torch.distributed``: the port of the
JAX package's ``parallel/``.

One process a rank. ``mesh.build_mesh`` places the rank in a (pp, dp, tp)
mesh and creates its process groups. Decode shards over tp:
``sharding.shard_model`` keeps the rank's slice of the talker (and of the
code predictor where its geometry divides), and the generator and serving
engine decode over it with local head counts and one sum after each o
and down projection (``comm.reduce_from_tp``, the psum XLA inserted in
JAX). Every host decision (chunk plan, EOS, budgets, slot admission) is
taken from values that are equal on every rank, so the ranks stay in
lockstep.

Training runs on any (pp, dp, tp) mesh (``training.train``):
``sharding.shard_for_training`` splits the talker's blocks over tp and pp,
``comm`` holds the collectives as autograd functions (tp, sequence
parallelism), and ``pipeline`` the GPipe schedule over the pp stages.
``comm.launch`` starts ranks on one host (tests, ``parallel.dryrun``,
``chip_smoke.py``); under ``torchrun`` the caller initialises the group.
"""

from .comm import launch, reduce_from_tp  # noqa: F401
from .mesh import Mesh, MeshPlan, build_mesh, local_mesh  # noqa: F401
from .pipeline import pipeline_stack, talker_stack_fn  # noqa: F401
from .sharding import (  # noqa: F401
    cache_sharding,
    gather_params,
    shard_for_training,
    shard_model,
    shard_params,
    talker_param_spec,
)
