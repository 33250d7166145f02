"""The collectives that XLA inserted in the JAX package, and the launcher
of a group of ranks.

Tensor-parallel decode needs one collective: the sum over the tp group of
the o and down projections' partial outputs (``tp_all_reduce``; the psum
of the JAX package's ``parallel/sharding.py``), one ``all_reduce`` on
every backend. ``launch`` starts one process a rank with the ``spawn``
start method and a ``FileStore`` in a fresh temporary directory (no TCP
port to race for), and returns each rank's result; a rank that raises
fails the launch with its traceback. Under ``torchrun`` the caller
initialises the group from its environment instead.

The backend and the devices are the caller's, never guessed: ``nccl``
needs one card a rank (it refuses two ranks on one device), ``gloo``
takes CPU tensors, and CUDA tensors through host memory. Nothing here
switches either on its own.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from datetime import timedelta

import torch

from .mesh import DEFAULT_TIMEOUT_S

# tp_all_reduce's calls since the last reset, the host seconds they took,
# and (gloo, CUDA tensors) the seconds spent first waiting for the card
ALL_REDUCE = {"calls": 0, "host_s": 0.0, "sync_s": 0.0}


def reset_all_reduce_stats() -> None:
    ALL_REDUCE.update(calls=0, host_s=0.0, sync_s=0.0)


def tp_all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``x`` over the tp group of ``mesh``, in place; returns ``x``. A
    no-op without a mesh or at tp = 1."""
    if mesh is None or mesh.tp == 1:
        return x
    import torch.distributed as dist

    if x.is_cuda and mesh.backend == "gloo":
        # gloo stages a CUDA tensor through host memory, which waits for
        # the card's queued work anyway: wait first, so that host_s counts
        # the sum alone
        t0 = time.perf_counter()
        torch.cuda.synchronize(x.device)
        ALL_REDUCE["sync_s"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    dist.all_reduce(x, group=mesh.tp_group)
    ALL_REDUCE["host_s"] += time.perf_counter() - t0
    ALL_REDUCE["calls"] += 1
    return x


def rank_devices(nprocs: int, device: str) -> list[str]:
    """Each rank's device: ``cpu``; ``cuda`` for one card a rank
    (``cuda:<rank>``); ``cuda:<i>`` for every rank on card i."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return [f"cuda:{r}" for r in range(nprocs)]
    return [str(dev)] * nprocs


def check_backend(backend: str, devices: list[str]) -> None:
    """Refuse, before any process starts, what the backend cannot do."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: expected 'gloo' or 'nccl'")
    if backend == "nccl":
        if any(not d.startswith("cuda") for d in devices):
            raise ValueError(f"nccl needs CUDA devices, got {devices}")
        if len(set(devices)) != len(devices):
            raise ValueError(
                f"nccl cannot put two ranks on one device ({devices}): it "
                "needs one card a rank; run ranks that share a card over "
                "gloo")


def _rank_main(rank: int, fn, nprocs: int, backend: str, devices: list[str],
               tmp: str, timeout_s: float, args: tuple) -> None:
    import torch.distributed as dist

    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # the ranks share the host's cores (more threads a rank oversubscribe
    # them, and gloo's waits spin)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    store = dist.FileStore(os.path.join(tmp, "store"), nprocs)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=nprocs,
                            timeout=timedelta(seconds=timeout_s))
    try:
        out = fn(dev, *args)
        path = os.path.join(tmp, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


def launch(fn, nprocs: int, *, backend: str, device: str,
           timeout_s: float = DEFAULT_TIMEOUT_S, args: tuple = ()) -> list:
    """Run ``fn(device, *args)`` on ``nprocs`` ranks of a fresh process
    group and return their results in rank order. ``fn`` and ``args``
    must pickle (``fn`` a module-level function whose module imports no
    JAX). Each rank takes its share of the host's cores as torch threads.
    Every group times out after ``timeout_s``; a rank that raises (or
    dies) stops the others and raises here with its traceback."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    devices = rank_devices(nprocs, device)
    check_backend(backend, devices)
    with tempfile.TemporaryDirectory(prefix="q3tts_ranks_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, nprocs, backend, devices, tmp, timeout_s,
                              tuple(args)),
            nprocs=nprocs, join=False, start_method="spawn")
        try:
            while not ctx.join():
                pass
        except ProcessException as e:
            # the first rank to fail may be one whose peer failed first:
            # report every rank that raised, in rank order
            raised = []
            for rank, path in enumerate(ctx.error_files):
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        raised.append(f"rank {rank} raised:\n{pickle.load(f)}")
            raise RuntimeError("\n".join(raised) or str(e)) from e
        results = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
