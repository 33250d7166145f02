"""The collectives that XLA inserted in the JAX package, as autograd
functions, and the launcher of a group of ranks.

Tensor parallelism (Megatron's f and g):

- ``copy_to_tp``: identity forward, sum over tp backward. It sits where a
  tp-replicated activation enters the column-parallel linears (q/k/v,
  gate/up, and LoRA's ``lora_a`` on those): each rank's grad of it is a
  partial sum over its heads or ffn slice.
- ``reduce_from_tp``: sum over tp forward, identity backward, after the
  row-parallel o and down projections. Decode calls the same forward (one
  ``all_reduce``, in place); ``torch.distributed.nn``'s ``all_reduce`` would
  sum the grad in its backward too, the wrong transpose here.

Sequence parallelism, with the residual stream split along T over tp:

- ``gather_seq``: all-gather along T forward; backward a reduce-scatter
  (``sum_grad=True``: the consumer is tp-partitioned) or this rank's slice
  of the grad (``sum_grad=False``: the consumer runs whole on every rank).
- ``scatter_seq``: reduce-scatter along T forward, all-gather backward
  (after o and down).
- ``split_seq``: this rank's T slice forward, all-gather backward (a
  tp-replicated tensor entering the split stream).

The pipeline's shift (``shift``) is a broadcast inside a two-rank group of
adjacent stages; the grad sums of training and the dp sums of the loss
and its mask counts are ``sum_``. Every collective is an ``all_reduce``
or a ``broadcast``, the two that every backend runs on every device
(gloo takes CUDA tensors through host memory for these two alone): an
all-gather is a sum of zero-padded buffers (exact: each element is one
value plus zeros), a reduce-scatter a sum and a slice. ``STATS`` counts
each kind's calls and host seconds.

``launch`` starts one process a rank with the ``spawn`` start method and a
``FileStore`` in a fresh temporary directory (no TCP port to race for),
and returns each rank's result; a rank that raises fails the launch with
its traceback. Under ``torchrun`` the caller initialises the group from
its environment instead. The backend and the devices are the caller's,
never guessed: ``nccl`` needs one card a rank (it refuses two ranks on
one device), ``gloo`` takes CPU tensors, and CUDA tensors through host
memory. Nothing here switches either on its own.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from datetime import timedelta

import torch

from .mesh import DEFAULT_TIMEOUT_S, TP_AXIS

# per kind: calls since the last reset, their host seconds, and (gloo,
# CUDA tensors) the seconds first spent waiting for the card
KINDS = ("tp_sum", "sp_gather", "pp_shift", "grad_sum", "dp_sum")
STATS = {k: {"calls": 0, "host_s": 0.0, "sync_s": 0.0} for k in KINDS}


def reset_stats() -> None:
    for st in STATS.values():
        st.update(calls=0, host_s=0.0, sync_s=0.0)


def _timed(kind: str, x: torch.Tensor, mesh, op) -> None:
    st = STATS[kind]
    if x.is_cuda and mesh.backend == "gloo":
        # gloo stages a CUDA tensor through host memory, which waits for
        # the card's queued work anyway: wait first, so that host_s counts
        # the collective alone
        t0 = time.perf_counter()
        torch.cuda.synchronize(x.device)
        st["sync_s"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    op()
    st["host_s"] += time.perf_counter() - t0
    st["calls"] += 1


def sum_(x: torch.Tensor, group, mesh, kind: str) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place; returns ``x``."""
    import torch.distributed as dist

    _timed(kind, x, mesh, lambda: dist.all_reduce(x, group=group))
    return x


def _tp(mesh) -> bool:
    return mesh is not None and mesh.tp > 1


def _gather(x: torch.Tensor, dim: int, mesh, kind: str) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over the tp group (rank order)."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * mesh.tp
    buf = x.new_zeros(shape)
    buf.narrow(dim, mesh.coord(TP_AXIS) * n, n).copy_(x)
    return sum_(buf, mesh.tp_group, mesh, kind)


def _slice(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    n = x.shape[dim] // mesh.tp
    return x.narrow(dim, mesh.coord(TP_AXIS) * n, n).contiguous()


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_(g.contiguous().clone(), ctx.mesh.tp_group, ctx.mesh,
                    "tp_sum"), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return sum_(x.clone(), mesh.tp_group, mesh, "tp_sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, sum_grad):
        ctx.mesh, ctx.sum_grad = mesh, sum_grad
        return _gather(x.contiguous(), 1, mesh, "sp_gather")

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.sum_grad:
            g = sum_(g.clone(), ctx.mesh.tp_group, ctx.mesh, "sp_gather")
        return _slice(g, 1, ctx.mesh), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        summed = sum_(x.contiguous().clone(), mesh.tp_group, mesh, "sp_gather")
        return _slice(summed, 1, mesh)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), 1, ctx.mesh, "sp_gather"), None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _slice(x, 1, mesh)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), 1, ctx.mesh, "sp_gather"), None


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """Identity; under autograd its backward sums the grad over tp."""
    if not _tp(mesh) or not torch.is_grad_enabled():
        return x
    return _CopyToTP.apply(x, mesh)


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``x`` over the tp group of ``mesh`` (identity backward). Without
    autograd the sum is in place (decode); a no-op without a mesh or at
    tp = 1."""
    if not _tp(mesh):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromTP.apply(x, mesh)
    return sum_(x, mesh.tp_group, mesh, "tp_sum")


def gather_seq(x: torch.Tensor, mesh, sum_grad: bool = True) -> torch.Tensor:
    """[B, T/tp, ...] -> [B, T, ...] (all-gather over tp)."""
    return _GatherSeq.apply(x, mesh, sum_grad) if _tp(mesh) else x


def scatter_seq(x: torch.Tensor, mesh) -> torch.Tensor:
    """[B, T, ...] partial sums -> this rank's [B, T/tp, ...] of their sum."""
    return _ScatterSeq.apply(x, mesh) if _tp(mesh) else x


def split_seq(x: torch.Tensor, mesh) -> torch.Tensor:
    """[B, T, ...] (equal on every tp rank) -> this rank's [B, T/tp, ...]."""
    return _SplitSeq.apply(x, mesh) if _tp(mesh) else x


def enter_seq(x: torch.Tensor, mesh) -> torch.Tensor:
    """The residual stream [B, T, D] -> this rank's T slice, T padded at
    the end to a multiple of tp with zero rows. Causal attention keeps the
    padding out of every real position (its keys come after them), and
    ``exit_seq`` drops its rows."""
    pad = (-x.shape[1]) % mesh.tp
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    return split_seq(x, mesh)


def exit_seq(y: torch.Tensor, mesh, length: int) -> torch.Tensor:
    """This rank's T slice -> the whole [B, length, D] on every tp rank,
    for a consumer that runs whole on each of them."""
    return gather_seq(y, mesh, sum_grad=False)[:, :length]


def shift(x: torch.Tensor | None, group, src: int, like: torch.Tensor,
          mesh) -> torch.Tensor:
    """One pipeline hand-over inside the two-rank ``group``: the rank
    ``src`` (a global rank) sends ``x``; the other receives a tensor shaped
    and typed as ``like``."""
    import torch.distributed as dist

    buf = x.contiguous() if mesh.rank == src else torch.empty_like(like)
    _timed("pp_shift", buf, mesh,
           lambda: dist.broadcast(buf, src=src, group=group))
    return buf


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
