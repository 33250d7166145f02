"""Pipeline parallelism for the talker's stacked-layer block stack: the
JAX package's ``parallel/pipeline.py``.

The talker's layers split over the ``pp`` mesh axis: each stage holds
L/pp of them (``sharding.training_specs``), and microbatch activations
move from stage to stage. Schedule: GPipe over ``M`` microbatches. With
``S = pp`` stages the forward runs ``n + S - 1`` ticks, where n is the
microbatches of this rank's dp rows; at tick t stage r runs microbatch
t - r (the others are bubble ticks, where the stage waits). Bubble
fraction ``(S-1)/(n+S-1)``: pick ``microbatches >= 4*pp`` for real runs.
dp and tp apply inside every stage, and sequence parallelism passes each
stage this rank's T slice.

JAX gets the backward pass from ``jax.grad`` through ``ppermute``. PyTorch
has no grad through a send, so the schedule is written out:

- forward ticks run each microbatch through the stage and hand its
  output to the next stage. With ``remat`` they run without autograd and
  stash only the stage's input; without, they keep the graph.
- the loss runs on the last stage alone, over the stack output of this
  rank's rows (``PipelineRun.output``; the other stages get None). JAX
  sums the output to every stage and runs the loss on each; here no stage
  computes what another has, so the grad of a leaf every stage holds
  (embeddings, text projection, ``ln_f``, head, code predictor) is each
  stage's share, summed over the pp line by the train step.
- ``PipelineRun.backward`` runs the backward ticks in reverse: each stage
  takes the grad of its output (the loss's on the last stage, the next
  stage's otherwise), recomputes its forward from the stashed input under
  ``remat``, calls ``torch.autograd.backward`` on it, and hands its input's
  grad to the stage before; stage 0 backpropagates it into the embeddings.

Transport: one broadcast inside the two-rank group of each adjacent stage
pair (``comm.shift``), on every backend (nccl refuses two ranks on one
card, and gloo sends no CUDA tensors but broadcasts them). Every stage
posts its hand-overs in microbatch order on each of its two groups, so no
two ranks wait on each other.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .comm import enter_seq, exit_seq, shift
from .mesh import PP_AXIS


class PipelineRun:
    """One call of ``pipeline_stack``: the forward ticks have run;
    ``output`` is the stack output of this rank's rows on the last stage
    (a leaf that collects the loss's grad), None on the others."""

    def __init__(self, mesh, body, blocks, x, n: int, args: Callable,
                 remat: bool, output, stash):
        self.mesh, self.body, self.blocks, self.x = mesh, body, blocks, x
        self.n, self.args, self.remat = n, args, remat
        self.output, self.stash = output, stash

    def backward(self) -> None:
        """The backward ticks: grads of every stage's leaves, and of the
        stack input's graph on stage 0. Every rank of the mesh calls it
        once, after the last stage's loss backward."""
        if self.stash is None:   # pp = 1: the loss's backward covered it
            return
        mesh, n = self.mesh, self.n
        S, r = mesh.plan.pp, mesh.coord(PP_AXIS)
        if mesh.last_stage:
            g = self.output.grad
            grads = (torch.zeros_like(self.output) if g is None
                     else g).split(self.output.shape[0] // n)
        like = self.x[:self.x.shape[0] // n].detach()
        dxs: list = [None] * n
        for t in range(n + S - 1):
            m = n - 1 - (t - (S - 1 - r))       # last stage starts
            if not 0 <= m < n:
                continue
            g = grads[m] if mesh.last_stage else shift(
                None, mesh.next_group, mesh.next_rank, like, mesh)
            if self.remat:
                inp = self.stash[m].requires_grad_()
                with torch.enable_grad():
                    y = self.body(self.blocks, inp, self.args(m))
            else:
                inp, y = self.stash[m]
            torch.autograd.backward(y, g)
            self.stash[m] = None
            if mesh.first_stage:
                dxs[m] = inp.grad
            else:
                shift(inp.grad, mesh.prev_group, mesh.rank, like, mesh)
        if mesh.first_stage and self.x.requires_grad:
            torch.autograd.backward(self.x, torch.cat(dxs))


def pipeline_stack(
    mesh,
    body: Callable[[Any, torch.Tensor, Any], torch.Tensor],
    blocks: Any,
    x: torch.Tensor,           # [b, T, D]: this rank's dp rows
    mb_args: Any,              # [b] tensor or a Python value
    *,
    microbatches: int,
    remat: bool = True,
) -> PipelineRun:
    """Run this stage's ``blocks`` (its [L/pp, ...] slice) as one stage of
    a pp-staged pipeline over ``x`` and return the run (see the module
    docstring). ``microbatches`` counts the global batch's microbatches
    (the JAX package's M): each holds B/M rows, B = b * dp, so each dp
    rank runs M/dp of them.

    ``body(blocks_local, x_mb, args_mb) -> y_mb`` runs the stage's layers
    on one microbatch (shape-preserving in x). At pp = 1 the body runs
    once on the whole batch, with autograd (no pipeline)."""
    S = mesh.plan.pp
    b = x.shape[0]
    B, M = b * mesh.plan.dp, microbatches
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    if S == 1:   # no pipeline: the stack runs directly
        return PipelineRun(mesh, body, blocks, x, 1, None, False,
                           body(blocks, x, mb_args), None)
    mb = B // M
    if b % mb:
        raise ValueError(f"microbatches {M} not divisible by dp="
                         f"{mesh.plan.dp} (each dp rank runs whole ones)")
    n = b // mb
    r = mesh.coord(PP_AXIS)

    def args(m: int):
        if isinstance(mb_args, torch.Tensor):
            return mb_args[m * mb:(m + 1) * mb]
        return mb_args

    grad = torch.is_grad_enabled()
    xs = x.detach().split(mb)
    like = xs[0]
    stash: list = [None] * n
    outs: list = [None] * n
    for t in range(n + S - 1):
        m = t - r
        if not 0 <= m < n:
            continue
        inp = xs[m] if mesh.first_stage else shift(
            None, mesh.prev_group, mesh.prev_rank, like, mesh)
        if remat or not grad:
            with torch.no_grad():
                y = body(blocks, inp, args(m))
            stash[m] = inp.detach() if grad else None
        else:
            inp = inp.detach().requires_grad_()
            y = body(blocks, inp, args(m))
            stash[m] = (inp, y)
        if mesh.last_stage:
            outs[m] = y.detach()
        else:
            shift(y.detach(), mesh.next_group, mesh.rank, like, mesh)
    output = None
    if mesh.last_stage:
        output = torch.cat(outs).requires_grad_(grad)
    return PipelineRun(mesh, body, blocks, x, n, args, remat, output, stash)


class TalkerStack:
    """The pipelined drop-in for the talker's full-sequence block stack
    (``training.loss.joint_loss(..., stack_fn=...)``):
    ``stack(blocks, x_emb, pad_len)`` returns the pre-``ln_f`` activations
    [b, T, D] on the last stage (None on the others), and ``backward()``,
    called once after the loss's backward on every rank, finishes the
    pass. Under ``sequence_parallel`` the stream enters the pipeline as
    this rank's T slice (``comm.enter_seq``) and leaves it whole.

    A step may run the stack more than once (the distillation's student
    pass beside the loss's): ``backward()`` runs every pass made with
    autograd, the last first; a pass under ``torch.no_grad()`` (the
    teacher's) gets no backward ticks."""

    def __init__(self, cfg, mesh, microbatches: int, remat: bool,
                 sequence_parallel: bool):
        L, S = cfg.talker.n_layers, mesh.plan.pp
        if L % S:
            raise ValueError(f"{L} stacked layers not divisible by pp={S}")
        self.cfg, self.mesh, self.microbatches = cfg, mesh, microbatches
        self.remat, self.sp = remat, sequence_parallel
        self.runs: list[PipelineRun] = []

    def __call__(self, blocks: Any, x_emb: torch.Tensor, pad_len):
        from ..models.layers import rope_tables, run_blocks

        t, mesh, sp = self.cfg.talker, self.mesh, self.sp
        T = x_emb.shape[1]
        x = enter_seq(x_emb, mesh) if sp else x_emb
        cos, sin = rope_tables(x.shape[1] * (mesh.tp if sp else 1),
                               t.head_dim, t.rope_theta, x.device)

        def body(blk, x_mb, pad_mb):
            return run_blocks(blk, x_mb, cos=cos, sin=sin, n_heads=t.n_heads,
                              n_kv_heads=t.n_kv_heads, head_dim=t.head_dim,
                              rms_eps=t.rms_eps, qk_norm=True, pad_len=pad_mb,
                              mesh=mesh, sp=sp)

        run = pipeline_stack(mesh, body, blocks, x, pad_len,
                             microbatches=self.microbatches, remat=self.remat)
        if torch.is_grad_enabled():
            self.runs.append(run)
        y = run.output
        if y is None:
            return None
        return exit_seq(y, mesh, T) if sp else y

    def backward(self) -> None:
        runs, self.runs = self.runs, []
        for run in reversed(runs):
            run.backward()


def talker_stack_fn(cfg, *, mesh, microbatches: int, remat: bool = True,
                    sequence_parallel: bool = False) -> TalkerStack:
    """A pipelined drop-in for the talker's full-sequence block stack over
    ``mesh``'s pp stages (the JAX package's ``talker_stack_fn``; its
    ``act_constraint`` is ``sequence_parallel`` here). Plug into
    ``training.loss.joint_loss(..., stack_fn=...)``."""
    return TalkerStack(cfg, mesh, microbatches, remat, sequence_parallel)
