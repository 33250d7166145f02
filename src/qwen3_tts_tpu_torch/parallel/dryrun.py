"""Multi-rank dry run: the JAX package's
``__graft_entry__.py::dryrun_multichip``.

Training: one step of the tiny config (dense, in its own dtype) over every
parallel axis the ranks allow, the JAX geometry: pp = 2 when the ranks
are even and at least 4, then ``auto_plan`` of the rest (tp up to the
kv-head count, dp the remainder), sequence parallelism on whenever tp >
1, ``2 * pp`` microbatches, a batch of max(2 dp, 2 microbatches), 8 text
tokens and 6 frames, seed 0. Its loss and grad norm are printed, as JAX
prints them (8 ranks: the MULTICHIP record's ``mesh=(pp=2, dp=2, tp=2)``).

Decode: the tiny config, widened so that both the talker (kv heads) and
the code predictor (heads) split ``tp`` ways (tp 4 from 4 ranks, else 2),
at float32 (greedy codes compared exactly): one single-stream
``synthesize`` and one 8-slot ``ServingEngine.run`` over a tp-sharded
model must give the codes of the same model unsharded. Ranks beyond tp
form further replicas of the tp mesh. Every rank checks its own result
against its own unsharded run, and the ranks' codes must be equal.

    # ranks on this host's CPU over gloo
    python -m qwen3_tts_tpu_torch.parallel.dryrun --nprocs 4 --backend gloo --device cpu
    # one rank a card (a host with N cards; the group from torchrun's env)
    torchrun --nproc-per-node N -m qwen3_tts_tpu_torch.parallel.dryrun --backend nccl

The last line is the JAX ``dryrun_multichip ok: ...`` line, then the
backend and device.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from datetime import timedelta

import numpy as np

from .mesh import DEFAULT_TIMEOUT_S

FRAMES = 4
SLOTS = 8


def dryrun_config(tp: int):
    """configs.tiny("custom") at float32 with n_kv_heads = tp and the code
    predictor's n_heads = tp."""
    from ..engine import configs
    from .mesh import cp_tp_shardable

    cfg = configs.tiny("custom")
    cfg = dataclasses.replace(
        cfg, dtype="float32",
        talker=dataclasses.replace(cfg.talker, n_kv_heads=tp),
        code_predictor=dataclasses.replace(cfg.code_predictor, n_heads=tp))
    if tp > 1 and not cp_tp_shardable(cfg, tp):
        raise AssertionError(
            "dryrun geometry must exercise the tp-sharded code predictor")
    return cfg


def dryrun_prompts(n: int) -> list:
    from ..runtime.prompts import PromptSpec

    return [PromptSpec(text_tokens=(np.arange(6) * (i + 2) % 50).astype(
        np.int32), speaker_id=i % 4) for i in range(n)]


def decode_codes(model) -> tuple[np.ndarray, list[np.ndarray]]:
    """(single-stream codes [Q, frames], each of the 8 slots' codes)."""
    from ..runtime.serving import ServingEngine

    r = model.generator.synthesize(dryrun_prompts(1)[0], max_frames=FRAMES,
                                   seed=0, collect_codes=True)
    engine = ServingEngine(model, max_streams=SLOTS, chunk=4,
                           sampling=model.sampling)
    served = engine.run(dryrun_prompts(SLOTS), max_frames=FRAMES)
    return r.codes, [np.concatenate(s.codes, axis=1) for _, s in served]


def train_plan(n: int, cfg):
    """(the mesh plan, microbatches, batch size) of the JAX dry run's
    train step on ``n`` ranks."""
    from .mesh import MeshPlan, auto_plan

    pp = 2 if n % 2 == 0 and cfg.talker.n_layers % 2 == 0 and n >= 4 else 1
    inner = auto_plan(n // pp, tp_divisors=cfg.talker.n_kv_heads)
    plan = MeshPlan(dp=inner.dp, tp=inner.tp, pp=pp)
    microbatches = 2 * pp if pp > 1 else 0
    return plan, microbatches, max(2 * plan.dp, 2 * microbatches)


def decode_tp(n: int) -> int:
    """JAX decodes at tp 4 from 4 devices, else 2; here tp divides n (the
    other ranks hold replicas)."""
    return 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)


def train_step(device, n: int) -> dict:
    """The JAX dry run's train step on this rank: configs.tiny (dense,
    bfloat16) from seed 0, one step; its global loss and grad norm."""
    from ..engine import configs
    from ..models.code_predictor import init_code_predictor
    from ..models.talker import init_talker
    from ..training import default_optimizer, init_train_state, make_train_step
    from ..training.train import synthetic_batch
    from .mesh import build_mesh
    from .sharding import shard_for_training

    cfg = configs.tiny("custom", quant=False)
    plan, microbatches, batch = train_plan(n, cfg)
    mesh = build_mesh(plan, device)
    # the JAX initialisers' draws (Qwen3TTSModel.synthetic's seeds)
    p, cp = shard_for_training(cfg, init_talker(cfg, 0),
                               init_code_predictor(cfg, 1), mesh)
    opt = default_optimizer()
    state = init_train_state(p, cp, opt, mesh=mesh)
    step = make_train_step(cfg, opt, remat=True, mesh=mesh,
                           microbatches=microbatches,
                           sequence_parallel=plan.tp > 1)
    _, m = step(state, synthetic_batch(cfg, batch, 8, 6, seed=0))
    loss = float(m["loss"])
    if loss != loss or loss == float("inf"):
        raise AssertionError(f"non-finite loss: {loss}")
    return {"plan": (plan.pp, plan.dp, plan.tp), "loss": loss,
            "grad_norm": float(m["grad_norm"])}


def rank_main(device, n: int) -> dict:
    """One rank of ``n``: the train step, then the unsharded and the
    tp-sharded model's codes, compared."""
    from ..engine.api import Qwen3TTSModel
    from ..runtime.sampling import SamplingConfig
    from .mesh import MeshPlan, build_mesh, cp_tp_shardable
    from .sharding import shard_model

    out = {"train": train_step(device, n)}
    tp = decode_tp(n)
    cfg = dryrun_config(tp)

    def model():
        m = Qwen3TTSModel.synthetic(cfg, seed=3, device=device)
        m.sampling = SamplingConfig(greedy=True)
        return m

    ref_single, ref_served = decode_codes(model())
    sharded = shard_model(model(), build_mesh(MeshPlan(dp=1, tp=tp), device,
                                              replicas=n // tp))
    single, served = decode_codes(sharded)
    if not np.array_equal(single, ref_single):
        raise AssertionError("sharded single-stream codes diverged")
    for i, (a, b) in enumerate(zip(served, ref_served)):
        if not np.array_equal(a, b):
            raise AssertionError(f"sharded serving slot {i} codes diverged")
    return {**out, "single": single, "served": served, "tp": tp,
            "cp_sharded": cp_tp_shardable(cfg, tp)}


def ok_line(result: dict, backend: str, device: str) -> str:
    """The JAX dry run's line (its numbers to 4 places), then ours."""
    pp, dp, tp = result["train"]["plan"]
    dtp = result["tp"]
    return (f"dryrun_multichip ok: mesh=(pp={pp}, dp={dp}, tp={tp}), "
            f"sp={tp > 1}, loss={result['train']['loss']:.4f}, "
            f"grad_norm={result['train']['grad_norm']:.4f}, "
            f"decode_parity=ok(tp={dtp}, exact_codes, "
            f"cp_sharded={result['cp_sharded']}), "
            f"serve{SLOTS}_parity=ok(tp={dtp}), "
            f"backend={backend}, device={device}")


def _agree(results: list[dict]) -> None:
    first = results[0]
    for r in results[1:]:
        if not np.array_equal(r["single"], first["single"]) or any(
                not np.array_equal(a, b)
                for a, b in zip(r["served"], first["served"])):
            raise AssertionError("the ranks' codes differ")
        if r["train"] != first["train"]:
            raise AssertionError("the ranks' train metrics differ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nprocs", type=int, default=4,
                    help="ranks to start (ignored under torchrun)")
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda",
                    help="cpu; cuda (one card a rank); cuda:<i> (every "
                         "rank on card i, gloo only)")
    ap.add_argument("--timeout-s", type=float, default=DEFAULT_TIMEOUT_S)
    args = ap.parse_args(argv)

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun
        import torch
        import torch.distributed as dist

        from .comm import check_backend, rank_devices

        world = int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        devices = rank_devices(world, args.device)
        check_backend(args.backend, devices)
        device = torch.device(devices[local])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(args.backend,
                                timeout=timedelta(seconds=args.timeout_s))
        try:
            result = rank_main(device, world)
            gathered = [None] * world
            dist.all_gather_object(gathered, result)
            _agree(gathered)
            if dist.get_rank() == 0:
                print(ok_line(result, args.backend, args.device), flush=True)
        finally:
            dist.destroy_process_group()
        return 0

    from .comm import launch

    results = launch(rank_main, args.nprocs, backend=args.backend,
                     device=args.device, timeout_s=args.timeout_s,
                     args=(args.nprocs,))
    _agree(results)
    print(ok_line(results[0], args.backend, args.device), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
