"""Multi-rank dry run of tensor-parallel decode: the inference half of the
JAX package's ``__graft_entry__.py::dryrun_multichip``.

The tiny config, widened so that both the talker (kv heads) and the code
predictor (heads) split ``tp`` ways, at float32 (greedy codes compared
exactly): one single-stream ``synthesize`` and one 8-slot
``ServingEngine.run`` over a tp-sharded model must give the codes of the
same model unsharded. Every rank checks its own result against its own
unsharded run, and the ranks' codes must be equal.

    # ranks on this host's CPU over gloo
    python -m qwen3_tts_tpu_torch.parallel.dryrun --nprocs 4 --backend gloo --device cpu
    # one rank a card (a host with N cards; the group from torchrun's env)
    torchrun --nproc-per-node N -m qwen3_tts_tpu_torch.parallel.dryrun --backend nccl

The last line mirrors ``dryrun_multichip ok: ...`` without the train step
(ROADMAP item 15b).
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


def rank_main(device, tp: int) -> dict:
    """One rank: the unsharded and the tp-sharded model's codes, compared."""
    from ..engine.api import Qwen3TTSModel
    from ..runtime.sampling import SamplingConfig
    from .mesh import MeshPlan, build_mesh, cp_tp_shardable
    from .sharding import shard_model

    cfg = dryrun_config(tp)

    def model():
        m = Qwen3TTSModel.synthetic(cfg, seed=3, device=device)
        m.sampling = SamplingConfig(greedy=True)
        return m

    ref_single, ref_served = decode_codes(model())
    sharded = shard_model(model(), build_mesh(MeshPlan(dp=1, tp=tp), device))
    single, served = decode_codes(sharded)
    if not np.array_equal(single, ref_single):
        raise AssertionError("sharded single-stream codes diverged")
    for i, (a, b) in enumerate(zip(served, ref_served)):
        if not np.array_equal(a, b):
            raise AssertionError(f"sharded serving slot {i} codes diverged")
    return {"single": single, "served": served,
            "cp_sharded": cp_tp_shardable(cfg, tp)}


def ok_line(tp: int, backend: str, device: str, cp_sharded: bool) -> str:
    return (f"dryrun_multichip ok: mesh=(pp=1, dp=1, tp={tp}), "
            f"backend={backend}, device={device}, "
            f"decode_parity=ok(tp={tp}, exact_codes, "
            f"cp_sharded={cp_sharded}), serve{SLOTS}_parity=ok(tp={tp})")


def _agree(results: list[dict]) -> None:
    first = results[0]
    for r in results[1:]:
        if not np.array_equal(r["single"], first["single"]) or any(
                not np.array_equal(a, b)
                for a, b in zip(r["served"], first["served"])):
            raise AssertionError("the ranks' codes differ")


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
                print(ok_line(world, args.backend, args.device,
                              result["cp_sharded"]), flush=True)
        finally:
            dist.destroy_process_group()
        return 0

    from .comm import launch

    results = launch(rank_main, args.nprocs, backend=args.backend,
                     device=args.device, timeout_s=args.timeout_s,
                     args=(args.nprocs,))
    _agree(results)
    print(ok_line(args.nprocs, args.backend, args.device,
                  results[0]["cp_sharded"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
