"""Rank functions of tests/test_torch_parallel.py. Spawned ranks import this
module (``parallel.comm.launch`` pickles the function by name), so it
imports torch, numpy and the port only: nothing of JAX."""

import numpy as np
import torch

from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
from qwen3_tts_tpu_torch.engine.tokenizer import ByteTokenizer
from qwen3_tts_tpu_torch.engine.weights import params_from_numpy
from qwen3_tts_tpu_torch.ops.linear import linear
from qwen3_tts_tpu_torch.parallel import MeshPlan, build_mesh, shard_model
from qwen3_tts_tpu_torch.runtime.prompts import PromptSpec
from qwen3_tts_tpu_torch.runtime.serving import ServingEngine


def port_model(cfg, trees, sampling) -> Qwen3TTSModel:
    """The port's model on the CPU over (talker, cp, codec) numpy trees."""
    params, cp_params, codec_params = params_from_numpy(*trees, device="cpu")
    return Qwen3TTSModel(cfg=cfg, params=params, cp_params=cp_params,
                         codec_params=codec_params, tokenizer=ByteTokenizer(),
                         device=torch.device("cpu"), sampling=sampling)


def decode(model, job: dict) -> dict:
    """A ``synth`` job: one synthesize (codes, wav, frames); a ``serve``
    job: ServingEngine.run over its prompts (codes, wavs, frames each)."""
    prompts = [PromptSpec(**kw) for kw in job["prompts"]]
    if job["kind"] == "synth":
        r = model.generator.synthesize(prompts[0], max_frames=job["frames"],
                                       seed=job.get("seed", 0),
                                       collect_codes=True)
        return {"codes": r.codes, "wav": r.wav, "frames": r.frames}
    engine = ServingEngine(model, max_streams=job["slots"],
                           chunk=job["chunk"], sampling=model.sampling)
    served = engine.run(prompts, max_frames=job["frames"])
    return {"codes": [np.concatenate(s.codes, axis=1) for _, s in served],
            "wavs": [w for w, _ in served],
            "frames": [s.frames for _, s in served]}


def in_sharded_linear_with_bias(mesh) -> dict:
    """An in-sharded linear with an additive ``b`` on this rank's slice of
    x and w: the tp sum, then ``b`` once, equals the whole product."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(3, 8)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(5, 8)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=5), dtype=torch.float32)
    k = 8 // mesh.tp
    cols = slice(mesh.coord("tp") * k, (mesh.coord("tp") + 1) * k)
    got = linear(x[:, cols], {"w": w[:, cols].contiguous(), "b": b}, mesh)
    return {"got": got.numpy(), "want": (x @ w.T + b).numpy()}


def run_jobs(device, tp: int, jobs: dict) -> dict:
    """Every job on this rank's tp shard (``jobs``: name -> job dict with
    cfg, trees, sampling), plus a ``build_mesh`` call with a plan of
    another size (its error message) and an in-sharded linear with a
    bias."""
    mesh = build_mesh(MeshPlan(dp=1, tp=tp), device)
    out = {"linear_b": in_sharded_linear_with_bias(mesh)}
    try:
        build_mesh(MeshPlan(dp=1, tp=2 * tp), device)
        out["bad_plan"] = None
    except ValueError as e:
        out["bad_plan"] = str(e)
    for name, job in jobs.items():
        model = port_model(job["cfg"], job["trees"], job["sampling"])
        out[name] = decode(shard_model(model, mesh), job)
    return out


def fail_on_rank_1(device) -> None:
    """Rank 1 raises while rank 0 waits in a tp sum."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(4))
