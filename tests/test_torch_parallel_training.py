"""The port's parallel training (``qwen3_tts_tpu_torch.parallel`` +
``training``) against the JAX package's on one numpy tree and batch.

The port's side runs on gloo ranks started by ``parallel.comm.launch``
(their functions live in ``torch_parallel_training_ranks``, which imports
no JAX): one launch of 8 CPU ranks runs every mesh case (smaller meshes as
replicas), one of 2 ranks runs ``finetune.main``. The JAX side runs
``make_train_step`` plainly and on the suite's 8-device virtual CPU mesh
(``make_train_step(mesh=…)``, whose pipeline is ``joint_loss(stack_fn=…)``),
once per reference, while the ranks run. Float32 tolerances: the same
arithmetic summed in another order (tp partial sums, microbatches, the
dp sum of the grads)."""

import dataclasses
import os
import subprocess
import sys
import tempfile
import wave
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from qwen3_tts_tpu.engine import configs as jcfgs
from qwen3_tts_tpu.models.code_predictor import init_code_predictor
from qwen3_tts_tpu.models.talker import init_talker
from qwen3_tts_tpu.parallel import MeshPlan as JaxMeshPlan
from qwen3_tts_tpu.parallel import build_mesh as jax_build_mesh
from qwen3_tts_tpu.parallel.sharding import replicated_spec as jax_replicated
from qwen3_tts_tpu.parallel.sharding import shard_params as jax_shard
from qwen3_tts_tpu.training import lora as jlora
from qwen3_tts_tpu.training import loss as jloss
from qwen3_tts_tpu.training import train as jtrain
from qwen3_tts_tpu_torch import finetune
from qwen3_tts_tpu_torch.engine import configs as tcfgs
from qwen3_tts_tpu_torch.engine.api import (
    Qwen3TTSModel,
    generate_audio,
    load_model,
)
from qwen3_tts_tpu_torch.engine.weights import save_model, tree_to
from qwen3_tts_tpu_torch.parallel import comm
from qwen3_tts_tpu_torch.parallel.mesh import Mesh, MeshPlan, local_mesh
from qwen3_tts_tpu_torch.parallel.pipeline import (
    pipeline_stack,
    talker_stack_fn,
)
from qwen3_tts_tpu_torch.training import (
    default_optimizer,
    init_train_state,
    make_train_step,
)
from qwen3_tts_tpu_torch.training.checkpoint import restore_train_state

import torch_parallel_training_ranks as ranks

ROOT = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5       # |port - jax| <= LOSS_RTOL * |jax|, each loss term
NORM_RTOL = 1e-4       # grad_norm
LEAF_TOL = 1e-4        # per leaf: max|port - jax| <= LEAF_TOL * max|jax|
# the dry run's tiny config trains in bfloat16, where JAX's
# optax.global_norm also sums the squares in bfloat16: its grad_norm moves
# by a few bf16 ulps with the geometry (2.4531 plain, 2.5000 on the
# pp2 dp2 tp2 mesh), the port's (a float32 sum) lies between
DRYRUN_LOSS_RTOL = 1e-3
DRYRUN_NORM_RTOL = 3e-2
LR = 1e-4
LORA_LR = 1e-2
# the anchor's and the distillation's weights: at these the penalty's grads
# move the grad norm from 3.10 to 5.3 and the KL's by 5% (tiny f32, one
# device), so a term whose grad entered the grad sums pp x or dp x, or not
# at all, misses NORM_RTOL by orders of magnitude
ANCHOR_W = 1e4
DISTILL_W = 10.0


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


CB0 = _f32(jcfgs.tiny("custom", quant=False))
# four layers: a four-stage pipeline (stages beyond two meet in pair groups
# of their own)
CB0_L4 = dataclasses.replace(CB0, talker=dataclasses.replace(
    CB0.talker, n_layers=4))
FEEDBACK = _f32(dataclasses.replace(
    jcfgs.tiny_feedback("custom"),
    quant=dataclasses.replace(jcfgs.tiny_feedback().quant, enabled=False)))


def _port_cfg(jc):
    """The port's config of the same fields."""
    base = (tcfgs.tiny_feedback("custom") if jc.talker.feedback ==
            "residual_sum" else tcfgs.tiny("custom"))
    return dataclasses.replace(
        base, dtype=jc.dtype,
        quant=dataclasses.replace(base.quant, enabled=False),
        talker=dataclasses.replace(base.talker, n_layers=jc.talker.n_layers))


def _batch(jc, seed: int, b: int = 8, t_text: int = 6, t_frames: int = 4):
    """synthetic_batch with ragged text (>= 4 real tokens) on two rows."""
    out = jtrain.synthetic_batch(jc, b, t_text, t_frames, seed=seed)
    out["text_mask"][1, 4:] = False
    out["text_mask"][6, 5:] = False
    return out


def _masked_halves(batch: dict) -> dict:
    """The dp halves' frame masks differ: rows 4..7 keep one frame, one
    row of them none, so a mean of the halves' means differs from the
    global masked mean."""
    out = {k: v.copy() for k, v in batch.items()}
    out["frame_mask"][4:, 1:] = False
    out["frame_mask"][7] = False
    return out


def _trees(jc, seeds=(0, 1)):
    return init_talker(jc, seeds[0]), init_code_predictor(jc, seeds[1])


def _frozen(jc) -> dict:
    """Anchor and teacher trees unlike the trained ones (other seeds), so
    the penalty and the KL are far from zero from the first step."""
    return {"anchor": _trees(jc, (5, 6)), "anchor_weight": ANCHOR_W,
            "distill": _trees(jc, (7, 8)), "distill_weight": DISTILL_W}


def _key(path) -> str:
    return "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                    for e in path)


def _flat(tree) -> dict:
    return {_key(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


# -- the JAX references ------------------------------------------------------

def _jax_steps(jc, trees, batches, mesh=None, sp=False, microbatches=0,
               frozen=None):
    """Each step's metrics and whole (talker, cp) trees after it;
    ``frozen``: the anchor and distillation terms (``_frozen``)."""
    opt = jtrain.default_optimizer(lr=LR)
    p, cp = _jnp(trees)
    put = (lambda b: _jnp(b))
    if mesh is not None:
        p = jax_shard(p, mesh)
        cp = jax_shard(cp, mesh, jax_replicated(cp))
        sh = NamedSharding(mesh, P("dp"))

        def put(b):
            return {k: jax.device_put(jnp.asarray(v), sh)
                    for k, v in b.items()}
    state = jtrain.init_train_state(p, cp, opt)
    terms = {} if frozen is None else {
        "anchor": _jnp(frozen["anchor"]),
        "anchor_weight": frozen["anchor_weight"],
        "distill": _jnp(frozen["distill"]),
        "distill_weight": frozen["distill_weight"]}
    step = jtrain.make_train_step(jc, opt, remat=mesh is not None, mesh=mesh,
                                  microbatches=microbatches,
                                  sequence_parallel=sp, **terms)
    out = {"metrics": [], "trees": []}
    for b in batches:
        state, m = step(state, put(b))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["trees"].append({"params": _flat(state.params),
                             "cp": _flat(state.cp_params)})
    return out


def _jax_grads(jc, trees, batch):
    def loss(p, cp):
        return jloss.joint_loss(p, cp, jc, batch)

    (total, metrics), grads = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(*_jnp(trees))
    import optax

    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grad_norm": float(optax.global_norm(grads)),
            "grads": {"params": _flat(grads[0]), "cp": _flat(grads[1])}}


def _jax_lora(jc, trees, batches):
    p, cp = _jnp(trees)
    lora, base = jlora.split_lora(jlora.add_lora(p, rank=2, seed=1))
    opt = jtrain.default_optimizer(lr=LORA_LR)
    state = jlora.init_lora_train_state(lora, opt)
    step = jlora.make_lora_train_step(jc, opt, remat=False)
    metrics = []
    for b in batches:
        state, m = step(state, base, cp, _jnp(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "lora": _flat(state.lora)}


def _jax_mesh(plan):
    pp, dp, tp = plan
    return jax_build_mesh(JaxMeshPlan(dp=dp, tp=tp, pp=pp),
                          jax.devices()[:pp * dp * tp])


# -- the port's launches -----------------------------------------------------

def _write_pairs(d: str) -> str:
    os.makedirs(d, exist_ok=True)
    sr = 24_000
    for i in range(4):
        t = np.arange(int((0.3 + 0.1 * i) * sr))
        pcm = (np.sin(2 * np.pi * (220 + 60 * i) * t / sr) * 9000).astype(
            np.int16)
        with wave.open(os.path.join(d, f"clip{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes(pcm.tobytes())
        with open(os.path.join(d, f"clip{i}.txt"), "w") as fh:
            fh.write(f"utterance number {i}\n")
    return d


def _one_kv_head_model(d: str) -> str:
    """A native export of the tiny model with one kv head: auto_plan then
    gives 2 ranks dp = 2 (tp must divide the kv heads)."""
    cfg = tcfgs.tiny("custom")
    cfg = dataclasses.replace(cfg, talker=dataclasses.replace(
        cfg.talker, n_kv_heads=1))
    save_model(Qwen3TTSModel.synthetic(cfg, seed=0, device="cpu"), d)
    return d


def _mesh_cases(tmp: str) -> dict:
    b1, b2 = _batch(CB0, 3), _batch(CB0, 9)
    fb = _batch(FEEDBACK, 5, t_text=8)
    cb0 = {"cfg": _port_cfg(CB0), "trees": _trees(CB0)}
    return {
        "pp_dp_tp": {"kind": "step", **cb0, "plan": (2, 2, 2),
                     "microbatches": 4, "batches": [b1, b2]},
        "pp_dp_tp_sp": {"kind": "step", **cb0, "plan": (2, 2, 2), "sp": True,
                        "microbatches": 4, "batches": [b1]},
        "pp_dp_tp_anchor": {"kind": "step", **cb0, **_frozen(CB0),
                            "plan": (2, 2, 2), "microbatches": 4,
                            "batches": [b1, b2]},
        "pp_dp_tp_sp_anchor": {"kind": "step", **cb0, **_frozen(CB0),
                               "plan": (2, 2, 2), "sp": True,
                               "microbatches": 4, "batches": [b1]},
        "grads_pp_dp_tp": {"kind": "grads", **cb0, "plan": (2, 2, 2),
                           "microbatches": 4, "batches": [b1]},
        "pp_only": {"kind": "step", **cb0, "plan": (2, 1, 1),
                    "microbatches": 2, "batches": [b1]},
        "pp4_tp2_sp": {"kind": "step", "cfg": _port_cfg(CB0_L4),
                       "trees": _trees(CB0_L4), "plan": (4, 1, 2),
                       "sp": True, "microbatches": 4,
                       "batches": [_batch(CB0_L4, 3)]},
        "sp_dp_tp": {"kind": "step", **cb0, "plan": (1, 2, 2), "sp": True,
                     "remat": False, "batches": [b1]},
        "dp_tp_cb0": {"kind": "step", **cb0, "plan": (1, 2, 2),
                      "batches": [b1]},
        "dp_tp_feedback": {"kind": "step", "cfg": _port_cfg(FEEDBACK),
                           "trees": _trees(FEEDBACK), "plan": (1, 2, 2),
                           "batches": [fb]},
        "dp_mask": {"kind": "grads", **cb0, "plan": (1, 2, 1),
                    "microbatches": 0, "batches": [_masked_halves(b1)]},
        "lora": {"kind": "lora", **cb0, "plan": (1, 2, 2), "rank": 2,
                 "lr": LORA_LR, "batches": [b1, b2]},
        "ckpt": {"kind": "ckpt", **cb0, "plan": (2, 2, 2), "microbatches": 4,
                 "batches": [b1, b2], "dir": os.path.join(tmp, "ckpt")},
        "transposes": {"kind": "transposes", **cb0},
    }


def _finetune_cases(tmp: str) -> dict:
    data = _write_pairs(os.path.join(tmp, "data"))
    one_kv = _one_kv_head_model(os.path.join(tmp, "one_kv"))

    def argv(model, name):
        return ["--model", model, "--data", data, "--batch-size", "4",
                "--steps", "2", "--lr", "1e-2", "--anchor", "0.1",
                "--distill", "0.1",
                "--ckpt-dir", os.path.join(tmp, f"ck_{name}"),
                "--export", os.path.join(tmp, f"export_{name}")]

    return {"tp2": {"kind": "finetune", "argv": argv("synthetic-tiny", "tp2")},
            "dp2": {"kind": "finetune", "argv": argv(one_kv, "dp2")}}


def _dryrun_cli() -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "qwen3_tts_tpu_torch.parallel.dryrun",
         "--nprocs", "8", "--backend", "gloo", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


@pytest.fixture(scope="module")
def runs():
    """The port's three launches (8 mesh ranks, 2 finetune ranks, the
    8-rank dry run CLI) in threads, while this process computes every JAX
    reference; then both."""
    with tempfile.TemporaryDirectory(prefix="q3tts_pt_") as tmp, \
            mock.patch.dict(os.environ, {"QWEN3_TTS_CPU": "1"}), \
            ThreadPoolExecutor(3) as pool:
        mesh_f = pool.submit(comm.launch, ranks.run_cases, 8, backend="gloo",
                             device="cpu", args=(_mesh_cases(tmp),),
                             timeout_s=240)
        ft_f = pool.submit(comm.launch, ranks.run_cases, 2, backend="gloo",
                           device="cpu", args=(_finetune_cases(tmp),),
                           timeout_s=240)
        dry_f = pool.submit(_dryrun_cli)
        b1, b2 = _batch(CB0, 3), _batch(CB0, 9)
        trees = _trees(CB0)
        jax_refs = {
            "plain": _jax_steps(CB0, trees, [b1, b2]),
            "anchored": _jax_steps(CB0, trees, [b1, b2],
                                   frozen=_frozen(CB0)),
            "mesh_sp": _jax_steps(CB0, trees, [b1], _jax_mesh((2, 2, 2)),
                                  sp=True, microbatches=4),
            "grads": _jax_grads(CB0, trees, b1),
            "mask": _jax_grads(CB0, trees, _masked_halves(b1)),
            "feedback": _jax_steps(FEEDBACK, _trees(FEEDBACK),
                                   [_batch(FEEDBACK, 5, t_text=8)]),
            "four_layers": _jax_steps(CB0_L4, _trees(CB0_L4),
                                      [_batch(CB0_L4, 3)]),
            "lora": _jax_lora(CB0, trees, [b1, b2]),
            "dryrun": _jax_dryrun(),
        }
        out = {"jax": jax_refs, "mesh": mesh_f.result()[0],
               "finetune": ft_f.result()[0], "dryrun": dry_f.result()}
        out["resumed_on_one_rank"] = _resume_on_one_rank(out["mesh"]["ckpt"],
                                                         b2)
        out["exports"] = {name: _decode_export(
            os.path.join(tmp, f"export_{name}")) for name in ("tp2", "dp2")}
        yield out


def _jax_dryrun() -> dict:
    """The JAX dry run's train step (__graft_entry__.dryrun_multichip) on
    the virtual mesh: tiny bf16, pp2 dp2 tp2 + sp, 4 microbatches."""
    from qwen3_tts_tpu.engine.api import Qwen3TTSModel as JaxModel

    cfg = jcfgs.tiny("custom", quant=False)
    model = JaxModel.synthetic(cfg, seed=0)
    batch = jtrain.synthetic_batch(cfg, 8, 8, 6, seed=0)
    mesh = _jax_mesh((2, 2, 2))
    opt = jtrain.default_optimizer()
    state = jtrain.init_train_state(
        jax_shard(model.params, mesh),
        jax_shard(model.cp_params, mesh, jax_replicated(model.cp_params)),
        opt)
    step = jtrain.make_train_step(cfg, opt, remat=True, mesh=mesh,
                                  microbatches=4, sequence_parallel=True)
    sh = NamedSharding(mesh, P("dp"))
    _, m = step(state, {k: jax.device_put(jnp.asarray(v), sh)
                        for k, v in batch.items()})
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def _resume_on_one_rank(ckpt: dict, batch: dict) -> float:
    """The pp2 dp2 tp2 checkpoint restored on one rank (whole trees of
    other values), then the next step's loss."""
    p, cp = tree_to(_copy(_trees(CB0)), "cpu")
    opt = default_optimizer()
    state = restore_train_state(ckpt["path"], init_train_state(p, cp, opt))
    assert state.step == 1
    _, m = make_train_step(_port_cfg(CB0), opt)(state, batch)
    return float(m["loss"])


def _copy(tree):
    if isinstance(tree, (dict, tuple, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {k: _copy(v) for k, v in items}
        return out if isinstance(tree, dict) else type(tree)(out.values())
    return np.array(tree) * 0.5


def _decode_export(path: str) -> dict:
    model = load_model(path, device="cpu")
    with tempfile.TemporaryDirectory() as out:
        m = generate_audio(model=model, text="a short line", voice="ryan",
                           output_path=out, max_frames=6)
        with wave.open(os.path.join(out, "audio_000.wav"), "rb") as w:
            n = w.getnframes()
    return {"frames": m["frames"], "samples": n, "hop": model.cfg.codec.hop,
            "kv_heads": model.cfg.talker.n_kv_heads}


# -- comparisons -------------------------------------------------------------

def _close_metrics(got: dict, want: dict, keys=("talker_loss", "cp_loss",
                                                "loss")) -> None:
    for k in keys:
        assert abs(got[k] - want[k]) <= LOSS_RTOL * abs(want[k]), \
            (k, got[k], want[k])
    if "grad_norm" in want:
        assert abs(got["grad_norm"] - want["grad_norm"]) <= \
            NORM_RTOL * want["grad_norm"], (got["grad_norm"],
                                            want["grad_norm"])


def _close_leaves(got: dict, want: dict) -> None:
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))[:5]
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        scale = float(np.abs(w).max())
        err = float(np.abs(got[k] - w).max())
        assert err <= LEAF_TOL * scale + 1e-12, (k, err, scale)


def _close_trees(got: dict, want: dict) -> None:
    for name in ("params", "cp"):
        _close_leaves(got[name], want[name])


# -- the cases, one per JAX test ---------------------------------------------

def test_pipelined_loss_and_grads_match_plain(runs):
    """pp2 dp2 tp2, 4 microbatches: the loss and every summed, gathered
    grad against JAX's plain value_and_grad."""
    got, want = runs["mesh"]["grads_pp_dp_tp"], runs["jax"]["grads"]
    _close_metrics({**got["metrics"], "grad_norm": got["grad_norm"]},
                   {**want["metrics"], "grad_norm": want["grad_norm"]})
    _close_trees(got["grads"], want["grads"])


@pytest.mark.parametrize("step", [0, 1])
def test_pp_train_step_matches_plain_step(runs, step):
    """pp2 dp2 tp2: two steps' metrics and updated trees against JAX's
    plain steps (the second from the first's updated state)."""
    got, want = runs["mesh"]["pp_dp_tp"], runs["jax"]["plain"]
    _close_metrics(got["metrics"][step], want["metrics"][step])
    _close_trees(got["trees"][step], want["trees"][step])


@pytest.mark.parametrize("case,step", [("pp_dp_tp_anchor", 0),
                                       ("pp_dp_tp_anchor", 1),
                                       ("pp_dp_tp_sp_anchor", 0)])
def test_anchor_and_distill_over_the_mesh_match_the_plain_step(runs, case,
                                                               step):
    """pp2 dp2 tp2, without and with sequence parallelism: the step with
    the anchor and distillation terms (frozen trees of other seeds: this
    rank's slices) against JAX's plain step with both. The loss terms,
    anchor_pen (the global mean of the whole trees), distill_kl (the
    teacher's pass through the pipeline too), the grad norm (each leaf
    gets the penalty's grad once across the grad sums) and the updated
    trees; the second step from the first's state."""
    got, want = runs["mesh"][case], runs["jax"]["anchored"]
    _close_metrics(got["metrics"][step], want["metrics"][step],
                   keys=("talker_loss", "cp_loss", "loss", "anchor_pen",
                         "distill_kl"))
    _close_trees(got["trees"][step], want["trees"][step])


def test_pp_only_mesh_without_dp_tp(runs):
    got, want = runs["mesh"]["pp_only"], runs["jax"]["plain"]
    _close_metrics(got["metrics"][0], want["metrics"][0])
    _close_trees(got["trees"][0], want["trees"][0])


def test_four_stage_pipeline_with_sequence_parallelism(runs):
    """pp 4 × tp 2 + SP on a four-layer talker: the middle stages receive
    from and send to stages of their own pair groups."""
    got, want = runs["mesh"]["pp4_tp2_sp"], runs["jax"]["four_layers"]
    _close_metrics(got["metrics"][0], want["metrics"][0])
    _close_trees(got["trees"][0], want["trees"][0])


@pytest.mark.parametrize("case,ref", [("sp_dp_tp", "plain"),
                                      ("pp_dp_tp_sp", "plain"),
                                      ("pp_dp_tp_sp", "mesh_sp")])
def test_sequence_parallel_step_matches_jax(runs, case, ref):
    """Sequence parallelism at dp2 tp2, and with the pipeline (pp2 dp2
    tp2), against the JAX plain step (metrics and updated trees) and the
    JAX mesh step of the same geometry. Against the mesh step the loss
    terms alone, as the JAX package's own test of SP with the pipeline
    holds: its grad_norm there, 3.1498, is not its plain step's 3.0813
    (which the port's equals). T = 6 text + speaker + bos + 3 frames = 11
    is padded to 12; the padding's grads are held in
    test_tp_transposes_equal_one_rank."""
    got, want = runs["mesh"][case], runs["jax"][ref]
    if ref == "mesh_sp":
        _close_metrics(got["metrics"][0], {
            k: v for k, v in want["metrics"][0].items() if k != "grad_norm"})
        return
    _close_metrics(got["metrics"][0], want["metrics"][0])
    _close_trees(got["trees"][0], want["trees"][0])


@pytest.mark.parametrize("case,ref", [("dp_tp_cb0", "plain"),
                                      ("dp_tp_feedback", "feedback")])
def test_train_step_sharded_dp_tp(runs, case, ref):
    """The dp2 tp2 step on the cb0 and the published feedback protocol."""
    got, want = runs["mesh"][case], runs["jax"][ref]
    _close_metrics(got["metrics"][0], want["metrics"][0])
    _close_trees(got["trees"][0], want["trees"][0])


def test_lora_step_on_sharded_base(runs):
    """Two LoRA steps on a dp2 tp2 base against JAX's on the whole tree."""
    got, want = runs["mesh"]["lora"], runs["jax"]["lora"]
    for g, w in zip(got["metrics"], want["metrics"]):
        _close_metrics(g, w)
    _close_leaves(got["lora"], want["lora"])
    assert np.any(got["lora"]["blocks/attn/q/lora_b"])


def test_dp_loss_is_the_global_masked_mean(runs):
    """dp2 on a batch whose halves mask different frame counts: the loss
    is JAX's global masked mean (and the grads its grads), which a mean of
    the halves' means is not."""
    got, want = runs["mesh"]["dp_mask"], runs["jax"]["mask"]
    _close_metrics({**got["metrics"], "grad_norm": got["grad_norm"]},
                   {**want["metrics"], "grad_norm": want["grad_norm"]})
    _close_trees(got["grads"], want["grads"])
    b = _masked_halves(_batch(CB0, 3))
    halves = [jloss.joint_loss(*_jnp(_trees(CB0)), CB0,
                               {k: v[h] for k, v in b.items()})[1]["loss"]
              for h in (slice(0, 4), slice(4, 8))]
    mean_of_means = float(np.mean([float(x) for x in halves]))
    assert abs(mean_of_means - want["metrics"]["loss"]) > \
        100 * LOSS_RTOL * want["metrics"]["loss"]


def test_pp_train_state_checkpoint_roundtrip(runs):
    """Saved under pp2 dp2 tp2 (gathered on rank 0), restored into trees
    of other values on the same mesh and on one rank: the next step's
    loss equals the uninterrupted run's."""
    got = runs["mesh"]["ckpt"]
    assert got["step"] == 1
    for loss in (got["loss_res"], runs["resumed_on_one_rank"]):
        assert abs(loss - got["loss_cont"]) <= 1e-5 * abs(got["loss_cont"])
    assert abs(got["loss_cont"] - runs["jax"]["plain"]["metrics"][1]["loss"]) \
        <= LOSS_RTOL * got["loss_cont"]


@pytest.mark.parametrize("name", ["linear", "block", "block_sp"])
def test_tp_transposes_equal_one_rank(runs, name):
    """tp = 2 against one rank: a column- then row-parallel linear pair
    (grads of x and both weights' slices), a transformer block (grads of
    x and of every leaf, q_norm and k_norm summed over tp), and the block
    under sequence parallelism with T = 7 padded to 8 (ln1/ln2 summed)."""
    got = runs["mesh"]["transposes"]
    if name == "linear":
        lin = got["linear"]
        for k in ("x", "w1", "w2"):
            np.testing.assert_allclose(lin[k], lin[f"{k}_whole"], rtol=1e-5,
                                       atol=1e-5)
        return
    whole = got["whole"]
    np.testing.assert_allclose(got[name]["x"], whole["x"], rtol=1e-5,
                               atol=1e-6)
    _close_leaves(got[name]["block"], whole["block"])
    assert np.abs(whole["block"]["attn/q_norm"]).max() > 0


def test_finetune_on_two_ranks_exports_a_model_that_decodes(runs):
    """finetune.main on 2 CPU ranks: tp 2 (the tiny model) and dp 2 (one
    kv head), 2 steps each; rank 0 prints the summary and exports; the
    exports load and decode."""
    for name, want_kv in (("tp2", 2), ("dp2", 1)):
        out = runs["finetune"][name]
        assert out["rc"] == 0
        mesh = "mesh pp=1 dp=1 tp=2" if name == "tp2" else \
            "mesh pp=1 dp=2 tp=1"
        assert mesh in out["stdout"], out["stdout"]
        summary = __import__("json").loads(out["stdout"].splitlines()[-1])
        assert np.isfinite(summary["final_loss"])
        dec = runs["exports"][name]
        assert dec["kv_heads"] == want_kv
        assert dec["frames"] >= 1
        assert dec["samples"] == dec["frames"] * dec["hop"]


def test_dryrun_cli_on_eight_ranks_prints_the_jax_line(runs):
    """``parallel.dryrun --nprocs 8``: the JAX dry run's full line; its
    loss and grad_norm agree with the JAX step at the same geometry (the
    tiny config in bf16: DRYRUN_*_RTOL). The JAX record, MULTICHIP_r05:
    ``mesh=(pp=2, dp=2, tp=2), sp=True, loss=7.6971, grad_norm=2.5000``."""
    proc = runs["dryrun"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith(
        "dryrun_multichip ok: mesh=(pp=2, dp=2, tp=2), sp=True, loss=")
    assert "decode_parity=ok(tp=4, exact_codes, cp_sharded=True)" in last
    assert "serve8_parity=ok(tp=4)" in last
    fields = dict(f.split("=", 1) for f in last.split(", ")
                  if f.startswith(("loss=", "grad_norm=")))
    want = runs["jax"]["dryrun"]
    assert abs(float(fields["loss"]) - want["loss"]) <= \
        DRYRUN_LOSS_RTOL * want["loss"]
    assert abs(float(fields["grad_norm"]) - want["grad_norm"]) <= \
        DRYRUN_NORM_RTOL * want["grad_norm"]


# -- errors (no ranks) -------------------------------------------------------

def _mesh_record(pp=1, dp=1, tp=1) -> Mesh:
    return Mesh(MeshPlan(dp=dp, tp=tp, pp=pp), 0, (0, 0, 0),
                torch.device("cpu"))


def test_errors_of_the_jax_step():
    cfg = _port_cfg(CB0)
    opt = default_optimizer()
    with pytest.raises(ValueError, match="sequence_parallel needs a mesh"):
        make_train_step(cfg, opt, sequence_parallel=True)
    with pytest.raises(ValueError, match="tp > 1"):
        make_train_step(cfg, opt, mesh=_mesh_record(dp=2),
                        sequence_parallel=True)
    with pytest.raises(ValueError, match="tp > 1"):
        make_train_step(cfg, opt, mesh=local_mesh(), sequence_parallel=True)
    # an indivisible batch, and indivisible layers
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_stack(_mesh_record(pp=2), lambda *a: None, {},
                       torch.zeros(8, 3, 4), 0, microbatches=3)
    odd = dataclasses.replace(cfg, talker=dataclasses.replace(
        cfg.talker, n_layers=3))
    with pytest.raises(ValueError, match="not divisible"):
        talker_stack_fn(odd, mesh=_mesh_record(pp=2), microbatches=2)
    # the anchor and distillation terms take a mesh, as the JAX step does
    assert callable(make_train_step(cfg, opt, mesh=_mesh_record(dp=2),
                                    anchor=({}, {}), anchor_weight=0.1,
                                    distill=({}, {}), distill_weight=0.1))


def test_finetune_needs_backend_under_torchrun(tmp_path, capsys):
    """WORLD_SIZE > 1 without an initialised group: --backend is required
    (no backend is guessed), before anything is built."""
    with mock.patch.dict(os.environ, {"WORLD_SIZE": "2", "RANK": "0",
                                      "QWEN3_TTS_CPU": "1"}):
        rc = finetune.main(["--model", "synthetic-tiny", "--data",
                            str(tmp_path), "--steps", "1"])
    assert rc == 1
    assert "--backend {nccl,gloo} is required" in capsys.readouterr().err
