"""The port's tensor-parallel decode (``qwen3_tts_tpu_torch.parallel``)
against the JAX package's ``parallel/``: mesh plans, sharding specs and
slices on the suite's 8-device virtual CPU mesh; sharded decode on gloo
ranks started by ``parallel.comm.launch`` (their functions live in
``torch_parallel_ranks``, which imports no JAX), held against the JAX
unsharded engine on the same numpy trees; and the launcher's errors."""

import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from qwen3_tts_tpu.engine import configs as jcfgs
from qwen3_tts_tpu.engine.api import Qwen3TTSModel as JaxModel
from qwen3_tts_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from qwen3_tts_tpu.models.code_predictor import init_code_predictor
from qwen3_tts_tpu.models.codec import init_codec
from qwen3_tts_tpu.models.talker import init_talker
from qwen3_tts_tpu.parallel import mesh as jmesh
from qwen3_tts_tpu.parallel import sharding as jsharding
from qwen3_tts_tpu.runtime.prompts import PromptSpec as JaxPrompt
from qwen3_tts_tpu.runtime.sampling import SamplingConfig as JaxSampling
from qwen3_tts_tpu.runtime.serving import ServingEngine as JaxEngine
from qwen3_tts_tpu_torch.engine import configs as tcfgs
from qwen3_tts_tpu_torch.engine.weights import tree_to
from qwen3_tts_tpu_torch.parallel import comm, dryrun
from qwen3_tts_tpu_torch.parallel import mesh as tmesh
from qwen3_tts_tpu_torch.parallel import sharding as tsharding
from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig
from torch_port_helpers import assert_trees_equal

import torch_parallel_ranks as ranks

ROOT = Path(__file__).resolve().parent.parent
WAV_ATOL = 0.02 * 32767   # the JAX sharded-synthesis test's PCM tolerance
CONFIGS = ("tiny", "tiny_int8", "tiny_feedback", "flagship",
           "flagship_feedback")
PROMPTS = [dict(text_tokens=np.arange(5, dtype=np.int32), speaker_id=1),
           dict(text_tokens=(np.arange(7) * 3 % 50).astype(np.int32),
                speaker_id=2)]
FEEDBACK_PROMPTS = [
    dict(text_tokens=np.arange(6, dtype=np.int32) + 4, speaker_id=1),
    dict(text_tokens=(np.arange(9) * 3 % 50).astype(np.int32), speaker_id=0)]


def _config(module, name: str):
    if name == "tiny_int8":
        return module.tiny(quant=True)
    return getattr(module, name)()


def _f32(cfg, quant: bool):
    return dataclasses.replace(cfg, dtype="float32", quant=dataclasses.replace(
        cfg.quant, enabled=quant))


def _widened(cfg, tp: int):
    """The dryrun's geometry: n_kv_heads = tp, code predictor n_heads = tp."""
    return dataclasses.replace(
        cfg, talker=dataclasses.replace(cfg.talker, n_kv_heads=tp),
        code_predictor=dataclasses.replace(cfg.code_predictor, n_heads=tp))


# -- plans, specs and slices (no ranks) -------------------------------------

@pytest.mark.parametrize("div", [1, 2, 4, 8])
@pytest.mark.parametrize("n", range(1, 9))
def test_auto_plan_equals_jax(n, div):
    j = jmesh.auto_plan(n, tp_divisors=div)
    t = tmesh.auto_plan(n, tp_divisors=div)
    assert (t.pp, t.dp, t.tp) == (j.pp, j.dp, j.tp)


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("name", CONFIGS)
def test_validate_tp_and_cp_tp_shardable_equal_jax(name, tp):
    def outcome(module):
        try:
            module.validate_tp(_config(cfgs[module], name), tp)
            return None
        except ValueError as e:
            return str(e)

    cfgs = {jmesh: jcfgs, tmesh: tcfgs}
    assert outcome(tmesh) == outcome(jmesh)
    assert tmesh.cp_tp_shardable(_config(tcfgs, name), tp) == \
        jmesh.cp_tp_shardable(_config(jcfgs, name), tp)


@pytest.mark.parametrize("plan", [(1, 1, 1), (1, 2, 1), (2, 2, 1), (2, 1, 2),
                                  (2, 2, 2), (1, 8, 1), (4, 2, 1)])
def test_mesh_coordinates_follow_the_jax_axis_order(plan):
    """Rank r sits where device r sits in the JAX (pp, dp, tp) mesh."""
    dp, tp, pp = plan
    n = dp * tp * pp
    devices = jax.devices()[:n]
    jm = jmesh.build_mesh(jmesh.MeshPlan(dp=dp, tp=tp, pp=pp), devices)
    for r, d in enumerate(devices):
        where = tuple(int(i) for i in np.argwhere(jm.devices == d)[0])
        assert tmesh.mesh_coords(r, tmesh.MeshPlan(dp=dp, tp=tp, pp=pp)) \
            == where


def _spec_trees():
    q = jcfgs.tiny(quant=True)
    return {
        "talker_dense": lambda: init_talker(jcfgs.tiny(), 0),
        "talker_int8": lambda: init_talker(q, 0),
        "cp_int8": lambda: init_code_predictor(q, 1),
        "cp_feedback": lambda: init_code_predictor(jcfgs.tiny_feedback(), 1),
    }


def _split_dims(spec_tree) -> dict:
    """{path: (tp dim, pp dim)} of a JAX PartitionSpec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, P))
    out = {}
    for path, spec in flat:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        axes = tuple(spec)
        out[key] = tuple(axes.index(a) if a in axes else None
                         for a in ("tp", "pp"))
    return out


def _port_dims(spec_tree, prefix="") -> dict:
    if isinstance(spec_tree, dict):
        out = {}
        for k, v in spec_tree.items():
            out.update(_port_dims(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: (spec_tree.tp, spec_tree.pp)}


@pytest.mark.parametrize("pp", [False, True])
@pytest.mark.parametrize("tree", list(_spec_trees()))
def test_talker_param_spec_split_dims_equal_jax(tree, pp):
    np_tree = _spec_trees()[tree]()
    want = _split_dims(jsharding.talker_param_spec(np_tree, pp=pp))
    got = _port_dims(tsharding.talker_param_spec(np_tree, pp=pp))
    assert got == want
    assert any(d[0] is not None for d in got.values())


def test_mtp_heads_stay_replicated():
    """The one departure on a model tree: JAX's suffix rule splits the MTP
    block's mlp; the port keeps the MTP chain whole on every rank."""
    np_tree = init_talker(jcfgs.tiny_feedback(frames_per_step=2), 0)
    want = _split_dims(jsharding.talker_param_spec(np_tree))
    got = _port_dims(tsharding.talker_param_spec(np_tree))
    differ = sorted(k for k in want if got[k] != want[k])
    assert differ and all(k.startswith("mtp/mlp/") for k in differ), differ
    assert all(got[k] == (None, None) for k in differ)


@pytest.mark.parametrize("tree", ["talker_int8", "talker_dense", "cp_int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_slices_equal_jax_addressable_shards(tp, tree):
    """Each rank's slice is, bit for bit, the data JAX places on that
    device of a (dp=1, tp) mesh."""
    base = _widened(jcfgs.tiny(quant=tree != "talker_dense"), 4)
    np_tree = (init_code_predictor(base, 1) if tree.startswith("cp")
               else init_talker(base, 0))
    jm = jmesh.build_mesh(jmesh.MeshPlan(dp=1, tp=tp), jax.devices()[:tp])
    placed = jsharding.shard_params(
        np_tree, jm, jsharding.talker_param_spec(np_tree))
    full = tree_to(np_tree, "cpu")
    plan = tmesh.MeshPlan(dp=1, tp=tp)
    for rank in range(tp):
        device = jm.devices[0, 0, rank]
        want = jax.tree.map(
            lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                      if s.device == device)), placed)
        mesh = tmesh.Mesh(plan, rank, tmesh.mesh_coords(rank, plan),
                          torch.device("cpu"))
        assert_trees_equal(tsharding.shard_params(full, mesh), want)


def test_cache_sharding_gives_the_local_kv_shape():
    mesh = _mesh_record(2, 4, rank=5)
    assert tsharding.cache_sharding(mesh).local_shape((28, 8, 64, 8, 128)) \
        == (28, 4, 64, 2, 128)
    assert tsharding.activation_sharding(mesh).local_shape((8, 3, 16)) \
        == (4, 3, 16)
    with pytest.raises(ValueError, match="does not split"):
        tsharding.cache_sharding(mesh).local_shape((28, 8, 64, 2, 128))


def test_tp_all_reduce_is_a_no_op_without_a_tp_axis():
    """The tp sum (``comm.reduce_from_tp``) and its transposes."""
    x = torch.arange(4.0)
    calls = comm.STATS["tp_sum"]["calls"]
    for op in (comm.reduce_from_tp, comm.copy_to_tp, comm.gather_seq,
               comm.scatter_seq, comm.split_seq):
        assert op(x, None) is x
        assert op(x, tmesh.local_mesh()) is x
    assert comm.STATS["tp_sum"]["calls"] == calls
    assert torch.equal(x, torch.arange(4.0))


def _mesh_record(dp: int, tp: int, rank: int = 0):
    plan = tmesh.MeshPlan(dp=dp, tp=tp)
    return tmesh.Mesh(plan, rank, tmesh.mesh_coords(rank, plan),
                      torch.device("cpu"))


@pytest.mark.parametrize("case", ["indivisible", "lora", "dp_decode"])
def test_shard_model_and_generator_refuse_what_tp_decode_cannot_run(case):
    from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel

    model = Qwen3TTSModel.synthetic(tcfgs.tiny(), seed=0, device="cpu")
    if case == "indivisible":       # tiny has 2 kv heads
        with pytest.raises(ValueError, match="n_kv_heads=2 % tp=4"):
            tsharding.shard_model(model, _mesh_record(1, 4))
    elif case == "lora":
        q = model.params["blocks"]["attn"]["q"]
        q["lora_a"] = torch.zeros(q["w"].shape[0], 2, q["w"].shape[-1])
        with pytest.raises(ValueError, match="merge_lora"):
            tsharding.shard_model(model, _mesh_record(1, 2))
    else:
        tsharding.shard_model(model, _mesh_record(2, 2))
        with pytest.raises(ValueError, match="tp only"):
            model.generator


# -- launcher errors ---------------------------------------------------------

@pytest.mark.parametrize("device", ["cuda:0", "cpu"])
def test_nccl_refuses_ranks_it_cannot_place_before_any_process(device):
    with pytest.raises(ValueError, match="nccl"):
        comm.launch(ranks.fail_on_rank_1, 2, backend="nccl", device=device)


def test_a_failing_rank_fails_launch_with_its_traceback():
    t0 = time.perf_counter()
    with pytest.raises(Exception) as info:
        comm.launch(ranks.fail_on_rank_1, 2, backend="gloo", device="cpu",
                    timeout_s=60)
    text = str(info.value)
    assert "rank 1 fails on purpose" in text and "fail_on_rank_1" in text
    assert time.perf_counter() - t0 < 60


# -- sharded decode on gloo ranks against the JAX unsharded engine -----------

def _jax_trees(jc):
    return (init_talker(jc, 0), init_code_predictor(jc, 1), init_codec(jc, 2))


def _jax_model(jc, trees, sampling):
    return JaxModel(cfg=jc, params=trees[0], cp_params=trees[1],
                    codec_params=trees[2], tokenizer=JaxByteTokenizer(),
                    sampling=sampling)


def _jax_decode(jmodel, job: dict) -> dict:
    prompts = [JaxPrompt(**kw) for kw in job["prompts"]]
    if job["kind"] == "synth":
        r = jmodel.generator.synthesize(prompts[0], max_frames=job["frames"],
                                        seed=job.get("seed", 0),
                                        collect_codes=True)
        return {"codes": np.asarray(r.codes), "wav": np.asarray(r.wav),
                "frames": r.frames}
    engine = JaxEngine(jmodel, max_streams=job["slots"], chunk=job["chunk"],
                       sampling=jmodel.sampling)
    served = engine.run(prompts, max_frames=job["frames"])
    return {"codes": [np.concatenate(s.codes, axis=1) for _, s in served],
            "wavs": [np.asarray(w) for w, _ in served],
            "frames": [s.frames for _, s in served]}


# name -> (config builder from either configs module, int8 weights, job)
TP2_JOBS = {
    "synth_int8": (lambda m: m.tiny(), True,
                   dict(kind="synth", prompts=PROMPTS[:1], frames=10, seed=3)),
    "synth_dense": (lambda m: m.tiny(), False,
                    dict(kind="synth", prompts=PROMPTS[:1], frames=10,
                         seed=3)),
    "serve_cb0": (lambda m: m.tiny(), False,
                  dict(kind="serve", prompts=PROMPTS, frames=10, slots=2,
                       chunk=8)),
    "serve_feedback": (lambda m: m.tiny_feedback(), False,
                       dict(kind="serve", prompts=FEEDBACK_PROMPTS, frames=10,
                            slots=2, chunk=8)),
    # MTP at fps 2 (heads whole on every rank) with the grouped depth pass
    "serve_feedback_mtp_dg3": (
        lambda m: m.tiny_feedback(frames_per_step=2, depth_group=3), False,
        dict(kind="serve", prompts=FEEDBACK_PROMPTS, frames=10, slots=2,
             chunk=8)),
}
SAMPLED = dict(kind="synth", prompts=PROMPTS[:1], frames=12, seed=5)


@pytest.fixture(scope="module")
def tp2_jobs():
    """Per job: (numpy trees, port config, JAX config)."""
    out = {}
    for name, (build, quant, job) in TP2_JOBS.items():
        jc, tc = _f32(build(jcfgs), quant), _f32(build(tcfgs), quant)
        out[name] = (_jax_trees(jc), tc, jc, job)
    return out


@pytest.fixture(scope="module")
def tp2(tp2_jobs):
    """One launch of 2 gloo ranks running every job at tp = 2 (and a
    sampled synthesis), greedy unless sampled."""
    greedy = SamplingConfig(greedy=True)
    jobs = {name: {**job, "cfg": tc, "trees": trees, "sampling": greedy}
            for name, (trees, tc, _, job) in tp2_jobs.items()}
    trees, tc, _, _ = tp2_jobs["synth_dense"]
    jobs["sampled"] = {**SAMPLED, "cfg": tc, "trees": trees,
                       "sampling": SamplingConfig(temperature=0.9, top_k=8)}
    return comm.launch(ranks.run_jobs, 2, backend="gloo", device="cpu",
                       args=(2, jobs))


@pytest.mark.parametrize("name", ["synth_int8", "synth_dense"])
def test_tp2_synthesize_equals_the_jax_unsharded_engine(tp2, tp2_jobs, name):
    trees, _, jc, job = tp2_jobs[name]
    want = _jax_decode(_jax_model(jc, trees, JaxSampling(greedy=True)), job)
    for rank in tp2:
        got = rank[name]
        assert got["frames"] == want["frames"] > 0
        np.testing.assert_array_equal(got["codes"], want["codes"])
        np.testing.assert_allclose(got["wav"], want["wav"], atol=WAV_ATOL)


@pytest.mark.parametrize("name", ["serve_cb0", "serve_feedback",
                                  "serve_feedback_mtp_dg3"])
def test_tp2_serving_equals_the_jax_unsharded_engine(tp2, tp2_jobs, name):
    trees, _, jc, job = tp2_jobs[name]
    want = _jax_decode(_jax_model(jc, trees, JaxSampling(greedy=True)), job)
    for rank in tp2:
        got = rank[name]
        assert got["frames"] == want["frames"]
        for a, b in zip(got["codes"], want["codes"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got["wavs"], want["wavs"]):
            np.testing.assert_allclose(a, b, atol=WAV_ATOL)


def test_tp2_sampled_ranks_agree(tp2):
    a, b = (rank["sampled"] for rank in tp2)
    assert a["frames"] == b["frames"] > 0
    np.testing.assert_array_equal(a["codes"], b["codes"])
    np.testing.assert_array_equal(a["wav"], b["wav"])


def test_tp2_in_sharded_linear_adds_its_bias_once(tp2):
    for rank in tp2:
        np.testing.assert_allclose(rank["linear_b"]["got"],
                                   rank["linear_b"]["want"], atol=1e-5)


def test_build_mesh_refuses_a_plan_of_another_size(tp2):
    for rank in tp2:
        assert "needs 4 devices, have 2" in rank["bad_plan"]


@pytest.fixture(scope="module")
def tp4():
    """The dryrun's rank function on 4 gloo ranks (its train step at
    pp2 tp2, then decode): codes of the tp-sharded model (each rank
    already checked them against its own unsharded run)."""
    return comm.launch(dryrun.rank_main, 4, backend="gloo", device="cpu",
                       args=(4,))


@pytest.fixture(scope="module")
def tp4_jax():
    jc = _widened(_f32(jcfgs.tiny("custom"), False), 4)
    assert jmesh.cp_tp_shardable(jc, 4)
    jmodel = JaxModel.synthetic(jc, seed=3)
    jmodel.sampling = JaxSampling(greedy=True)
    prompts = [dict(text_tokens=p.text_tokens, speaker_id=p.speaker_id)
               for p in dryrun.dryrun_prompts(dryrun.SLOTS)]
    single = _jax_decode(jmodel, dict(kind="synth", prompts=prompts[:1],
                                      frames=dryrun.FRAMES, seed=0))
    served = _jax_decode(jmodel, dict(kind="serve", prompts=prompts,
                                      frames=dryrun.FRAMES, slots=dryrun.SLOTS,
                                      chunk=4))
    return single["codes"], served["codes"]


def test_tp4_dryrun_codes_equal_the_jax_unsharded_engine(tp4, tp4_jax):
    single, served = tp4_jax
    dryrun._agree(tp4)
    for rank in tp4:
        assert rank["cp_sharded"]
        np.testing.assert_array_equal(rank["single"], single)
        assert len(rank["served"]) == len(served) == dryrun.SLOTS
        for a, b in zip(rank["served"], served):
            np.testing.assert_array_equal(a, b)


def test_dryrun_cli_prints_its_ok_line():
    """Two ranks: the JAX dry run's line at (dp=1, tp=2) with sp and the
    train step's numbers (8 ranks: tests/test_torch_parallel_training.py)."""
    proc = subprocess.run(
        [sys.executable, "-m", "qwen3_tts_tpu_torch.parallel.dryrun",
         "--nprocs", "2", "--backend", "gloo", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-2000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith(
        "dryrun_multichip ok: mesh=(pp=1, dp=1, tp=2), sp=True, loss=")
    assert "cp_sharded=True" in last and "serve8_parity=ok(tp=2)" in last
