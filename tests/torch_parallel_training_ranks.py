"""Rank functions of tests/test_torch_parallel_training.py. Spawned ranks
import this module (``parallel.comm.launch`` pickles the function by
name), so it imports torch, numpy and the port only: nothing of JAX.

``run_cases`` runs every case of one launch in order on every rank; each
case builds its own mesh (``replicas`` copies of a smaller plan fill the
world) and rank 0 returns its whole (gathered) results."""

import copy

import numpy as np
import torch
import torch.distributed as dist

from qwen3_tts_tpu_torch.engine.weights import tree_to
from qwen3_tts_tpu_torch.models.layers import rope_tables, transformer_block
from qwen3_tts_tpu_torch.ops.linear import linear
from qwen3_tts_tpu_torch.parallel import comm
from qwen3_tts_tpu_torch.parallel.mesh import MeshPlan, build_mesh
from qwen3_tts_tpu_torch.parallel.pipeline import talker_stack_fn
from qwen3_tts_tpu_torch.parallel.sharding import (
    gather_params,
    shard_for_training,
    shard_params,
    talker_param_spec,
    training_specs,
)
from qwen3_tts_tpu_torch.training import (
    add_lora,
    default_optimizer,
    init_lora_train_state,
    init_train_state,
    make_lora_train_step,
    make_train_step,
    split_lora,
)
from qwen3_tts_tpu_torch.training.checkpoint import (
    restore_train_state,
    save_train_state,
)
from qwen3_tts_tpu_torch.training.data import dp_rows
from qwen3_tts_tpu_torch.training.loss import joint_loss
from qwen3_tts_tpu_torch.training.train import (
    GradSync,
    device_batch,
    global_metrics,
    tree_leaves,
)


def _mesh(plan: tuple, device):
    pp, dp, tp = plan
    p = MeshPlan(dp=dp, tp=tp, pp=pp)
    return build_mesh(p, device, replicas=dist.get_world_size() // p.n_devices)


def _trees(case: dict, device, key: str = "trees"):
    """Tensor copies of the case's numpy trees on ``device`` (the optimizer
    updates leaves in place; tree_to would share numpy memory)."""
    return tree_to(copy.deepcopy(case[key]), device)


def _numpy(tree):
    if tree is None:
        return None
    # a copy: a replicated leaf gathers to the live (updated) tensor
    return {k: v.detach().float().cpu().numpy().copy()
            for k, v in tree_leaves(tree)}


def _whole(state, mesh) -> dict | None:
    specs = training_specs(state.params, state.cp_params, mesh)
    p = gather_params(state.params, mesh, specs[0])
    cp = gather_params(state.cp_params, mesh, specs[1])
    return None if p is None else {"params": _numpy(p), "cp": _numpy(cp)}


def _floats(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


def step_case(case: dict, device) -> dict:
    """``steps`` train steps on ``case["batches"]`` over the case's mesh:
    each step's metrics and the whole updated trees after each."""
    mesh = _mesh(case["plan"], device)
    cfg = case["cfg"]
    p, cp = shard_for_training(cfg, *_trees(case, "cpu"), mesh)
    opt = default_optimizer(lr=case.get("lr", 1e-4))
    state = init_train_state(p, cp, opt, mesh=mesh)
    # the anchor and teacher trees: this rank's slices, placed as the state's
    terms = {k: shard_for_training(cfg, *_trees(case, "cpu", k), mesh)
             if k in ("anchor", "distill") else case[k]
             for k in ("anchor", "anchor_weight", "distill",
                       "distill_weight") if k in case}
    step = make_train_step(cfg, opt, mesh=mesh, remat=case.get("remat", True),
                           microbatches=case.get("microbatches", 0),
                           sequence_parallel=case.get("sp", False), **terms)
    out = {"metrics": [], "trees": []}
    for batch in case["batches"]:
        state, m = step(state, batch)
        out["metrics"].append(_floats(m))
        out["trees"].append(_whole(state, mesh))
    return out


def grads_case(case: dict, device) -> dict:
    """The loss and the whole, summed grads of one backward pass over the
    case's mesh (the train step's, without the update)."""
    mesh = _mesh(case["plan"], device)
    cfg = case["cfg"]
    p, cp = shard_for_training(cfg, *_trees(case, "cpu"), mesh)
    state = init_train_state(p, cp, default_optimizer(), mesh=mesh)
    stack = talker_stack_fn(cfg, mesh=mesh, microbatches=case["microbatches"],
                            sequence_parallel=case.get("sp", False)) \
        if mesh.plan.pp > 1 else None
    batch = device_batch(dp_rows(case["batches"][0], mesh), "cpu")
    loss, m = joint_loss(p, cp, cfg, batch, stack_fn=stack, mesh=mesh,
                         sequence_parallel=case.get("sp", False))
    if loss is not None:
        loss.backward()
    if stack is not None:
        stack.backward()
    leaves = [x for g in state.opt_state.param_groups for x in g["params"]]
    for x in leaves:
        if x.grad is None:
            x.grad = torch.zeros_like(x)
    norm = GradSync.of([(True, p), (False, cp)], mesh,
                       case.get("sp", False))([x.grad for x in leaves])
    grads = {"params": gather_params(
        _grad_tree(p), mesh, talker_param_spec(p, pp=mesh.plan.pp > 1)),
        "cp": gather_params(_grad_tree(cp), mesh,
                            training_specs(p, cp, mesh)[1])}
    metrics = _floats(global_metrics({k: v.detach() for k, v in m.items()},
                                     mesh, "cpu"))
    return {"metrics": metrics, "grad_norm": float(norm),
            "grads": {k: _numpy(v) for k, v in grads.items()}}


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    return tree.grad if tree.grad is not None else torch.zeros_like(tree)


def lora_case(case: dict, device) -> dict:
    """Two LoRA steps on a dp x tp base: adapters drawn on the whole tree,
    then cut with their linears."""
    mesh = _mesh(case["plan"], device)
    cfg = case["cfg"]
    p, cp = _trees(case, "cpu")
    lora, base = split_lora(add_lora(p, rank=case["rank"], seed=1))
    spec = talker_param_spec(lora)
    lora = shard_params(lora, mesh, spec)
    base = shard_params(base, mesh)
    cp = shard_params(cp, mesh, training_specs(p, cp, mesh)[1])
    opt = default_optimizer(lr=case["lr"])
    state = init_lora_train_state(lora, opt, mesh=mesh)
    step = make_lora_train_step(cfg, opt, mesh=mesh)
    metrics = []
    for batch in case["batches"]:
        state, m = step(state, base, cp, batch)
        metrics.append(_floats(m))
    return {"metrics": metrics,
            "lora": _numpy(gather_params(state.lora, mesh, spec))}


def ckpt_case(case: dict, device) -> dict:
    """One step, a save, the next step (uninterrupted), then a restore into
    fresh trees of other values on the same mesh and the same next step."""
    mesh = _mesh(case["plan"], device)
    cfg = case["cfg"]
    opt = default_optimizer()

    def fresh(scale: float):
        p, cp = _trees(case, "cpu")
        with torch.no_grad():
            for _, x in tree_leaves([p, cp]):
                x.mul_(scale)
        p, cp = shard_for_training(cfg, p, cp, mesh)
        return init_train_state(p, cp, opt, mesh=mesh)

    step = make_train_step(cfg, opt, mesh=mesh,
                           microbatches=case["microbatches"])
    state = fresh(1.0)
    state, _ = step(state, case["batches"][0])
    path = save_train_state(state, case["dir"])
    _, m_cont = step(state, case["batches"][1])
    restored = restore_train_state(path, fresh(0.5))
    restored_step = restored.step
    _, m_res = step(restored, case["batches"][1])
    return {"path": path, "loss_cont": float(m_cont["loss"]),
            "loss_res": float(m_res["loss"]), "step": restored_step}


def _block_grads(block: dict, x: torch.Tensor, t, mesh=None,
                 sp: bool = False):
    """(grad of x, grad tree of ``block``) of a weighted sum of one
    transformer block's output, on ``mesh``'s tp shard of the block."""
    bp = _requires(block)
    xi = x.clone().requires_grad_()
    tp = 1 if mesh is None else mesh.tp
    xs = comm.enter_seq(xi, mesh) if sp else xi
    S = xs.shape[1] * (tp if sp else 1)
    cos, sin = rope_tables(S, t.head_dim, t.rope_theta)
    ck = torch.zeros((x.shape[0], S, t.n_kv_heads // tp, t.head_dim))
    y = transformer_block(bp, xs, cos=cos, sin=sin, cache_k=ck,
                          cache_v=ck.clone(), pos=0, n_heads=t.n_heads // tp,
                          n_kv_heads=t.n_kv_heads // tp, head_dim=t.head_dim,
                          rms_eps=t.rms_eps, mesh=mesh, sp=sp)
    if sp:
        y = comm.exit_seq(y, mesh, x.shape[1])
    weights = torch.tensor(np.random.default_rng(4).normal(
        size=tuple(y.shape)).astype(np.float32))
    (y * weights).sum().backward()
    return xi.grad, _grad_tree(bp)


def transposes_case(case: dict, device) -> dict:
    """tp = 2 against one rank, each rank computing both: the grads of a
    column- then row-parallel linear pair, and of a transformer block (its
    input, every leaf, q_norm included) without and with sequence
    parallelism (T = 7: padded to 8). Partial grads of replicated leaves
    are summed over tp as the train step sums them."""
    from qwen3_tts_tpu_torch.parallel.sharding import tp_partial

    mesh = _mesh((1, 1, 2), device)
    t = case["cfg"].talker
    p = tree_to(copy.deepcopy(case["trees"][0]), "cpu")
    block = _layer(p["blocks"], 0)
    x = torch.tensor(np.random.default_rng(0).normal(
        size=(2, 7, t.hidden)).astype(np.float32))
    gx, g = _block_grads(block, x, t)
    out = {"whole": {"x": gx.numpy(), "block": _numpy(g)}}
    spec = talker_param_spec({"blocks": _stack(block)})["blocks"]
    for name, sp in (("block", False), ("block_sp", True)):
        local = _layer(shard_params(_stack(block), mesh, spec), 0)
        gx, g = _block_grads(local, x, t, mesh, sp)
        g = _stack(g)
        for path, leaf in tree_leaves(g):
            if tp_partial(("blocks", *path.split("/")), sp):
                comm.sum_(leaf, mesh.tp_group, mesh, "grad_sum")
        whole = gather_params(g, mesh, spec)     # every rank calls it
        out[name] = {"x": gx.numpy(), "block": None if whole is None
                     else _numpy(_layer(whole, 0))}
    # a column- then row-parallel linear pair alone
    rng = np.random.default_rng(1)
    w1, w2, xin = (torch.tensor(rng.normal(size=s), dtype=torch.float32)
                   for s in ((8, 6), (6, 8), (3, 6)))
    k = mesh.coord("tp")
    a = xin.clone().requires_grad_()
    w1l = w1[4 * k:4 * k + 4].clone().requires_grad_()
    w2l = w2[:, 4 * k:4 * k + 4].clone().requires_grad_()
    h = linear(comm.copy_to_tp(a, mesh), {"w": w1l})
    linear(h, {"w": w2l}, mesh).square().sum().backward()
    a0 = xin.clone().requires_grad_()
    w10, w20 = w1.clone().requires_grad_(), w2.clone().requires_grad_()
    linear(linear(a0, {"w": w10}), {"w": w20}).square().sum().backward()
    out["linear"] = {"x": a.grad.numpy(), "x_whole": a0.grad.numpy(),
                     "w1": w1l.grad.numpy(),
                     "w1_whole": w10.grad[4 * k:4 * k + 4].numpy(),
                     "w2": w2l.grad.numpy(),
                     "w2_whole": w20.grad[:, 4 * k:4 * k + 4].numpy()}
    return out


def _requires(v):
    if isinstance(v, dict):
        return {k: _requires(x) for k, x in v.items()}
    return v.detach().clone().requires_grad_()


def _layer(blocks, i: int):
    if isinstance(blocks, dict):
        return {k: _layer(v, i) for k, v in blocks.items()}
    return blocks[i]


def _stack(block):
    if isinstance(block, dict):
        return {k: _stack(v) for k, v in block.items()}
    return block.detach()[None]


def finetune_case(case: dict, device) -> dict:
    """finetune.main(argv) on every rank: its exit code, and rank 0's
    stdout (the summary line)."""
    import contextlib
    import io

    from qwen3_tts_tpu_torch import finetune

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = finetune.main(case["argv"])
    return {"rc": rc, "stdout": out.getvalue()}


CASES = {"step": step_case, "grads": grads_case, "lora": lora_case,
         "ckpt": ckpt_case, "transposes": transposes_case,
         "finetune": finetune_case}


def run_cases(device, cases: dict) -> dict:
    """Every case in order (every rank runs every case); rank 0's results,
    with the seconds each took."""
    import time

    out = {}
    for name, case in cases.items():
        t0 = time.perf_counter()
        out[name] = CASES[case["kind"]](case, device)
        out[name]["seconds"] = time.perf_counter() - t0
    return out if dist.get_rank() == 0 else {}
