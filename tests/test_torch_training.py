"""The port's training/ (loss, train step, checkpoint, data) against the
JAX package's, on tiny float32 trees made by the JAX initialisers and
carried across with params_from_numpy: joint_loss and its gradients under
every layout the loss covers, the distillation and anchor terms, three
optimizer steps against optax, and ports of the JAX package's training
tests (padding, checkpoint/resume, data pipeline, a learning step)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from qwen3_tts_tpu.engine import configs as jcfgs
from qwen3_tts_tpu.engine.api import Qwen3TTSModel as JaxModel
from qwen3_tts_tpu.models.code_predictor import init_code_predictor
from qwen3_tts_tpu.models.talker import init_talker
from qwen3_tts_tpu.training import loss as jloss
from qwen3_tts_tpu.training import train as jtrain
from qwen3_tts_tpu.training.data import batches_from_pairs as jax_batches
from qwen3_tts_tpu.training.data import pad_batch as jax_pad_batch
from qwen3_tts_tpu_torch.engine import configs as tcfgs
from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
from qwen3_tts_tpu_torch.engine.weights import tree_to
from qwen3_tts_tpu_torch.training import loss as tloss
from qwen3_tts_tpu_torch.training import train as ttrain
from qwen3_tts_tpu_torch.training.checkpoint import (
    latest_checkpoint,
    restore_train_state,
    save_train_state,
)
from qwen3_tts_tpu_torch.training.data import (
    Example,
    batches_from_pairs,
    encode_example,
    pad_batch,
)
from torch_port_helpers import one_torch_thread  # noqa: F401

# float32 tolerances: the same arithmetic summed in another order
LOSS_RTOL = 1e-5      # |port - jax| <= LOSS_RTOL * |jax|, each loss term
GRAD_TOL = 1e-5       # per leaf: max|port - jax| <= GRAD_TOL * max|jax|
# after each optimizer step, every parameter element within STEP_TOL * lr
# of optax's. Adam divides each component by its own RMS, so a component
# whose gradient is near zero can turn an ulp-level gradient difference
# into a visible share of one lr-sized step (measured: <= 0.073 lr after 3
# steps at lr 1e-2, already 0.072 lr after the first). A formula fault
# (decay, bias correction, moments) moves most elements: after the first
# step at least STEP1_SHARE of all elements lie within STEP1_ATOL.
STEP_TOL = 0.1
STEP1_ATOL = 1e-6
STEP1_SHARE = 0.999
LR = 1e-2
# metrics of steps 2-3, computed on those slightly different trees
STEP_METRIC_RTOL = 1e-3

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CASES = {
    # cb0 protocol: speakers on alternate rows, ragged left-padded text
    "cb0": lambda m: m.tiny(),
    # the published residual_sum protocol (hidden_token predictor)
    "feedback": lambda m: m.tiny_feedback(),
    # cb0 MTP chain at two frames a step
    "fps2": lambda m: m.with_frames_per_step(m.tiny(), 2),
    # residual_sum MTP with the batched-cp chain conditioning
    "fps2_cpb": lambda m: m.tiny_feedback(frames_per_step=2,
                                          mtp_cp_batch=True),
    # grouped depth (3 residual books a pass) reading a grafted draft
    "dg3_draft": lambda m: m.tiny_feedback(depth_group=3),
}


def _cfgs(case: str):
    def f32(c):
        return dataclasses.replace(c, dtype="float32")

    return f32(CASES[case](jcfgs)), f32(CASES[case](tcfgs))


def _np_trees(jcfg, draft: bool = False):
    p = init_talker(jcfg, 0)
    cp = init_code_predictor(jcfg, 1)
    if draft:  # independent values: the grouped layout must read these
        cp = {**cp, "draft": init_code_predictor(jcfg, 7)}
    return p, cp


def _batch(jcfg, seed: int = 0, t_text: int = 8, t_frames: int = 6) -> dict:
    """synthetic_batch with ragged text (>= 4 real tokens, the published
    head's minimum) on every other row."""
    b = jtrain.synthetic_batch(jcfg, 4, t_text, t_frames, seed=seed)
    b["text_mask"][1, 5:] = False
    b["text_mask"][3, 4:] = False
    return b


def _jnp(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def _key(path) -> str:
    return "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                    for e in path)


def _tensors(trees):
    """Tensor copies of numpy trees (tree_to shares a numpy leaf's memory
    on the CPU, and the optimizer updates its leaves in place)."""
    def copy(node):
        if isinstance(node, dict):
            return {k: copy(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(copy(v) for v in node)
        return np.array(node)

    return tree_to(copy(trees), "cpu")


def _torch_trees(*np_trees):
    """Tensor copies of numpy trees, every float leaf requiring grad."""
    out = _tensors(np_trees)
    for _, leaf in ttrain.tree_leaves(out):
        leaf.requires_grad_(leaf.is_floating_point())
    return out


def _assert_grads(jax_grads, torch_trees, tol: float = GRAD_TOL) -> dict:
    """Every JAX gradient leaf against the port leaf's .grad (None = zero);
    returns {path: max|grad|} of the port's."""
    port = dict(ttrain.tree_leaves(list(torch_trees)))
    seen = {}
    for path, g in jax.tree_util.tree_leaves_with_path(jax_grads):
        key = _key(path)
        want = np.asarray(g)
        leaf = port[key]
        got = (np.zeros_like(want) if leaf.grad is None
               else leaf.grad.numpy())
        scale = np.abs(want).max()
        err = np.abs(got - want).max()
        assert err <= tol * scale + 1e-12, (key, err, scale)
        seen[key] = float(np.abs(got).max())
    assert seen.keys() == port.keys()
    return seen


@pytest.mark.parametrize("case", list(CASES))
def test_joint_loss_and_grads_equal_jax(case):
    jcfg, tcfg = _cfgs(case)
    p, cp = _np_trees(jcfg, draft=case == "dg3_draft")
    b = _batch(jcfg)

    def f(a, c, bb):
        return jloss.joint_loss(a, c, jcfg, bb)

    (_, jm), jg = jax.jit(jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True))(p, cp, _jnp(b))
    tp, tc = _torch_trees(p, cp)
    loss, tm = tloss.joint_loss(tp, tc, tcfg, ttrain.device_batch(b, "cpu"))
    loss.backward()
    for k in ("talker_loss", "cp_loss", "loss"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_RTOL * abs(float(jm[k]))
    mags = _assert_grads(jg, (tp, tc))
    if case == "dg3_draft":
        # the grouped layout trains the draft; the primary predictor is
        # reached only through the residual feedback's tables
        assert mags["1/draft/heads"] > 0 and mags["1/draft/blocks/mlp/up/w"] > 0
        assert mags["1/heads"] == 0 and mags["1/blocks/mlp/up/w"] == 0
        assert mags["1/res_emb"] > 0


@pytest.mark.parametrize("case", ["cb0", "feedback", "fps2_cpb"])
def test_remat_equals_no_remat(case):
    """Per-block recompute (its caches allocated inside the checkpointed
    block) gives the loss and grads of the pass that keeps activations."""
    _, tcfg = _cfgs(case)
    jcfg, _ = _cfgs(case)
    p, cp = _np_trees(jcfg)
    b = ttrain.device_batch(_batch(jcfg), "cpu")
    runs = []
    for remat in (False, True):
        tp, tc = _torch_trees(p, cp)
        loss, _ = tloss.joint_loss(tp, tc, tcfg, b, remat=remat)
        loss.backward()
        runs.append((float(loss), {k: v.grad for k, v in
                                   ttrain.tree_leaves([tp, tc])}))
    (l0, g0), (l1, g1) = runs
    assert l1 == pytest.approx(l0, rel=1e-6)
    for k, g in g0.items():
        if g is None:
            assert g1[k] is None, k
            continue
        # tolerance 1e-6 of the leaf's largest grad
        assert (g1[k] - g).abs().max() <= 1e-6 * g.abs().max() + 1e-12, k


def test_talker_stack_equals_cached_talker_forward():
    """The training block runner's output, with and without remat, equals
    talker_forward over one stacked [L, ...] cache, the inference path, bit
    for bit at float32."""
    from qwen3_tts_tpu_torch.models.layers import rope_tables
    from qwen3_tts_tpu_torch.models.talker import talker_forward

    jcfg, tcfg = _cfgs("cb0")
    t = tcfg.talker
    (tp,) = tree_to((init_talker(jcfg, 0),), "cpu")
    x = torch.from_numpy(np.random.default_rng(3).normal(
        0, 0.5, (2, 9, t.hidden)).astype(np.float32))
    pad = torch.tensor([0, 3])
    ck = torch.zeros((t.n_layers, 2, 9, t.n_kv_heads, t.head_dim))
    cos, sin = rope_tables(9, t.head_dim, t.rope_theta)
    want_h, want_l, _, _ = talker_forward(tp, t, x, ck, ck.clone(), 0, cos,
                                          sin, pad_len=pad)
    for remat in (False, True):
        h, lg = tloss._talker_stack(tp, t, x, pad, remat)
        assert torch.equal(h, want_h) and torch.equal(lg, want_l)


def test_sequential_distill_loss_equals_jax():
    jcfg, tcfg = _cfgs("fps2_cpb")
    p, cp = _np_trees(jcfg)
    teacher = (init_talker(jcfg, 5), init_code_predictor(jcfg, 6))
    base_j, base_t = (dataclasses.replace(
        c, talker=dataclasses.replace(c.talker, frames_per_step=1,
                                      mtp_cp_batch=False))
        for c in (jcfg, tcfg))
    b = _batch(jcfg)

    def f(a, c, bb):
        return jloss.sequential_distill_loss(a, c, teacher, base_j, bb)

    jl, jg = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(p, cp, _jnp(b))
    tp, tc = _torch_trees(p, cp)
    t_teacher = tree_to(teacher, "cpu")
    kl = tloss.sequential_distill_loss(tp, tc, t_teacher, base_t,
                                       ttrain.device_batch(b, "cpu"))
    kl.backward()
    assert abs(float(kl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    _assert_grads(jg, (tp, tc))
    # the teacher trees get no gradient
    assert all(v.grad is None for _, v in ttrain.tree_leaves(t_teacher))


def test_anchor_penalty_equals_jax_and_skips_mtp():
    jcfg, _ = _cfgs("fps2")
    p, cp = _np_trees(jcfg)
    ref = (init_talker(jcfg, 5), init_code_predictor(jcfg, 6))

    def f(a, c):
        return (jtrain.anchor_penalty(a, ref[0])
                + jtrain.anchor_penalty(c, ref[1], skip=()))

    jl, jg = jax.value_and_grad(f, argnums=(0, 1))(p, cp)
    tp, tc = _torch_trees(p, cp)
    t_ref = tree_to(ref, "cpu")
    pen = (ttrain.anchor_penalty(tp, t_ref[0])
           + ttrain.anchor_penalty(tc, t_ref[1], skip=()))
    pen.backward()
    assert abs(float(pen) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    mags = _assert_grads(jg, (tp, tc))
    assert mags["0/mtp/merge/w"] == 0 and mags["0/head/w"] > 0


def _freeze_base_optax(opt):
    """finetune.py --freeze-base's optimizer in the JAX package."""
    def trainable(sub):
        def leaf_mask(tree):
            return jax.tree_util.tree_map_with_path(
                lambda path, _: sub in str(path).lower(), tree)
        return leaf_mask

    def mask_fn(trees):
        return trainable("mtp")(trees[0]), trainable("draft")(trees[1])

    def frozen_fn(trees):
        return jax.tree.map(lambda m: not m, mask_fn(trees))

    return optax.chain(optax.masked(opt, mask_fn),
                       optax.masked(optax.set_to_zero(), frozen_fn))


STEP_CASES = {
    "full_cb0": ("cb0", {}),
    "full_feedback": ("feedback", {}),
    "anchor_distill": ("fps2_cpb", {"anchor": 0.5, "distill": 0.5}),
    "freeze_base": ("dg3_draft", {"freeze": True}),
}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_three_steps_equal_optax(name):
    """make_train_step x3 against the JAX step x3: every loss, grad_norm
    and parameter leaf. Under freeze-base the JAX step's grad_norm covers
    every gradient it computes (the base's too), while the port computes
    gradients for the trainable leaves alone: its grad_norm is held
    against the JAX gradients' norm over those leaves, at step 1."""
    case, opts = STEP_CASES[name]
    jcfg, tcfg = _cfgs(case)
    if opts.get("freeze"):
        jcfg, tcfg = (dataclasses.replace(c, talker=dataclasses.replace(
            c.talker, frames_per_step=2)) for c in (jcfg, tcfg))
    p, cp = _np_trees(jcfg, draft=case == "dg3_draft")
    b = _batch(jcfg)
    jopt = jtrain.default_optimizer(lr=LR)
    topt = ttrain.default_optimizer(lr=LR)
    jkw, tkw = {}, {}
    if "anchor" in opts:
        ref_np = (init_talker(jcfg, 5), init_code_predictor(jcfg, 6))
        jkw = dict(anchor=ref_np, anchor_weight=opts["anchor"],
                   distill=ref_np, distill_weight=opts["distill"])
        ref_t = _tensors(ref_np)
        tkw = dict(anchor=ref_t, anchor_weight=opts["anchor"],
                   distill=ref_t, distill_weight=opts["distill"])
    if opts.get("freeze"):
        jopt = _freeze_base_optax(jopt)
        topt = dataclasses.replace(topt, trainable=(("mtp",), ("draft",)))

    jstate = jtrain.init_train_state(p, cp, jopt)
    jstep = jtrain.make_train_step(jcfg, jopt, remat=False, **jkw)
    tp, tc = _tensors((p, cp))
    tstate = ttrain.init_train_state(tp, tc, topt)
    tstep = ttrain.make_train_step(tcfg, topt, **tkw)
    jb = _jnp(b)
    for i in range(3):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, b)
        # step 1 starts from equal trees; later steps from trees that
        # differ by up to STEP_TOL * lr, so their metrics by more
        rtol = LOSS_RTOL if i == 0 else STEP_METRIC_RTOL
        for k in jm:
            if k == "grad_norm" and opts.get("freeze"):
                continue
            assert abs(float(tm[k]) - float(jm[k])) <= \
                rtol * abs(float(jm[k])), (i, k)
        got = dict(ttrain.tree_leaves([tstate.params, tstate.cp_params]))
        diffs = {}
        for path, want in jax.tree_util.tree_leaves_with_path(
                (jstate.params, jstate.cp_params)):
            diffs[_key(path)] = np.abs(got[_key(path)].detach().numpy()
                                       - np.asarray(want)).ravel()
        worst = max(diffs.items(), key=lambda kv: kv[1].max())
        assert worst[1].max() <= STEP_TOL * LR, (i, worst[0], worst[1].max())
        if i == 0:
            share = np.mean(np.concatenate(list(diffs.values())) <= STEP1_ATOL)
            assert share >= STEP1_SHARE, share
    assert tstate.step == 3 and int(jstate.step) == 3
    if opts.get("freeze"):
        # frozen leaves bit-identical to the start, trained ones moved
        start = {_key(q): np.asarray(x)
                 for q, x in jax.tree_util.tree_leaves_with_path((p, cp))}
        for path, x in ttrain.tree_leaves([tstate.params, tstate.cp_params]):
            moved = not np.array_equal(x.detach().numpy(), start[path])
            assert moved == ("mtp" in path or "draft" in path), path
        # grad_norm at step 1 over the trainable leaves
        jg = jax.grad(lambda a, c: jloss.joint_loss(a, c, jcfg, jb)[0],
                      argnums=(0, 1))(p, cp)
        mask = [("mtp" in _key(q)) if _key(q).startswith("0/")
                else ("draft" in _key(q))
                for q, _ in jax.tree_util.tree_leaves_with_path(jg)]
        want = float(optax.global_norm(
            [g for g, m in zip(jax.tree.leaves(jg), mask) if m]))
        tp2, tc2 = _tensors((p, cp))
        s2 = ttrain.init_train_state(tp2, tc2, topt)
        _, m1 = tstep(s2, b)
        assert float(m1["grad_norm"]) == pytest.approx(want, rel=LOSS_RTOL)


def test_clip_follows_optax_formula():
    """g * clip / |g| only when |g| >= clip (torch's clip_grad_norm_
    would divide by |g| + 1e-6)."""
    w = torch.zeros(3, requires_grad=True)
    opt = ttrain.Optimizer(lr=0.0, weight_decay=0.0, clip=1.0).build([w])
    w.grad = torch.tensor([3.0, 4.0, 0.0])
    seen = []
    orig = opt.step
    opt.step = lambda: seen.append(w.grad.clone()) or orig()
    norm = ttrain._optimizer_update(opt, 1.0)
    assert float(norm) == 5.0
    assert torch.equal(seen[0], torch.tensor([3.0, 4.0, 0.0]) / 5.0 * 1.0)
    w.grad = torch.tensor([0.3, 0.4, 0.0])
    ttrain._optimizer_update(opt, 1.0)
    assert torch.equal(seen[1], torch.tensor([0.3, 0.4, 0.0]))


def test_unported_mesh_and_sequence_parallel_raise():
    """Training across ranks is ported (tests/test_torch_parallel_training
    .py); what JAX refuses still raises its ValueError, and the one-rank
    mesh builds the one-device step."""
    from qwen3_tts_tpu_torch.parallel.mesh import local_mesh

    cfg = tcfgs.tiny()
    opt = ttrain.default_optimizer()
    with pytest.raises(ValueError, match="sequence_parallel needs a mesh"):
        ttrain.make_train_step(cfg, opt, sequence_parallel=True)
    with pytest.raises(ValueError, match="tp > 1"):
        ttrain.make_train_step(cfg, opt, mesh=local_mesh(),
                               sequence_parallel=True)
    ttrain.make_train_step(cfg, opt, mesh=local_mesh())


# ports of tests/test_loss_padding.py ----------------------------------------

def _padding_batch(cfg, lengths, Tt, Tf, seed=7):
    t, cc = cfg.talker, cfg.codec
    rng = np.random.default_rng(seed)
    B = len(lengths)
    text = np.zeros((B, Tt), np.int32)
    mask = np.zeros((B, Tt), bool)
    for i, n in enumerate(lengths):
        text[i, :n] = rng.integers(1, t.vocab_size, n)
        mask[i, :n] = True
    codes = rng.integers(0, cc.residual_codebook_size,
                         (B, cc.num_codebooks, Tf)).astype(np.int32)
    codes[:, 0, :] = rng.integers(0, cc.codebook_size, (B, Tf))
    return ttrain.device_batch({"text_tokens": text, "text_mask": mask,
                                "codes": codes,
                                "frame_mask": np.ones((B, Tf), bool)}, "cpu")


def _tiny_f32_talker(seed):
    cfg = dataclasses.replace(tcfgs.tiny("custom", quant=False),
                              dtype="float32")
    jcfg = dataclasses.replace(jcfgs.tiny("custom", quant=False),
                               dtype="float32")
    (p,) = tree_to((init_talker(jcfg, seed),), "cpu")
    return cfg, p


def test_training_layout_matches_unpadded_examples():
    cfg, params = _tiny_f32_talker(0)
    lengths = [8, 5, 2]
    batch = _padding_batch(cfg, lengths, 8, 6)
    _, batched = tloss._talker_hidden_and_logits(params, cfg, batch)
    for i, n in enumerate(lengths):
        single = {"text_tokens": batch["text_tokens"][i:i + 1, :n],
                  "text_mask": batch["text_mask"][i:i + 1, :n],
                  "codes": batch["codes"][i:i + 1],
                  "frame_mask": batch["frame_mask"][i:i + 1]}
        _, one = tloss._talker_hidden_and_logits(params, cfg, single)
        torch.testing.assert_close(batched[i], one[0], atol=2e-4, rtol=2e-4)


def test_talker_loss_invariant_to_pad_token_content():
    cfg, params = _tiny_f32_talker(1)
    batch = _padding_batch(cfg, [6, 3], 8, 5)
    loss_a = float(tloss.talker_loss(params, cfg, batch))
    garbage = batch["text_tokens"].clone()
    garbage[~batch["text_mask"]] = 42
    loss_b = float(tloss.talker_loss(params, cfg,
                                     dict(batch, text_tokens=garbage)))
    assert loss_a == pytest.approx(loss_b, abs=1e-6)


# ports of tests/test_train_checkpoint.py ------------------------------------

def _ckpt_setup(seed=0):
    cfg = tcfgs.tiny("custom", quant=False)
    model = Qwen3TTSModel.synthetic(cfg, seed=seed, device="cpu")
    opt = ttrain.default_optimizer(lr=1e-3)
    return cfg, model, opt


def test_checkpoint_roundtrip_and_resume(temp_dir):
    cfg, model, opt = _ckpt_setup()
    state = ttrain.init_train_state(model.params, model.cp_params, opt)
    step = ttrain.make_train_step(cfg, opt, remat=False)
    batch = ttrain.synthetic_batch(cfg, 2, 4, 4, seed=0)
    state, _ = step(state, batch)
    state, _ = step(state, batch)
    path = save_train_state(state, temp_dir)
    assert latest_checkpoint(temp_dir) == path
    assert not any(d.endswith("-tmp") for d in __import__("os").listdir(
        temp_dir))

    _, fresh, _ = _ckpt_setup(seed=99)
    template = ttrain.init_train_state(fresh.params, fresh.cp_params, opt)
    restored = restore_train_state(path, template)
    assert restored.step == 2
    assert torch.equal(restored.params["ln_f"], state.params["ln_f"])
    a = restored.opt_state.state_dict()["state"]
    b = state.opt_state.state_dict()["state"]
    assert a.keys() == b.keys() and len(a) == len(
        state.opt_state.param_groups[0]["params"])
    for i in a:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a[i][k], b[i][k]), (i, k)
    _, m_orig = step(state, batch)
    _, m_rest = step(restored, batch)
    assert float(m_orig["loss"]) == pytest.approx(float(m_rest["loss"]),
                                                  rel=1e-5)


def test_resume_after_k_of_n_equals_uninterrupted(temp_dir):
    """2 steps, save, restore into a fresh state, 2 more: the trees equal
    a 4-step run bit for bit."""
    cfg, m1, opt = _ckpt_setup()
    batch = ttrain.synthetic_batch(cfg, 2, 4, 4, seed=0)
    step = ttrain.make_train_step(cfg, opt)
    full = ttrain.init_train_state(m1.params, m1.cp_params, opt)
    for _ in range(4):
        full, _ = step(full, batch)

    _, m2, _ = _ckpt_setup()
    part = ttrain.init_train_state(m2.params, m2.cp_params, opt)
    for _ in range(2):
        part, _ = step(part, batch)
    path = save_train_state(part, temp_dir)
    _, m3, _ = _ckpt_setup(seed=5)
    resumed = restore_train_state(
        path, ttrain.init_train_state(m3.params, m3.cp_params, opt))
    for _ in range(2):
        resumed, _ = step(resumed, batch)
    assert resumed.step == 4
    got = dict(ttrain.tree_leaves([resumed.params, resumed.cp_params]))
    for k, v in ttrain.tree_leaves([full.params, full.cp_params]):
        assert torch.equal(got[k], v), k


def test_restore_rejects_another_structure(temp_dir):
    cfg, model, opt = _ckpt_setup()
    state = ttrain.init_train_state(model.params, model.cp_params, opt)
    path = save_train_state(state, temp_dir, step=0)
    other = Qwen3TTSModel.synthetic(
        tcfgs.with_frames_per_step(cfg, 2), device="cpu")
    with pytest.raises(ValueError, match="differs"):
        restore_train_state(path, ttrain.init_train_state(
            other.params, other.cp_params, opt))


# ports of tests/test_training_data.py ---------------------------------------

@pytest.fixture(scope="module")
def data_model():
    return Qwen3TTSModel.synthetic(tcfgs.tiny("custom"), seed=0, device="cpu")


def _tone(seconds, sr=24_000, freq=300.0):
    t = np.arange(int(sr * seconds)) / sr
    return (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def test_encode_example_shapes(data_model):
    ex = encode_example(data_model, "hello world", _tone(0.5), 24_000)
    assert ex.codes.shape[0] == data_model.cfg.codec.num_codebooks
    assert 5 <= ex.codes.shape[1] <= 7       # 0.5 s at 12 Hz
    assert ex.text_tokens.dtype == np.int32


def test_encode_example_resamples(data_model):
    ex = encode_example(data_model, "hi", _tone(0.5, sr=16_000), 16_000)
    assert 5 <= ex.codes.shape[1] <= 7


def test_pad_batch_buckets_and_masks_equal_jax():
    from qwen3_tts_tpu.training.data import Example as JaxExample

    q = 4
    shapes = [(5, 3), (9, 7), (20, 12)]
    exs = [Example(np.arange(n, dtype=np.int32),
                   np.full((q, f), i + 1, np.int32))
           for i, (n, f) in enumerate(shapes)]
    exs[2].speaker_id = 2
    b = pad_batch(exs[:2])
    assert b["text_tokens"].shape == (2, 16) and b["codes"].shape == (2, q, 8)
    assert b["text_mask"][0].sum() == 5 and b["text_mask"][1].sum() == 9
    assert b["frame_mask"][0].sum() == 3 and b["frame_mask"][1].sum() == 7
    want = jax_pad_batch([JaxExample(e.text_tokens, e.codes, e.speaker_id)
                          for e in exs])
    got = pad_batch(exs)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_batches_from_pairs_equal_jax():
    """The same float32 tiny model in both packages: the encoded, sorted,
    shuffled batches are equal arrays."""
    jcfg = dataclasses.replace(jcfgs.tiny("custom"), dtype="float32")
    tcfg = dataclasses.replace(tcfgs.tiny("custom"), dtype="float32")
    jm = JaxModel.synthetic(jcfg, seed=0)
    tm = Qwen3TTSModel.synthetic(tcfg, seed=0, device="cpu")
    pairs = [(f"utterance number {i}", _tone(0.3 + 0.1 * (i % 3),
                                             freq=200 + 40 * i), 24_000)
             for i in range(5)]
    want = list(jax_batches(jm, pairs, batch_size=2, shuffle_seed=3))
    got = list(batches_from_pairs(tm, pairs, batch_size=2, shuffle_seed=3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_pipeline_feeds_train_step(data_model):
    pairs = [(f"utterance number {i}", _tone(0.3 + 0.1 * (i % 3)), 24_000)
             for i in range(4)]
    batches = list(batches_from_pairs(data_model, pairs, batch_size=2))
    assert len(batches) == 2
    model = Qwen3TTSModel.synthetic(tcfgs.tiny("custom"), seed=0,
                                    device="cpu")
    opt = ttrain.default_optimizer(lr=3e-3)
    state = ttrain.init_train_state(model.params, model.cp_params, opt)
    step = ttrain.make_train_step(model.cfg, opt, remat=False)
    first = last = None
    for _ in range(4):
        for b in batches:
            state, m = step(state, b)
            first = float(m["loss"]) if first is None else first
            last = float(m["loss"])
    assert last < first


def test_residual_sum_pipeline_rejects_short_text():
    model = Qwen3TTSModel.synthetic(tcfgs.tiny_feedback(), device="cpu")
    with pytest.raises(ValueError, match=">=4 text tokens"):
        list(batches_from_pairs(model, [("hi", _tone(0.3), 24_000)],
                                batch_size=1))


# port of tests/test_parallel_training.py::test_train_step_runs_and_reduces_loss

def test_train_step_runs_and_reduces_loss():
    cfg = tcfgs.tiny(quant=False)
    model = Qwen3TTSModel.synthetic(cfg, seed=0, device="cpu")
    opt = ttrain.default_optimizer(lr=3e-3)
    state = ttrain.init_train_state(model.params, model.cp_params, opt)
    step = ttrain.make_train_step(cfg, opt, remat=False)
    batch = ttrain.synthetic_batch(cfg, batch_size=2, t_text=6, t_frames=5,
                                   seed=0)
    state, m0 = step(state, batch)
    for _ in range(8):
        state, m = step(state, batch)
    assert float(m["loss"]) < float(m0["loss"])
    assert state.step == 9
    assert np.isfinite(float(m["grad_norm"]))


def test_synthetic_batch_equals_jax():
    cfg_j, cfg_t = jcfgs.tiny(), tcfgs.tiny()
    want = jtrain.synthetic_batch(cfg_j, 3, 5, 4, seed=2)
    got = ttrain.synthetic_batch(cfg_t, 3, 5, 4, seed=2)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
