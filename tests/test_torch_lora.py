"""The port's LoRA fine-tuning (training/lora.py) against the JAX
package's: adapters drawn bit for bit as its add_lora draws them, an exact
merge, three adapter steps against optax, and ports of
tests/test_lora.py (identity at init, adapter-only training with the base
frozen and no base-sized gradient, merge, checkpoint, MTP head grafting)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.engine import configs as jcfgs
from qwen3_tts_tpu.models.code_predictor import init_code_predictor
from qwen3_tts_tpu.models.talker import init_talker
from qwen3_tts_tpu.training import lora as jlora
from qwen3_tts_tpu.training import train as jtrain
from qwen3_tts_tpu_torch.engine import configs as tcfgs
from qwen3_tts_tpu_torch.engine.weights import tree_to
from qwen3_tts_tpu_torch.models.code_predictor import (
    init_code_predictor as t_init_cp,
)
from qwen3_tts_tpu_torch.models.layers import rope_tables
from qwen3_tts_tpu_torch.models.talker import (
    add_mtp_params,
    init_talker as t_init_talker,
    mtp_logits,
    talker_forward,
)
from qwen3_tts_tpu_torch.training import (
    add_lora,
    init_lora_train_state,
    make_lora_train_step,
    merge_lora,
    merge_trees,
    split_lora,
    split_subtree,
)
from qwen3_tts_tpu_torch.training.train import (
    default_optimizer,
    synthetic_batch,
    tree_leaves,
)
from torch_port_helpers import assert_trees_equal, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# float32: |port - jax| <= 1e-5 * |jax| on each loss; adapter leaves after
# three steps within 0.1 lr of optax's (Adam normalizes each component:
# see tests/test_torch_training.py STEP_TOL)
LOSS_RTOL = 1e-5
STEP_TOL = 0.1
LR = 1e-2


def _cfg(mod=tcfgs):
    # dense f32: training runs dense, and f32 keeps the identity/merge
    # assertions exact instead of bf16-rounding-limited
    return dataclasses.replace(mod.tiny("custom", quant=False), dtype="float32")


def _forward_logits(params, cfg, tokens):
    t = cfg.talker
    S = cfg.max_seq_len
    cos_t, sin_t = rope_tables(S, t.head_dim, t.rope_theta)
    B, _ = tokens.shape
    emb = params["codec_emb"][tokens]
    ck = torch.zeros((t.n_layers, B, S, t.n_kv_heads, t.head_dim), dtype=emb.dtype)
    with torch.no_grad():
        _, logits, _, _ = talker_forward(params, t, emb, ck, ck.clone(), 0,
                                         cos_t, sin_t)
    return logits


def _tokens(seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 60, (2, 5)))


def test_zero_init_is_identity():
    cfg = _cfg()
    params = t_init_talker(cfg, seed=0)
    adapted = add_lora(params, rank=4, seed=1)
    tok = _tokens(0)
    assert torch.equal(_forward_logits(params, cfg, tok),
                       _forward_logits(adapted, cfg, tok))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_lora_equals_jax_bit_for_bit(dtype):
    """The same numpy draws in the same order, rounded to the weight's
    dtype the same way."""
    jcfg = dataclasses.replace(jcfgs.tiny("custom", quant=False), dtype=dtype)
    p = init_talker(jcfg, seed=0)
    want = jlora.add_lora(p, rank=4, seed=3)
    (tp,) = tree_to((p,), "cpu")
    got = add_lora(tp, rank=4, seed=3)
    assert_trees_equal(got, want)


def test_add_lora_on_port_tree_equals_jax():
    """A tree the port initialises walks in the JAX tree's order, so
    add_lora draws the JAX package's adapters for it too."""
    jcfg = _cfg(jcfgs)
    want = jlora.add_lora(init_talker(jcfg, seed=0), rank=4, seed=3)
    got = add_lora(t_init_talker(_cfg(), seed=0), rank=4, seed=3)

    def walk_order(node, pre=""):   # add_lora's walk: dict iteration order
        if isinstance(node, dict):
            return [p for k, v in node.items()
                    for p in walk_order(v, f"{pre}{k}/")]
        return [pre[:-1]]

    assert [p for p, _ in tree_leaves(got)] == walk_order(want)
    assert_trees_equal(got, want)


def test_merge_lora_equals_jax():
    jcfg = _cfg(jcfgs)
    adapted = jlora.add_lora(init_talker(jcfg, seed=0), rank=4, seed=1)
    rng = np.random.default_rng(5)

    def fill_b(node):
        if isinstance(node, dict):
            out = {k: fill_b(v) for k, v in node.items()}
            if "lora_b" in node:
                out["lora_b"] = rng.normal(0, 0.1, node["lora_b"].shape
                                           ).astype(np.float32)
            return out
        return node

    adapted = fill_b(adapted)
    want = jax.tree.map(np.asarray, jlora.merge_lora(adapted))
    (tp,) = tree_to((adapted,), "cpu")
    got = dict(tree_leaves(merge_lora(tp)))
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(got)
    for path, w in flat:
        key = "/".join(str(e.key) for e in path)
        # tolerance: float32 products of rank 4, summed in another order
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=1e-6,
                                   err_msg=key)


def test_adapter_structure_and_split_merge_roundtrip():
    cfg = _cfg()
    params = t_init_talker(cfg, seed=0)
    adapted = add_lora(params, rank=4, seed=1)
    t = cfg.talker
    a = adapted["blocks"]["attn"]["q"]["lora_a"]
    b = adapted["blocks"]["attn"]["q"]["lora_b"]
    assert tuple(a.shape) == (t.n_layers, 4, t.hidden)
    assert b.shape[0] == t.n_layers and b.shape[2] == 4
    assert not torch.any(b)                    # zero-init B
    assert adapted["codec_emb"] is params["codec_emb"]  # untargeted untouched

    lora, base = split_lora(adapted)
    leaves = tree_leaves(lora)
    assert leaves and all(p.rsplit("/", 1)[-1] in ("lora_a", "lora_b")
                          for p, _ in leaves)
    assert "lora_scale" in base["blocks"]["attn"]["q"]
    assert_trees_equal(merge_trees(base, lora), adapted)


def _lora_setup(lr=1e-2, seed=1):
    cfg = _cfg()
    params = t_init_talker(cfg, seed=0)
    cp_params = t_init_cp(cfg, seed=1)
    lora, base = split_lora(add_lora(params, rank=4, seed=seed))
    opt = default_optimizer(lr=lr)
    return cfg, params, cp_params, lora, base, opt


def test_lora_train_step_updates_only_adapters():
    """A few LoRA steps: loss finite, adapters move, base and predictor
    bitwise frozen with no gradient allocated, optimizer state
    adapter-sized."""
    cfg, _, cp_params, lora, base, opt = _lora_setup()
    state = init_lora_train_state(lora, opt)
    step = make_lora_train_step(cfg, opt, remat=True)
    batch = synthetic_batch(cfg, batch_size=2, t_text=6, t_frames=5)
    base_before = {k: v.clone() for k, v in tree_leaves(base)}
    losses = []
    for _ in range(3):
        state, metrics = step(state, base, cp_params, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)), losses
    assert float(metrics["grad_norm"]) > 0.0
    assert torch.any(state.lora["blocks"]["attn"]["q"]["lora_b"] != 0.0)
    for k, v in tree_leaves(base):
        assert torch.equal(v, base_before[k]), k
    for _, v in tree_leaves(base) + tree_leaves(cp_params):
        assert v.grad is None and not v.requires_grad
    n_lora = sum(x.numel() for _, x in tree_leaves(state.lora))
    moments = [t for s in state.opt_state.state.values() for k, t in s.items()
               if k != "step"]
    assert sum(t.numel() for t in moments) == 2 * n_lora
    n_base = sum(x.numel() for _, x in tree_leaves(base))
    assert n_lora < n_base / 10


def test_lora_three_steps_equal_optax():
    jcfg = _cfg(jcfgs)
    p, cp = init_talker(jcfg, seed=0), init_code_predictor(jcfg, seed=1)
    jl, jb = jlora.split_lora(jlora.add_lora(p, rank=4, seed=1))
    jopt = jtrain.default_optimizer(lr=LR)
    js = jlora.init_lora_train_state(jl, jopt)
    jstep = jlora.make_lora_train_step(jcfg, jopt, remat=False)
    batch = synthetic_batch(_cfg(), 2, 6, 5, seed=0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    (tp, tcp) = tree_to((jax.tree.map(np.array, p), jax.tree.map(np.array, cp)),
                        "cpu")
    tl, tb = split_lora(add_lora(tp, rank=4, seed=1))
    topt = default_optimizer(lr=LR)
    ts = init_lora_train_state(tl, topt)
    tstep = make_lora_train_step(_cfg(), topt)
    for i in range(3):
        js, jm = jstep(js, jb, cp, jbatch)
        ts, tm = tstep(ts, tb, tcp, batch)
        rtol = LOSS_RTOL if i == 0 else 1e-3
        for k in jm:
            assert abs(float(tm[k]) - float(jm[k])) <= rtol * abs(float(jm[k])), (i, k)
    got = dict(tree_leaves(ts.lora))
    for path, w in jax.tree_util.tree_leaves_with_path(js.lora):
        key = "/".join(str(e.key) for e in path)
        err = np.abs(got[key].detach().numpy() - np.asarray(w)).max()
        assert err <= STEP_TOL * LR, (key, err)


def test_merge_lora_matches_adapter_forward():
    cfg, params, cp_params, lora, base, _ = _lora_setup()
    opt = default_optimizer(lr=5e-2)
    state = init_lora_train_state(lora, opt)
    step = make_lora_train_step(cfg, opt)
    batch = synthetic_batch(cfg, batch_size=2, t_text=6, t_frames=5)
    for _ in range(2):
        state, _ = step(state, base, cp_params, batch)
    trained = merge_trees(base, state.lora)
    merged = merge_lora(trained)
    assert not any("lora_" in p for p, _ in tree_leaves(merged))
    tok = _tokens(1)
    torch.testing.assert_close(_forward_logits(trained, cfg, tok),
                               _forward_logits(merged, cfg, tok),
                               atol=2e-4, rtol=0)
    assert not torch.allclose(_forward_logits(merged, cfg, tok),
                              _forward_logits(params, cfg, tok))


def test_lora_state_checkpoint_roundtrip(temp_dir):
    from qwen3_tts_tpu_torch.training.checkpoint import (
        latest_checkpoint,
        restore_train_state,
        save_train_state,
    )

    cfg, _, cp_params, lora, base, opt = _lora_setup()
    state = init_lora_train_state(lora, opt)
    step = make_lora_train_step(cfg, opt)
    batch = synthetic_batch(cfg, batch_size=2, t_text=6, t_frames=5)
    state, _ = step(state, base, cp_params, batch)
    save_train_state(state, temp_dir)

    _, _, _, lora2, _, _ = _lora_setup(seed=9)
    template = init_lora_train_state(lora2, opt)
    restored = restore_train_state(latest_checkpoint(temp_dir), template)
    assert restored.step == 1
    assert_trees_equal(restored.lora, state.lora)
    restored, metrics = step(restored, base, cp_params, batch)
    assert np.isfinite(float(metrics["loss"]))


def test_add_lora_rejects_quantized():
    cfg = tcfgs.tiny("custom", quant=True)
    with pytest.raises(ValueError, match="dequantize"):
        add_lora(t_init_talker(cfg, seed=0), rank=4)


def test_mtp_head_grafting_and_training():
    """An fps=1 talker gains grafted MTP heads, only the heads train
    against the frozen base (split_subtree + the adapter train step), and
    the result decodes one MTP frame at frames_per_step=2."""
    cfg1 = _cfg()
    params = t_init_talker(cfg1, seed=0)
    assert "mtp" not in params
    cfg2 = dataclasses.replace(tcfgs.with_frames_per_step(cfg1, 2),
                               dtype="float32")
    with pytest.raises(ValueError, match="frames_per_step"):
        add_mtp_params(params, cfg1)
    grafted = add_mtp_params(params, cfg2, seed=3)
    with pytest.raises(ValueError, match="already"):
        add_mtp_params(grafted, cfg2)

    heads, base = split_subtree(grafted, "mtp")
    cp_params = t_init_cp(cfg2, seed=1)
    opt = default_optimizer(lr=1e-2)
    state = init_lora_train_state(heads, opt)
    step = make_lora_train_step(cfg2, opt)
    batch = synthetic_batch(cfg2, batch_size=2, t_text=6, t_frames=6)
    before = heads["mtp"]["mlp"]["gate"]["w"].detach().clone()
    base_before = {k: v.clone() for k, v in tree_leaves(base)}
    for _ in range(2):
        state, metrics = step(state, base, cp_params, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert not torch.equal(state.lora["mtp"]["mlp"]["gate"]["w"], before)
    for k, v in tree_leaves(base):
        assert torch.equal(v, base_before[k]), k
    trained = merge_trees(base, state.lora)
    with torch.no_grad():
        lg, _ = mtp_logits(trained, cfg2.talker,
                           torch.zeros((2, cfg2.talker.hidden)),
                           torch.zeros((2,), dtype=torch.long))
    assert tuple(lg.shape) == (2, cfg2.talker.codec_vocab)
    assert torch.isfinite(lg).all()
