"""The port's layers, talker, code predictor, codec and sampling against the
JAX package's, on tiny float32 configs fed one numpy tree
(engine.weights.params_from_numpy)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu.engine import configs as jcfgs
from qwen3_tts_tpu.models import code_predictor as jcp
from qwen3_tts_tpu.models import codec as jcodec
from qwen3_tts_tpu.models import layers as jlayers
from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.ops.grouped_qmv import pack_grouped_tree as jax_pack_tree
from qwen3_tts_tpu.runtime import sampling as jsampling
from qwen3_tts_tpu_torch.engine import configs as tcfgs
from qwen3_tts_tpu_torch.engine.weights import params_from_numpy, tree_to
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.models import codec as tcodec
from qwen3_tts_tpu_torch.models import layers as tlayers
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.ops.grouped_qmv import pack_grouped_tree
from qwen3_tts_tpu_torch.runtime import sampling as tsampling
from torch_port_helpers import tame_codec, tiny_f32

ATOL = 1e-5  # float32 parity: same arithmetic, different summation order


def _cfgs(**cp_changes):
    """(JAX config, port config): tiny, int8, float32."""
    return [tiny_f32(mod, **cp_changes) for mod in (jcfgs, tcfgs)]


def test_numpy_init_matches_jax():
    """The port's host initialisers draw the JAX package's values (f32)."""
    jc, tc = _cfgs()
    pairs = [(jtalker.init_talker(jc, 3), ttalker.init_talker(tc, 3)),
             (jcp.init_code_predictor(jc, 4), tcp.init_code_predictor(tc, 4)),
             (jcodec.init_codec(jc, 5), tcodec.init_codec(tc, 5))]

    def walk(a, b):
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k])
        elif isinstance(b, list):
            for x, y in zip(a, b):
                walk(x, y)
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))

    for ref, got in pairs:
        walk(ref, got)


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy(),
        np.asarray(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        atol=ATOL)
    jc, js = jlayers.rope_tables(32, 16, 10_000.0)
    tc, ts = tlayers.rope_tables(32, 16, 10_000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    jcs, jss = jlayers.rope_slice(jc, js, jnp.int32(7), 5)
    tcs, tss = tlayers.rope_slice(tc, ts, 7, 5)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(x), tcs, tss).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jcs, jss)), atol=ATOL)


@pytest.mark.parametrize("pos,T,pad", [(0, 6, 2), (9, 1, 2)])
def test_attention_left_pad_and_cache_write_match_jax(pos, T, pad):
    """GQA attention over a cache with left padding: output and the cache
    write at ``pos`` (prefill at 0, one decode step later)."""
    rng = np.random.default_rng(1)
    D, H, Hkv, hd, S = 32, 4, 2, 8, 16
    p = {
        "q": {"w": rng.normal(0, 0.2, (H * hd, D)).astype(np.float32)},
        "k": {"w": rng.normal(0, 0.2, (Hkv * hd, D)).astype(np.float32)},
        "v": {"w": rng.normal(0, 0.2, (Hkv * hd, D)).astype(np.float32)},
        "o": {"w": rng.normal(0, 0.2, (D, H * hd)).astype(np.float32)},
        "q_norm": rng.normal(1, 0.1, (hd,)).astype(np.float32),
        "k_norm": rng.normal(1, 0.1, (hd,)).astype(np.float32),
    }
    x = rng.normal(size=(2, T, D)).astype(np.float32)
    ck = rng.normal(size=(2, S, Hkv, hd)).astype(np.float32)  # stale contents
    cv = rng.normal(size=(2, S, Hkv, hd)).astype(np.float32)
    jc, js = jlayers.rope_tables(S, hd, 1e4)
    kw = dict(pos=pos, n_heads=H, n_kv_heads=Hkv, head_dim=hd, rms_eps=1e-6,
              pad_len=pad)
    ref = jlayers.attention(
        p, jnp.asarray(x), cos=jc[pos:pos + T], sin=js[pos:pos + T],
        cache_k=jnp.asarray(ck), cache_v=jnp.asarray(cv), **kw)
    tc, ts = tlayers.rope_tables(S, hd, 1e4)
    got = tlayers.attention(
        tree_to(p, "cpu"), torch.from_numpy(x), cos=tc[pos:pos + T],
        sin=ts[pos:pos + T], cache_k=torch.from_numpy(ck.copy()),
        cache_v=torch.from_numpy(cv.copy()), **kw)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("layout", ["rowmajor", "grouped"])
def test_talker_prefill_and_decode_match_jax(layout):
    jc, tc = _cfgs()
    t = jc.talker
    params_np = jtalker.init_talker(jc, 0)
    if layout == "grouped":
        params_np = jax_pack_tree(params_np)
    params, _, _ = params_from_numpy(params_np, {}, {}, device="cpu")
    rng = np.random.default_rng(2)
    Lb, pad, S = 8, 3, 16
    emb = rng.normal(0, 0.5, (1, Lb, t.hidden)).astype(np.float32)
    emb[:, :pad] = 0.0
    shape = (t.n_layers, 1, S, t.n_kv_heads, t.head_dim)
    jcos, jsin = jlayers.rope_tables(S, t.head_dim, t.rope_theta)
    tcos, tsin = tlayers.rope_tables(S, t.head_dim, t.rope_theta)
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    tok = np.array([5])
    for step, (x, pos) in enumerate([(emb, 0), (None, Lb)]):
        if x is None:  # one decode step on the codec embedding of a token
            x = np.array(jtalker.embed_codec_tokens(params_np, tok))[:, None]
            assert np.array_equal(
                ttalker.merge_step_tokens(params, tc.talker,
                                          torch.from_numpy(tok)[:, None]).numpy(),
                x[:, 0])
        jh, jl, jk, jv = jtalker.talker_forward(
            params_np, t, jnp.asarray(x), jk, jv, jnp.int32(pos), jcos, jsin,
            pad_len=pad)
        th, tl, tk, tv = ttalker.talker_forward(
            params, tc.talker, torch.from_numpy(x), tk, tv, pos, tcos, tsin,
            pad_len=pad)
        for a, b in ((th, jh), (tl, jl), (tk, jk), (tv, jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                       err_msg=f"step {step}")


@pytest.mark.parametrize("cp_changes", [
    {},
    {"depth_group": 3},
    {"hidden": 64, "input_layout": "hidden_token", "input_proj": False,
     "qk_norm": False},
], ids=["sum", "depth_group3", "hidden_token"])
def test_predict_residuals_greedy_token_exact(cp_changes):
    jc, tc = _cfgs(**cp_changes)
    cp_np = jcp.init_code_predictor(jc, 1)
    _, cp, _ = params_from_numpy({}, cp_np, {}, device="cpu")
    rng = np.random.default_rng(3)
    B = 24
    hidden = rng.normal(0, 1.0, (B, jc.talker.hidden)).astype(np.float32)
    cb0 = rng.integers(0, jc.codec.codebook_size, B)
    ref = np.asarray(jcp.predict_residuals(cp_np, jc, jnp.asarray(hidden),
                                           jnp.asarray(cb0, jnp.int32)))
    got = tcp.predict_residuals(cp, tc, torch.from_numpy(hidden),
                                torch.from_numpy(cb0))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_predict_residuals_sampled_draws_valid_codes():
    jc, tc = _cfgs(top_k=5, top_p=0.9, temperature=0.8)
    _, cp, _ = params_from_numpy({}, jcp.init_code_predictor(jc, 1), {},
                                 device="cpu")
    hidden = torch.randn(6, jc.talker.hidden)
    g = torch.Generator().manual_seed(0)
    codes = tcp.predict_residuals(cp, tc, hidden, torch.arange(6), generator=g)
    assert codes.shape == (6, jc.codec.num_codebooks - 1)
    assert int(codes.min()) >= 0
    assert int(codes.max()) < jc.codec.residual_codebook_size


def _codes(cc, T, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(0, cc.codebook_size, (1, 1, T)),
        rng.integers(0, cc.residual_codebook_size, (1, cc.num_codebooks - 1, T)),
    ], axis=1).astype(np.int64)


def test_codec_streaming_matches_jax_and_one_shot():
    """decode_codes_streaming chunk by chunk equals the JAX streaming decode
    and the port's own one-shot decode_codes (unclipped waveform:
    torch_port_helpers.tame_codec)."""
    jc, tc = _cfgs()
    codec_np = tame_codec(jcodec.init_codec(jc, 2))
    _, _, codec = params_from_numpy({}, {}, codec_np, device="cpu")
    T, chunk = 24, 6
    codes = _codes(jc.codec, T, 4)
    jstate = jcodec.init_codec_stream_state(jc, 1, dtype=jnp.float32)
    tstate = tcodec.init_codec_stream_state(tc, 1, dtype=torch.float32)
    jpieces, tpieces = [], []
    for k in range(0, T, chunk):
        piece = codes[:, :, k:k + chunk]
        jw, jstate = jcodec.decode_codes_streaming(
            codec_np, jc, jnp.asarray(piece, jnp.int32), jstate, jnp.int32(k))
        tw, tstate = tcodec.decode_codes_streaming(
            codec, tc, torch.from_numpy(piece), tstate, k)
        jpieces.append(np.asarray(jw))
        tpieces.append(tw.numpy())
    streamed = np.concatenate(tpieces, axis=1)
    np.testing.assert_allclose(streamed, np.concatenate(jpieces, axis=1),
                               atol=ATOL)
    full = tcodec.decode_codes(codec, tc, torch.from_numpy(codes)).numpy()
    assert streamed.shape == full.shape == (1, T * jc.codec.hop)
    assert 0.05 < np.abs(full).max() < 0.99  # a live, unclipped waveform
    np.testing.assert_allclose(streamed, full, atol=ATOL)


@pytest.mark.parametrize("cfg", [
    dict(temperature=0.7, top_k=5, top_p=1.0),
    dict(temperature=1.0, top_k=0, top_p=0.8),
    dict(temperature=1.3, top_k=12, top_p=0.6),
])
def test_filtered_logits_equal(cfg):
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 2.0, (4, 40)).astype(np.float32)
    ref = np.asarray(jsampling.filtered_logits(
        jnp.asarray(logits), jsampling.SamplingConfig(**cfg)))
    got = tsampling.filtered_logits(torch.from_numpy(logits),
                                    tsampling.SamplingConfig(**cfg)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    keep = ~np.isinf(ref)
    np.testing.assert_allclose(got[keep], ref[keep], rtol=1e-6)


def test_sample_token_matches_jax_distribution():
    """4000 draws of one row: total variation from the JAX package's
    filtered softmax stays under 0.05 (about 3x its expected size at this
    count)."""
    cfg = dict(temperature=0.9, top_k=6, top_p=0.95)
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 1.0, (10,)).astype(np.float32)
    probs = np.asarray(jnp.exp(jsampling.filtered_logits(
        jnp.asarray(logits), jsampling.SamplingConfig(**cfg))))
    probs = probs / probs.sum()
    n = 4000
    g = torch.Generator().manual_seed(7)
    draws = tsampling.sample_token(
        torch.from_numpy(np.tile(logits, (n, 1))), g,
        tsampling.SamplingConfig(**cfg)).numpy()
    freq = np.bincount(draws, minlength=10) / n
    assert 0.5 * np.abs(freq - probs).sum() < 0.05
    assert freq[probs == 0].sum() == 0  # filtered tokens are never drawn
    greedy = tsampling.sample_token(torch.from_numpy(logits[None]), None,
                                    tsampling.SamplingConfig(greedy=True))
    assert int(greedy[0]) == int(np.argmax(logits))


def test_grouped_tree_packs_every_linear():
    _, tc = _cfgs()
    params = ttalker.init_talker(tc, 0)
    packed = pack_grouped_tree(params)
    assert set(packed["blocks"]["attn"]["q"]) == {"qg", "sg", "bg"}
    assert set(packed["head"]) == {"qg", "sg", "bg"}
    assert packed["text_emb"] is params["text_emb"]
