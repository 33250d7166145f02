"""The port's code2wav decoder (models/code2wav.py) against the JAX package's
and against transformers' Qwen3OmniMoeCode2Wav: primitives, one-shot
decode, streaming, and the host initialisers, on tiny float32 trees."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu.engine import configs as jcfgs
from qwen3_tts_tpu.models import code2wav as jc2w
from qwen3_tts_tpu.models import codec as jcodec
from qwen3_tts_tpu_torch.engine import configs as tcfgs
from qwen3_tts_tpu_torch.engine.weights import tree_to
from qwen3_tts_tpu_torch.models import code2wav as tc2w
from qwen3_tts_tpu_torch.models import codec as tcodec
from test_code2wav import _import_state_dict, _tiny_cfgs, _torch_model

# float32, same arithmetic in another summation order (and, against
# transformers, another convolution implementation): the tolerances of the
# JAX package's own code2wav tests
RTOL, ATOL = 1e-4, 1e-5


def _cfg():
    """The tiny code2wav decoder geometry of both packages."""
    return jcfgs.tiny_code2wav().code2wav, tcfgs.tiny_code2wav().code2wav


def _live_tree(cfg, seed: int) -> dict:
    """A JAX numpy tree whose snake alphas/betas, layer scales and ConvNeXt
    gammas are perturbed from their init constants, so that every term
    shows in the output."""
    rng = np.random.default_rng(seed)
    tree = jc2w.init_code2wav(cfg, seed=seed)

    def perturb(node, name=""):
        if isinstance(node, dict):
            return {k: perturb(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(perturb(v, name) for v in node)
        if name in ("alpha", "beta", "ls_attn", "ls_mlp", "gamma"):
            return (node + rng.normal(0, 0.2, node.shape)).astype(np.float32)
        return node

    return perturb(tree)


def _codes(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.codebook_size,
                        (B, cfg.num_quantizers, T)).astype(np.int64)


def test_host_init_codec_matches_jax():
    """init_codec on the host draws the JAX package's c2w and spk_proj at
    float32 (the encoder's draws are skipped in its order)."""
    jc = dataclasses.replace(jcfgs.tiny_code2wav(), dtype="float32")
    tc = dataclasses.replace(tcfgs.tiny_code2wav(), dtype="float32")
    ref = jcodec.init_codec(jc, 5)
    got = tcodec.init_codec(tc, 5)
    assert set(got) == {"c2w", "spk_proj"} and set(ref) >= set(got)

    def walk(a, b, path):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, (list, tuple)):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=path)

    walk({k: ref[k] for k in got}, got, "")


def test_primitives_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 6, 37)).astype(np.float32)
    xt = torch.from_numpy(x)
    conv = {"w": rng.normal(0, 0.3, (4, 6, 7)).astype(np.float32),
            "b": rng.normal(0, 0.1, (4,)).astype(np.float32)}
    dw = {"w": rng.normal(0, 0.3, (6, 1, 7)).astype(np.float32),
          "b": rng.normal(0, 0.1, (6,)).astype(np.float32)}
    snake = {"alpha": rng.normal(0, 0.5, 6).astype(np.float32),
             "beta": rng.normal(0, 0.5, 6).astype(np.float32)}
    cases = [
        (lambda m, p, a: m.causal_conv(a, p, dilation=3), conv),
        (lambda m, p, a: m.causal_conv(a, p, groups=6), dw),
        (lambda m, p, a: m.snake_beta(a, p), snake),
    ]
    for k, stride in ((10, 5), (2, 2), (6, 3)):
        tconv = {"w": rng.normal(0, 0.3, (6, 3, k)).astype(np.float32),
                 "b": rng.normal(0, 0.1, (3,)).astype(np.float32)}
        cases.append((lambda m, p, a, s=stride: m.causal_tconv(a, p, stride=s),
                      tconv))
    for fn, p in cases:
        want = np.asarray(fn(jc2w, p, jnp.asarray(x)))
        got = fn(tc2w, tree_to(p, "cpu"), xt).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_convnext_and_pre_transformer_match_jax():
    jcfg, tcfg = _cfg()
    tree = _live_tree(jcfg, 2)
    params = tree_to(tree, "cpu")
    rng = np.random.default_rng(3)
    h = rng.normal(0, 1, (2, jcfg.hidden, 13)).astype(np.float32)
    cnx_j, cnx_t = tree["upsample"][0]["cnx"], params["upsample"][0]["cnx"]
    np.testing.assert_allclose(
        tc2w.convnext_block(torch.from_numpy(h), cnx_t).numpy(),
        np.asarray(jc2w.convnext_block(jnp.asarray(h), cnx_j)),
        rtol=RTOL, atol=ATOL)
    # T past the sliding window (8), so its mask is pinned
    x = rng.normal(0, 1, (2, 20, jcfg.hidden)).astype(np.float32)
    np.testing.assert_allclose(
        tc2w.pre_transformer(params["pre"], torch.from_numpy(x), tcfg).numpy(),
        np.asarray(jc2w.pre_transformer(tree["pre"], jnp.asarray(x), jcfg)),
        rtol=RTOL, atol=ATOL)


def test_decode_matches_jax_and_embeds_the_quantizer_mean():
    jcfg, tcfg = _cfg()
    tree = _live_tree(jcfg, 4)
    params = tree_to(tree, "cpu")
    codes = _codes(jcfg, 2, 12, 5)
    emb = tc2w.embed_codes(params, tcfg, torch.from_numpy(codes)).numpy()
    table = tree["code_emb"]
    want = np.mean([table[codes[:, q] + q * jcfg.codebook_size]
                    for q in range(jcfg.num_quantizers)], axis=0)
    np.testing.assert_allclose(emb, want, rtol=1e-6, atol=1e-7)
    ref = np.asarray(jc2w.code2wav_decode(tree, jcfg, jnp.asarray(codes)))
    got = tc2w.code2wav_decode(params, tcfg, torch.from_numpy(codes)).numpy()
    assert got.shape == ref.shape == (2, 12 * tcfg.total_upsample
                                      - tcfg.startup_samples)
    # a live, unclipped waveform of ~1e-2: 1e-7 is 1e-5 of it
    assert 1e-3 < np.abs(ref).max() < 0.99
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-7)


def test_decode_matches_transformers_code2wav():
    """A tiny random transformers Qwen3OmniMoeCode2Wav's state dict, mapped
    as the JAX package's test maps it: the same waveform."""
    hf_cfg, ours = _tiny_cfgs()
    model = _torch_model(hf_cfg)
    params = tree_to(_import_state_dict(model.state_dict(), ours), "cpu")
    cfg = tcfgs.Code2WavConfig(**dataclasses.asdict(ours))
    codes = torch.from_numpy(_codes(cfg, 2, 12, 5))
    with torch.no_grad():
        want = model(codes).numpy()[:, 0, :]
        got = tc2w.code2wav_decode(params, cfg, codes).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("chunk", [1, 3, 4])
def test_streaming_equals_one_shot_after_the_startup_samples(chunk):
    """The uniform stream: chunk * hop samples a chunk; after dropping the
    startup run-in it equals the one-shot decode beyond the convs'
    receptive field of the start (the margin of the JAX package's
    test_stream_equals_one_shot_beyond_transient)."""
    _, cfg = _cfg()
    params = tree_to(_live_tree(_cfg()[0], 6), "cpu")
    T = 60
    codes = torch.from_numpy(_codes(cfg, 1, T, 7))
    one_shot = tc2w.code2wav_decode(params, cfg, codes).numpy()
    state = tc2w.stream_state_init(cfg, 1)
    pieces = []
    for t in range(0, T, chunk):
        c = codes[:, :, t:t + chunk]
        wav, state = tc2w.code2wav_stream_step(params, cfg, state, c, t)
        assert wav.shape == (1, c.shape[-1] * cfg.total_upsample)
        pieces.append(wav.numpy())
    streamed = np.concatenate(pieces, axis=-1)
    d = cfg.startup_samples
    rates = cfg.upsample_rates
    margin = 12 * int(np.prod(rates)) + 6
    for i in range(len(rates)):
        margin += 6 * (1 + 3 + 9) * int(np.prod(rates[i + 1:]))
    assert one_shot.shape[-1] == streamed.shape[-1] - d
    assert d + margin < streamed.shape[-1] // 2
    np.testing.assert_allclose(streamed[:, d + margin:], one_shot[:, margin:],
                               rtol=1e-5, atol=1e-6)


def test_streaming_matches_jax_streaming():
    """Chunk by chunk, the port's stream step equals the JAX package's
    (uniform variant), state carries included."""
    jcfg, tcfg = _cfg()
    tree = _live_tree(jcfg, 8)
    params = tree_to(tree, "cpu")
    codes = _codes(jcfg, 2, 12, 9)
    jstate = jc2w.stream_state_init(None, jcfg, 2)
    tstate = tc2w.stream_state_init(tcfg, 2)
    for t in range(0, 12, 4):
        piece = codes[:, :, t:t + 4]
        jw, jstate = jc2w.code2wav_stream_step(
            tree, jcfg, jstate, jnp.asarray(piece, jnp.int32), pos=t)
        tw, tstate = tc2w.code2wav_stream_step(
            params, tcfg, tstate, torch.from_numpy(piece), t)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(tstate["pre_k"].numpy(),
                               np.asarray(jstate["pre_k"]), rtol=RTOL, atol=ATOL)


def test_configs_match_jax():
    for name in ("tiny_code2wav", "flagship_code2wav", "tiny_feedback",
                 "flagship_feedback", "flagship_feedback_code2wav"):
        assert dataclasses.asdict(getattr(tcfgs, name)()) == \
            dataclasses.asdict(getattr(jcfgs, name)()), name
    cfg = tcfgs.flagship_code2wav()
    assert cfg.codec.hop == cfg.code2wav.total_upsample == 2000
    assert cfg.code2wav.startup_samples == 1124
    hf = {"hidden_size": 1024, "upsample_rates": [10, 5, 5, 4],
          "upsampling_ratios": [2], "num_key_value_heads": 8}
    assert tcfgs.Code2WavConfig.from_hf_dict(hf) == \
        tcfgs.Code2WavConfig(**dataclasses.asdict(
            jc2w.Code2WavConfig.from_hf_dict(hf)))
