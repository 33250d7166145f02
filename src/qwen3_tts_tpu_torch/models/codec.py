"""The 12 Hz residual-VQ neural codec: decoder (codes -> 24 kHz waveform),
one-shot and streaming; and the codec entry points of both decoder
architectures (``cfg.codec_arch``): ``init_codec``,
``init_codec_stream_state`` and ``decode_codes_streaming`` route a
code2wav config to ``models/code2wav.py``.

Causal 1-D convolutions over ``[B, T, C]`` (the JAX package's layout at the
public functions; weights ``[k, C_in, C_out]``), nearest-repeat upsampling,
and a causal latent transformer so the decoder streams chunk by chunk.

The cloning side, shared by both decoder architectures: the synthetic
waveform encoder (``enc``, ``encode_waveform``), nearest-neighbour residual
VQ onto the decoder's code space (``rvq_quantize``) and the mean-pooled
speaker vector (``speaker_embedding``). A checkpoint's real speech
tokenizer is ``models/speech_tokenizer.py``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..engine.configs import CodecConfig, ModelConfig, torch_dtype
from .code2wav import code2wav_stream_step, init_code2wav, stream_state_init
from .init import DeviceInit, make_init, stack_trees
from .layers import rmsnorm, rope_slice, rope_tables, transformer_block, unstack_layers

Params = dict[str, Any]

MAX_FRAMES = 4096  # RoPE table budget: the per-utterance frame limit


def max_stream_frames(cfg: ModelConfig) -> int:
    """Per-utterance frame budget imposed by the codec's position tables."""
    if cfg.codec_arch == "code2wav":
        return cfg.code2wav.max_positions
    return MAX_FRAMES


# --------------------------------------------------------------------------
# conv primitives
# --------------------------------------------------------------------------

def causal_conv1d(
    x: torch.Tensor,          # [B, T, C_in]
    w: torch.Tensor,          # [k, C_in, C_out]
    b: torch.Tensor | None,   # [C_out]
    *,
    stride: int = 1,
    dilation: int = 1,
    pre_padded: bool = False,
) -> torch.Tensor:
    """Left-padded (causal) 1-D convolution. ``pre_padded``: the caller
    already prepended the ``dilation*(k-1)`` context rows (streaming)."""
    k = w.shape[0]
    pad_left = 0 if pre_padded else dilation * (k - 1)
    xt = F.pad(x.transpose(1, 2), (pad_left, 0))
    out = F.conv1d(xt, w.to(x.dtype).permute(2, 1, 0), stride=stride,
                   dilation=dilation).transpose(1, 2)
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def upsample_repeat(x: torch.Tensor, rate: int) -> torch.Tensor:
    """Nearest-neighbour upsample along T: [B, T, C] -> [B, T*rate, C]."""
    return torch.repeat_interleave(x, rate, dim=1)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


# --------------------------------------------------------------------------
# initialisation
# --------------------------------------------------------------------------

def _conv_init(init, k: int, c_in: int, c_out: int) -> Params:
    return {"w": init.normal((k, c_in, c_out), (2.0 / (k * c_in)) ** 0.5),
            "b": init.zeros(c_out)}


def _resunit_init(init, c: int, k: int) -> Params:
    return {"c1": _conv_init(init, k, c, c), "c2": _conv_init(init, k, c, c)}


def _tf_block_init(init, d: int, heads: int, head_dim: int, ffn: int) -> Params:
    def lin(o, i):
        return {"w": init.normal((o, i), 0.02)}

    q_dim = heads * head_dim
    return {
        "attn": {"q": lin(q_dim, d), "k": lin(q_dim, d), "v": lin(q_dim, d),
                 "o": lin(d, q_dim)},
        "mlp": {"gate": lin(ffn, d), "up": lin(ffn, d), "down": lin(d, ffn)},
        "ln1": init.ones(d),
        "ln2": init.ones(d),
    }


def _init_encoder(init, cc: CodecConfig) -> Params:
    """The cloning-side encoder's tree, drawn in the JAX package's order
    (stages, then in_conv, then proj)."""
    enc_channels = list(reversed(cc.decoder_channels))
    stages = []
    for i, rate in enumerate(reversed(cc.upsample_rates)):
        stages.append({
            "down": _conv_init(init, 2 * rate + 1, enc_channels[i],
                               enc_channels[i + 1]),
            "res": _resunit_init(init, enc_channels[i + 1], cc.decoder_kernel),
        })
    in_conv = _conv_init(init, 7, 1, enc_channels[0])
    return {"in_conv": in_conv, "stages": stages,
            "proj": _conv_init(init, 1, enc_channels[-1], cc.latent_dim),
            "ln": init.ones(cc.latent_dim)}


def init_codec(cfg: ModelConfig, seed: int = 2, device=None,
               encoder: bool = False) -> Params:
    """Random-init codec decoder (``dec`` for the rvq codec, ``c2w`` for
    code2wav) and ``spk_proj`` parameters (see talker.init_talker for
    ``device``). ``encoder`` keeps the cloning encoder's tree (``enc``);
    its values are drawn on the host either way, so ``spk_proj`` gets the
    JAX package's values."""
    cc = cfg.codec
    init = make_init(seed, torch_dtype(cfg), device)
    draw_enc = encoder or not isinstance(init, DeviceInit)
    if cfg.codec_arch == "code2wav":
        # the JAX package draws c2w from its own rng of the same seed
        c2w = init_code2wav(cfg.code2wav, seed, torch_dtype(cfg), device)
        enc = _init_encoder(init, cc) if draw_enc else None
        return {"c2w": c2w, **({"enc": enc} if encoder else {}), "spk_proj": {
            "w": init.normal((cfg.talker.hidden, cc.latent_dim), 0.02)}}
    head_dim = cc.latent_dim // cc.transformer_heads
    ffn = 4 * cc.latent_dim
    n_res = cc.num_codebooks - 1

    stages = []
    for i, rate in enumerate(cc.upsample_rates):
        c_in, c_out = cc.decoder_channels[i], cc.decoder_channels[i + 1]
        stages.append({
            "up": _conv_init(init, 2 * rate + 1, c_in, c_out),
            "res": _resunit_init(init, c_out, cc.decoder_kernel),
        })
    dec = {
        "cb0_emb": init.normal((cc.codebook_size, cc.latent_dim), 0.02),
        "res_emb": init.normal(
            (n_res, cc.residual_codebook_size, cc.latent_dim), 0.02),
        "tf_blocks": stack_trees([
            _tf_block_init(init, cc.latent_dim, cc.transformer_heads,
                           head_dim, ffn)
            for _ in range(cc.n_transformer_layers)
        ]),
        "ln": init.ones(cc.latent_dim),
        "in_proj": _conv_init(init, 1, cc.latent_dim, cc.decoder_channels[0]),
        "stages": stages,
        "out_conv": _conv_init(init, cc.decoder_kernel,
                               cc.decoder_channels[-1], 1),
    }
    enc = _init_encoder(init, cc) if draw_enc else None
    return {
        "dec": dec,
        **({"enc": enc} if encoder else {}),
        "spk_proj": {"w": init.normal((cfg.talker.hidden, cc.latent_dim), 0.02)},
    }


# --------------------------------------------------------------------------
# decoder
# --------------------------------------------------------------------------

def codes_to_latent(dec: Params, cc: CodecConfig, codes: torch.Tensor):
    """RVQ de-embedding: codes [B, Q, T] -> latent [B, T, D] (sum over books)."""
    latent = dec["cb0_emb"][codes[:, 0, :]]
    for qb in range(cc.num_codebooks - 1):
        latent = latent + dec["res_emb"][qb][codes[:, qb + 1, :]]
    return latent


def _latent_transformer(dec: Params, cc: CodecConfig, latent: torch.Tensor,
                        pos0: int) -> torch.Tensor:
    """Causal self-attention over frames at absolute positions pos0..pos0+T."""
    B, T, D = latent.shape
    head_dim = D // cc.transformer_heads
    cos_t, sin_t = rope_tables(MAX_FRAMES, head_dim, 10_000.0, latent.device)
    cos, sin = rope_slice(cos_t, sin_t, pos0, T)
    x = latent
    for bp in unstack_layers(dec["tf_blocks"]):
        zeros = torch.zeros((B, T, cc.transformer_heads, head_dim),
                            dtype=x.dtype, device=x.device)
        x = transformer_block(
            bp, x, cos=cos, sin=sin, cache_k=zeros, cache_v=zeros.clone(),
            pos=0, n_heads=cc.transformer_heads,
            n_kv_heads=cc.transformer_heads, head_dim=head_dim, rms_eps=1e-6,
            qk_norm=False,
        )
    return rmsnorm(x, dec["ln"], 1e-6)


def _conv_stack(dec: Params, cc: CodecConfig, latent: torch.Tensor,
                state: dict | None = None):
    """The decoder conv stack: latent [B, T, D] -> waveform [B, T*hop] f32.

    Shared by the one-shot and streaming decodes, so streamed chunks equal
    the one-shot output. ``state`` carries each conv's left input context
    at that conv's own rate; streaming returns ``(wav, new_state)``."""
    streaming = state is not None
    new_state: dict = {}

    def conv(name: str, x, p, dilation: int = 1):
        if not streaming:
            return causal_conv1d(x, p["w"], p["b"], dilation=dilation)
        ctx = state[name].to(x.dtype)
        xin = torch.cat([ctx, x], dim=1)
        new_state[name] = xin[:, xin.shape[1] - ctx.shape[1]:]
        return causal_conv1d(xin, p["w"], p["b"], dilation=dilation,
                             pre_padded=True)

    x = causal_conv1d(latent, dec["in_proj"]["w"], dec["in_proj"]["b"])  # k=1
    for i, rate in enumerate(cc.upsample_rates):
        stage = dec["stages"][i]
        x = upsample_repeat(x, rate)
        x = conv(f"s{i}_up", x, stage["up"])
        h = conv(f"s{i}_r1", _gelu(x), stage["res"]["c1"], dilation=1)
        h = conv(f"s{i}_r2", _gelu(h), stage["res"]["c2"], dilation=3)
        x = x + h
    wav = conv("out", _gelu(x), dec["out_conv"])
    wav = torch.tanh(wav[..., 0].float())
    return (wav, new_state) if streaming else wav


def decode_codes(params: Params, cfg: ModelConfig, codes: torch.Tensor,
                 pos0: int = 0) -> torch.Tensor:
    """One-shot decode: codes [B, Q, T] -> waveform [B, T * hop] f32."""
    cc = cfg.codec
    dec = params["dec"]
    latent = codes_to_latent(dec, cc, codes)
    latent = _latent_transformer(dec, cc, latent, pos0)
    return _conv_stack(dec, cc, latent)


# --------------------------------------------------------------------------
# incremental (streaming) decoder: a KV-cached latent transformer plus each
# conv's carried left context, so each chunk decodes only its new frames and
# the streamed chunks concatenate to the one-shot output
# --------------------------------------------------------------------------

def conv_state_spec(cc: CodecConfig) -> dict[str, tuple[int, int]]:
    """Per-conv streaming context shapes: name -> (rows, channels), rows =
    dilation*(k-1) input rows at that conv's own rate."""
    spec: dict[str, tuple[int, int]] = {}
    kd = cc.decoder_kernel - 1
    for i, rate in enumerate(cc.upsample_rates):
        spec[f"s{i}_up"] = (2 * rate, cc.decoder_channels[i])
        spec[f"s{i}_r1"] = (kd, cc.decoder_channels[i + 1])
        spec[f"s{i}_r2"] = (3 * kd, cc.decoder_channels[i + 1])
    spec["out"] = (kd, cc.decoder_channels[-1])
    return spec


def init_conv_state(cc: CodecConfig, batch: int, dtype=torch.bfloat16,
                    device="cpu") -> dict:
    """Zeroed per-conv left contexts (== causal zero padding at start)."""
    return {name: torch.zeros((batch, rows, ch), dtype=dtype, device=device)
            for name, (rows, ch) in conv_state_spec(cc).items()}


def init_codec_stream_state(cfg: ModelConfig, batch: int, *,
                            dtype=torch.bfloat16, device="cpu") -> dict:
    """Streaming state: latent-transformer KV caches (MAX_FRAMES long) +
    zeroed per-conv left contexts (== causal zero padding at start); for
    code2wav, ``code2wav.stream_state_init``."""
    if cfg.codec_arch == "code2wav":
        return stream_state_init(cfg.code2wav, batch, dtype=dtype,
                                 device=device)
    cc = cfg.codec
    head_dim = cc.latent_dim // cc.transformer_heads
    cache_shape = (cc.n_transformer_layers, batch, MAX_FRAMES,
                   cc.transformer_heads, head_dim)
    return {
        "tf_k": torch.zeros(cache_shape, dtype=dtype, device=device),
        "tf_v": torch.zeros(cache_shape, dtype=dtype, device=device),
        "conv": init_conv_state(cc, batch, dtype, device),
    }


def decode_codes_streaming(params: Params, cfg: ModelConfig,
                           codes_new: torch.Tensor, state: dict, pos):
    """Decode ``chunk`` new frames (codes [B, Q, chunk]) with full left
    context; returns (wav_chunk [B, chunk*hop] f32, new_state). ``pos``:
    frames decoded before this chunk, an int or a [B] tensor (serving: each
    row at its own frame). The KV caches in ``state`` are updated in place.

    code2wav configs take ``code2wav_stream_step`` (the uniform-shape
    variant): every chunk emits chunk*hop samples, the stream's first
    ``cfg.code2wav.startup_samples`` being the edge run-in that the
    one-shot decode trims (Generator.stream drops them)."""
    if cfg.codec_arch == "code2wav":
        return code2wav_stream_step(params["c2w"], cfg.code2wav, state,
                                    codes_new, pos)
    cc = cfg.codec
    dec = params["dec"]
    T = codes_new.shape[2]
    head_dim = cc.latent_dim // cc.transformer_heads
    latent = codes_to_latent(dec, cc, codes_new)          # [B, T, D]
    cos_t, sin_t = rope_tables(MAX_FRAMES, head_dim, 10_000.0, latent.device)
    cos, sin = rope_slice(cos_t, sin_t, pos, T)
    x = latent
    for i, bp in enumerate(unstack_layers(dec["tf_blocks"])):
        x = transformer_block(
            bp, x, cos=cos, sin=sin, cache_k=state["tf_k"][i],
            cache_v=state["tf_v"][i], pos=pos,
            n_heads=cc.transformer_heads, n_kv_heads=cc.transformer_heads,
            head_dim=head_dim, rms_eps=1e-6, qk_norm=False,
        )
    new_lat = rmsnorm(x, dec["ln"], 1e-6)
    wav, conv_state = _conv_stack(dec, cc, new_lat, state["conv"])
    return wav, {"tf_k": state["tf_k"], "tf_v": state["tf_v"], "conv": conv_state}


# --------------------------------------------------------------------------
# encoder + RVQ (the voice-cloning acoustic prompt)
# --------------------------------------------------------------------------

def _res_unit(p: Params, x: torch.Tensor, dilations=(1, 3)) -> torch.Tensor:
    h = causal_conv1d(_gelu(x), p["c1"]["w"], p["c1"]["b"],
                      dilation=dilations[0])
    h = causal_conv1d(_gelu(h), p["c2"]["w"], p["c2"]["b"],
                      dilation=dilations[1])
    return x + h


def encode_waveform(params: Params, cfg: ModelConfig,
                    wav: torch.Tensor) -> torch.Tensor:
    """Waveform [B, N] -> latents [B, T, D] at the codec frame rate (N a
    multiple of ``cfg.codec.hop``; callers pad with zeros). Runs in the
    encoder weights' dtype (the JAX package reads it from ``dec``, which a
    code2wav tree lacks)."""
    cc = cfg.codec
    enc = params["enc"]
    x = wav[..., None].to(enc["in_conv"]["w"].dtype)               # [B, N, 1]
    x = causal_conv1d(x, enc["in_conv"]["w"], enc["in_conv"]["b"])
    for stage, rate in zip(enc["stages"], reversed(cc.upsample_rates)):
        x = causal_conv1d(x, stage["down"]["w"], stage["down"]["b"],
                          stride=rate)
        x = _res_unit(stage["res"], x)
    latent = causal_conv1d(x, enc["proj"]["w"], enc["proj"]["b"])
    return rmsnorm(latent, enc["ln"], 1e-6)


def _nearest(resid: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """argmin_v |r - e_v|^2 as argmin_v (|e_v|^2 - 2 r.e_v), in f32 (the
    first index on ties): resid [B, T, D], table [V, D] -> [B, T]."""
    tf = table.float()
    dots = torch.einsum("btd,vd->btv", resid.float(), tf)
    norms = torch.sum(tf * tf, dim=-1)
    return torch.argmin(norms[None, None, :] - 2.0 * dots, dim=-1)


def rvq_quantize(params: Params, cfg: ModelConfig,
                 latent: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour residual VQ: latent [B, T, D] -> codes [B, Q, T]
    (int64). code2wav fits its embedding MEAN: the target Q*latent is
    residual-quantized against the per-quantizer slices of its table."""
    if cfg.codec_arch == "code2wav":
        c2w = cfg.code2wav
        tables = params["c2w"]["code_emb"].reshape(
            c2w.num_quantizers, c2w.codebook_size, c2w.hidden)
        resid = latent.float() * c2w.num_quantizers
        codes = []
        for q in range(c2w.num_quantizers):
            idx = _nearest(resid, tables[q])
            resid = resid - tables[q][idx]
            codes.append(idx)
        return torch.stack(codes, dim=1)
    dec = params["dec"]
    idx = _nearest(latent, dec["cb0_emb"])
    resid = latent - dec["cb0_emb"][idx]
    codes = [idx]
    for qb in range(cfg.codec.num_codebooks - 1):
        table = dec["res_emb"][qb]
        idx = _nearest(resid, table)
        resid = resid - table[idx]
        codes.append(idx)
    return torch.stack(codes, dim=1)


def speaker_embedding(params: Params, cfg: ModelConfig, latent: torch.Tensor,
                      n_frames: int | None = None) -> torch.Tensor:
    """Mean-pooled encoder latent -> talker-hidden speaker vector
    [B, D_talker]. ``n_frames``: divide by the real frame count instead of
    the (bucket-padded) latent length; callers zero the padding rows."""
    summed = torch.sum(latent.float(), dim=1)
    pooled = summed / float(n_frames if n_frames is not None
                            else latent.shape[1])
    w = params["spk_proj"]["w"].float()
    return (pooled @ w.T).to(latent.dtype)
