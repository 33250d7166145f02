"""Code2Wav: the published Qwen3 codec-decoder family, in PyTorch.

The port of the JAX package's ``models/code2wav.py`` (transformers
``Qwen3OmniMoeCode2Wav``; Qwen3-TTS-12Hz uses the same decoder family at
other config values):

    codes [B, Q, T]
      -> per-quantizer offset embedding, MEAN over the Q codebooks  [B, T, H]
      -> pre-transformer: N layers of sliding-window causal attention
         (RoPE, no qk-norm) + SwiGLU, each residual scaled by a learned
         per-channel LayerScale; final RMSNorm
      -> upsampling stages: transposed conv + ConvNeXt block per
         ``upsampling_ratio``
      -> decoder: blocks of SnakeBeta + causal transposed conv (kernel 2r,
         stride r) + three dilated (1, 3, 9) residual units; final SnakeBeta
         + conv to mono
      -> clamp to [-1, 1]

Convolutions run in torch's own ``[B, C, T]`` layout with the torch weight
layouts (conv ``[out, in/groups, k]``, transposed conv ``[in, out, k]``),
so a checkpoint's state dict maps over unchanged. The attention and MLP
projections go through ``ops.linear`` (dense weights in every tree this
package builds). Everything here is plain torch: the reference's convs and
attention are XLA ops, not Pallas kernels.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..engine.configs import Code2WavConfig
from ..ops.linear import linear
from .init import make_init, stack_trees
from .layers import (
    apply_rope, rmsnorm, rope_slice, rope_tables, swiglu_mlp, unstack_layers,
)

Params = dict[str, Any]

DILATIONS = (1, 3, 9)  # the residual units of each decoder block


# --------------------------------------------------------------------------
# init (synthetic weights; checkpoints import into the same layout)
# --------------------------------------------------------------------------

def init_code2wav(cfg: Code2WavConfig, seed: int = 3, dtype=torch.float32,
                  device=None) -> Params:
    """Random-init decoder parameters. ``device=None``: numpy draws in the
    JAX package's order on the host (equal values at float32); a device:
    values made there (models/init.py)."""
    init = make_init(seed, dtype, device)
    H, D = cfg.hidden, cfg.decoder_dim
    q_dim = cfg.n_heads * cfg.head_dim
    kv_dim = cfg.n_kv_heads * cfg.head_dim

    def dense(out_dim, in_dim):
        return {"w": init.normal((out_dim, in_dim), 0.02)}

    def conv(out_ch, in_ch, k):
        return {"w": init.normal((out_ch, in_ch, k), 0.05),
                "b": init.normal((out_ch,), 0.01)}

    def tconv(in_ch, out_ch, k):
        return {"w": init.normal((in_ch, out_ch, k), 0.05),
                "b": init.normal((out_ch,), 0.01)}

    def snake(dim):  # alpha = beta = 0: exp(0) = 1 at init
        return {"alpha": init.zeros(dim), "beta": init.zeros(dim)}

    def block():
        return {
            "attn": {"q": dense(q_dim, H), "k": dense(kv_dim, H),
                     "v": dense(kv_dim, H), "o": dense(H, q_dim)},
            "mlp": {"gate": dense(cfg.ffn, H), "up": dense(cfg.ffn, H),
                    "down": dense(H, cfg.ffn)},
            "ln1": init.ones(H),
            "ln2": init.ones(H),
            "ls_attn": init.full(H, cfg.layer_scale_init),
            "ls_mlp": init.full(H, cfg.layer_scale_init),
        }

    def convnext(dim):
        return {
            "dw": conv(dim, 1, 7),  # depthwise: groups == dim
            "ln_w": init.ones(dim),
            "ln_b": init.zeros(dim),
            "pw1": {"w": init.normal((4 * dim, dim), 0.02),
                    "b": init.zeros(4 * dim)},
            "pw2": {"w": init.normal((dim, 4 * dim), 0.02),
                    "b": init.zeros(dim)},
            "gamma": init.full(dim, 1e-6),
        }

    def res_unit(dim):
        return {"a1": snake(dim), "c1": conv(dim, dim, 7),
                "a2": snake(dim), "c2": conv(dim, dim, 1)}

    # the JAX package draws the decoder blocks first, then the rest in tree
    # order
    dec_blocks = []
    for i, r in enumerate(cfg.upsample_rates):
        in_dim, out_dim = D // 2**i, D // 2 ** (i + 1)
        dec_blocks.append({
            "snake": snake(in_dim),
            "tconv": tconv(in_dim, out_dim, 2 * r),
            "res": tuple(res_unit(out_dim) for _ in DILATIONS),
        })
    out_dim = D // 2 ** len(cfg.upsample_rates)
    code_emb = init.normal((cfg.codebook_size * cfg.num_quantizers, H), 0.02)
    pre = {"blocks": stack_trees([block() for _ in range(cfg.n_layers)]),
           "ln_f": init.ones(H)}
    upsample = tuple({"tconv": tconv(H, H, r), "cnx": convnext(H)}
                     for r in cfg.upsampling_ratios)
    conv_in = conv(D, H, 7)
    return {
        "code_emb": code_emb,
        "pre": pre,
        "upsample": upsample,
        "decoder": {
            "conv_in": conv_in,
            "blocks": tuple(dec_blocks),
            "snake_out": snake(out_dim),
            "conv_out": conv(1, out_dim, 7),
        },
    }


# --------------------------------------------------------------------------
# primitives ([B, C, T])
# --------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, p: Params, *, dilation: int = 1,
                stride: int = 1, groups: int = 1) -> torch.Tensor:
    """Left-padded causal Conv1d (Qwen3OmniMoeCausalConvNet: pad left by
    (k_eff - stride), right by the partial-frame remainder)."""
    k = p["w"].shape[-1]
    k_eff = (k - 1) * dilation + 1
    padding = k_eff - stride
    length = x.shape[-1]
    n_frames = -(-(length - k_eff + padding) // stride) + 1
    extra = (n_frames - 1) * stride + (k_eff - padding) - length
    y = F.conv1d(F.pad(x, (padding, extra)), p["w"].to(x.dtype),
                 stride=stride, dilation=dilation, groups=groups)
    return y + p["b"].to(x.dtype)[None, :, None]


def causal_tconv(x: torch.Tensor, p: Params, *, stride: int) -> torch.Tensor:
    """ConvTranspose1d + the symmetric (k - stride) trim
    (Qwen3OmniMoeCausalTransConvNet)."""
    k = p["w"].shape[-1]
    y = F.conv_transpose1d(x, p["w"].to(x.dtype), stride=stride)
    y = y + p["b"].to(x.dtype)[None, :, None]
    pad = k - stride
    return y[..., pad:y.shape[-1] - pad] if pad else y


def snake_beta(x: torch.Tensor, p: Params) -> torch.Tensor:
    """SnakeBeta: x + (1/e^beta) * sin^2(x * e^alpha), per channel, in f32."""
    xf = x.float()
    alpha = torch.exp(p["alpha"].float())[None, :, None]
    beta = torch.exp(p["beta"].float())[None, :, None]
    return (xf + (1.0 / (beta + 1e-9)) * torch.sin(xf * alpha) ** 2).to(x.dtype)


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Channels-last LayerNorm (torch nn.LayerNorm semantics, f32 inner)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def _convnext_tail(x: torch.Tensor, h: torch.Tensor, p: Params) -> torch.Tensor:
    """A ConvNeXt block after its depthwise conv ``h``: LN -> pw1 -> exact
    GELU -> pw2 -> gamma scale, added to the block's input ``x``."""
    h = _layer_norm(h.transpose(1, 2), p["ln_w"], p["ln_b"])   # [B, T, C]
    h = linear(h, {"w": p["pw1"]["w"]}) + p["pw1"]["b"].to(x.dtype)
    h = F.gelu(h, approximate="none")
    h = linear(h, {"w": p["pw2"]["w"]}) + p["pw2"]["b"].to(x.dtype)
    h = h * p["gamma"].to(x.dtype)
    return x + h.transpose(1, 2)


def convnext_block(x: torch.Tensor, p: Params) -> torch.Tensor:
    """ConvNeXt block: depthwise causal conv k7 -> LN -> pw1 -> GELU
    (exact) -> pw2 -> gamma, residual. x is [B, C, T]."""
    return _convnext_tail(x, causal_conv(x, p["dw"], groups=x.shape[1]), p)


# --------------------------------------------------------------------------
# pre-transformer (sliding-window causal, LayerScale residuals)
# --------------------------------------------------------------------------

def _pre_block(bp: Params, h: torch.Tensor, cfg: Code2WavConfig, cos, sin,
               past_k, past_v, allowed: torch.Tensor):
    """One layer over h [B, C, H]: queries at the C new positions attend
    over keys [past | new] where ``allowed`` ([C, P + C], or per row
    [B, 1, 1, C, P + C]); returns (h, keys, values)."""
    B, C, _ = h.shape
    hd = cfg.head_dim
    g = cfg.n_heads // cfg.n_kv_heads
    hn = rmsnorm(h, bp["ln1"], cfg.rms_eps)
    q = linear(hn, bp["attn"]["q"]).reshape(B, C, cfg.n_heads, hd)
    k = linear(hn, bp["attn"]["k"]).reshape(B, C, cfg.n_kv_heads, hd)
    v = linear(hn, bp["attn"]["v"]).reshape(B, C, cfg.n_kv_heads, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    keys = k if past_k is None else torch.cat([past_k.to(k.dtype), k], dim=1)
    vals = v if past_v is None else torch.cat([past_v.to(v.dtype), v], dim=1)
    qg = q.reshape(B, C, cfg.n_kv_heads, g, hd)
    scores = torch.einsum("bthgd,bshd->bhgts", qg.float(), keys.float())
    scores = (scores * hd ** -0.5).masked_fill(~allowed, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(vals.dtype)
    ctx = torch.einsum("bhgts,bshd->bthgd", probs.float(),
                       vals.float()).to(h.dtype)
    a = linear(ctx.reshape(B, C, cfg.n_heads * hd), bp["attn"]["o"])
    h = h + a * bp["ls_attn"].to(h.dtype)
    m = swiglu_mlp(bp["mlp"], rmsnorm(h, bp["ln2"], cfg.rms_eps))
    return h + m * bp["ls_mlp"].to(h.dtype), keys, vals


def pre_transformer(params: Params, x: torch.Tensor,
                    cfg: Code2WavConfig) -> torch.Tensor:
    """The pre-transformer over a whole sequence x [B, T, H]."""
    T = x.shape[1]
    cos_t, sin_t = rope_tables(T, cfg.head_dim, cfg.rope_theta, x.device)
    i = torch.arange(T, device=x.device)
    allowed = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - cfg.sliding_window)
    for bp in unstack_layers(params["blocks"]):
        x, _, _ = _pre_block(bp, x, cfg, cos_t, sin_t, None, None, allowed)
    return rmsnorm(x, params["ln_f"], cfg.rms_eps)


def embed_codes(params: Params, cfg: Code2WavConfig,
                codes: torch.Tensor) -> torch.Tensor:
    """codes [B, Q, T] -> the mean of the quantizers' embeddings [B, T, H]."""
    offset = (torch.arange(cfg.num_quantizers, device=codes.device)
              * cfg.codebook_size)[None, :, None]
    return params["code_emb"][codes + offset].mean(dim=1)


def code2wav_decode(params: Params, cfg: Code2WavConfig,
                    codes: torch.Tensor) -> torch.Tensor:
    """One-shot decode: codes [B, Q, T] -> waveform [B, T * total_upsample
    - startup_samples] in [-1, 1] (Qwen3OmniMoeCode2Wav.forward)."""
    h = pre_transformer(params["pre"], embed_codes(params, cfg, codes), cfg)
    h = h.transpose(1, 2)                                   # [B, H, T]
    for i, stage in enumerate(params["upsample"]):
        h = causal_tconv(h, stage["tconv"], stride=cfg.upsampling_ratios[i])
        h = convnext_block(h, stage["cnx"])
    dec = params["decoder"]
    w = causal_conv(h, dec["conv_in"])
    for i, blk in enumerate(dec["blocks"]):
        w = snake_beta(w, blk["snake"])
        w = causal_tconv(w, blk["tconv"], stride=cfg.upsample_rates[i])
        for ru, dilation in zip(blk["res"], DILATIONS):
            r = w
            w = snake_beta(w, ru["a1"])
            w = causal_conv(w, ru["c1"], dilation=dilation)
            w = snake_beta(w, ru["a2"])
            w = causal_conv(w, ru["c2"])
            w = w + r
    w = snake_beta(w, dec["snake_out"])
    w = causal_conv(w, dec["conv_out"])
    return torch.clamp(w[:, 0, :], -1.0, 1.0)


# --------------------------------------------------------------------------
# streaming decode, the uniform-shape variant: every chunk of C frames
# emits C * total_upsample samples, and the stream's first
# ``startup_samples`` are the edge run-in that the one-shot decode trims
# (the caller drops them once per utterance). Each stateful op carries what
# the one-shot computation sees to its left:
#   - stride-1 causal convs carry their left input context (zeros at the
#     start, the causal padding);
#   - each strided transposed conv carries an overlap-add tail of
#     (kernel - stride) raw samples;
#   - the pre-transformer keeps the last (sliding_window - 1) keys and
#     values of each layer, everything older being masked anyway.
# --------------------------------------------------------------------------

def stream_state_init(cfg: Code2WavConfig, batch: int, *,
                      dtype=torch.float32, device="cpu") -> Params:
    """Zero streaming state for ``batch`` streams (the JAX package's layout:
    every conv carry under ``"conv"``, the window caches beside it)."""
    H, D = cfg.hidden, cfg.decoder_dim
    P = cfg.sliding_window - 1

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def conv_ctx(ch, k, dilation=1):
        return zeros(batch, ch, (k - 1) * dilation)

    dec_blocks = []
    for i, r in enumerate(cfg.upsample_rates):
        out_dim = D // 2 ** (i + 1)
        dec_blocks.append({
            "tconv_tail": zeros(batch, out_dim, r),
            "res": tuple({"c1": conv_ctx(out_dim, 7, d)} for d in DILATIONS),
        })
    kv_shape = (cfg.n_layers, batch, P, cfg.n_kv_heads, cfg.head_dim)
    return {
        "pre_k": zeros(*kv_shape),
        "pre_v": zeros(*kv_shape),
        "conv": {
            "up": tuple({"dw": conv_ctx(H, 7)} for _ in cfg.upsampling_ratios),
            "dec": {
                "conv_in": conv_ctx(H, 7),
                "blocks": tuple(dec_blocks),
                "conv_out": conv_ctx(D // 2 ** len(cfg.upsample_rates), 7),
            },
        },
    }


def _conv_stream(x: torch.Tensor, p: Params, ctx: torch.Tensor, *,
                 dilation: int = 1, groups: int = 1):
    """Stride-1 causal conv over [carried context | new samples]: returns
    (y over the new samples, the updated context)."""
    full = torch.cat([ctx.to(x.dtype), x], dim=-1)
    y = F.conv1d(full, p["w"].to(x.dtype), dilation=dilation, groups=groups)
    y = y + p["b"].to(x.dtype)[None, :, None]
    rf = ctx.shape[-1]
    return y, (full[..., full.shape[-1] - rf:] if rf else ctx)


def _tconv_stream(x: torch.Tensor, p: Params, tail: torch.Tensor, *,
                  stride: int):
    """Streaming transposed conv with an overlap-add carry: the raw output
    of c frames covers c * stride + r samples (r = kernel - stride); the
    first r overlap the carried tail, and the last r become the next tail.
    The bias is added once, at emission (a bias in the carried tail would
    count twice). Returns (c * stride samples, the new tail)."""
    k = p["w"].shape[-1]
    r = k - stride
    n = x.shape[-1] * stride
    raw = F.conv_transpose1d(x, p["w"].to(x.dtype), stride=stride)
    b = p["b"].to(x.dtype)[None, :, None]
    if r == 0:
        return raw + b, tail
    head = raw[..., :r] + tail.to(x.dtype)
    emit = torch.cat([head, raw[..., r:n]], dim=-1)
    return emit + b, raw[..., n:]


def _pre_transformer_stream(params: Params, x: torch.Tensor, pos,
                            past_k: torch.Tensor, past_v: torch.Tensor,
                            cfg: Code2WavConfig):
    """The pre-transformer over a chunk x [B, C, H] at absolute frames
    pos..pos+C (``pos`` an int, or a [B] tensor: each row at its own
    frame): queries attend over [the last W-1 cached | new] with the
    absolute-position sliding mask. Returns (h, new keys, new values)."""
    C = x.shape[1]
    P = cfg.sliding_window - 1
    cos_t, sin_t = rope_tables(cfg.max_positions, cfg.head_dim,
                               cfg.rope_theta, x.device)
    cos, sin = rope_slice(cos_t, sin_t, pos, C)
    dev = x.device
    new_pos = torch.arange(C, device=dev)
    old_pos = torch.arange(P, device=dev) - P
    if isinstance(pos, torch.Tensor):
        q_pos = (pos[:, None] + new_pos[None, :])[:, :, None]      # [B, C, 1]
        key_pos = (pos[:, None] + torch.cat([old_pos, new_pos])[None, :]
                   )[:, None, :]                                    # [B, 1, P+C]
    else:
        q_pos = (pos + new_pos)[:, None]                           # [C, 1]
        key_pos = (pos + torch.cat([old_pos, new_pos]))[None, :]   # [1, P+C]
    allowed = ((key_pos <= q_pos) & (key_pos > q_pos - cfg.sliding_window)
               & (key_pos >= 0))
    if allowed.dim() == 3:  # per row: broadcast over heads and groups
        allowed = allowed[:, None, None]
    new_k, new_v = [], []
    for bp, pk, pv in zip(unstack_layers(params["blocks"]), past_k, past_v):
        x, keys, vals = _pre_block(bp, x, cfg, cos, sin, pk, pv, allowed)
        new_k.append(keys[:, keys.shape[1] - P:])
        new_v.append(vals[:, vals.shape[1] - P:])
    h = rmsnorm(x, params["ln_f"], cfg.rms_eps)
    return h, torch.stack(new_k).to(past_k.dtype), torch.stack(new_v).to(past_v.dtype)


def code2wav_stream_step(params: Params, cfg: Code2WavConfig, state: Params,
                         codes: torch.Tensor, pos):
    """Decode one chunk of codes [B, Q, C] at frames pos..pos+C (``pos``
    an int or a [B] tensor); returns
    (wav [B, C * total_upsample], the new state). Concatenated chunks
    equal ``code2wav_decode`` of the whole sequence after the first
    ``startup_samples`` (and beyond the convs' receptive field of the
    start), for any chunking."""
    h = embed_codes(params, cfg, codes)                      # [B, C, H]
    h, new_k, new_v = _pre_transformer_stream(
        params["pre"], h, pos, state["pre_k"], state["pre_v"], cfg)
    h = h.transpose(1, 2)                                    # [B, H, C]

    new_up = []
    for i, (stage, st) in enumerate(zip(params["upsample"],
                                        state["conv"]["up"])):
        # kernel == stride: the transposed conv carries nothing
        h, _ = _tconv_stream(h, stage["tconv"], h[..., :0],
                             stride=cfg.upsampling_ratios[i])
        d, dw_ctx = _conv_stream(h, stage["cnx"]["dw"], st["dw"],
                                 groups=h.shape[1])
        h = _convnext_tail(h, d, stage["cnx"])
        new_up.append({"dw": dw_ctx})

    dec = params["decoder"]
    dst = state["conv"]["dec"]
    w, ci_ctx = _conv_stream(h, dec["conv_in"], dst["conv_in"])
    new_blocks = []
    for i, (blk, bst) in enumerate(zip(dec["blocks"], dst["blocks"])):
        w = snake_beta(w, blk["snake"])
        w, tail = _tconv_stream(w, blk["tconv"], bst["tconv_tail"],
                                stride=cfg.upsample_rates[i])
        new_res = []
        for ru, rs, dilation in zip(blk["res"], bst["res"], DILATIONS):
            r = w
            w = snake_beta(w, ru["a1"])
            w, c1 = _conv_stream(w, ru["c1"], rs["c1"], dilation=dilation)
            w = snake_beta(w, ru["a2"])
            w = causal_conv(w, ru["c2"])  # k = 1: stateless
            w = w + r
            new_res.append({"c1": c1})
        new_blocks.append({"tconv_tail": tail, "res": tuple(new_res)})
    w = snake_beta(w, dec["snake_out"])
    w, co_ctx = _conv_stream(w, dec["conv_out"], dst["conv_out"])
    wav = torch.clamp(w[:, 0, :], -1.0, 1.0)
    return wav, {
        "pre_k": new_k,
        "pre_v": new_v,
        "conv": {"up": tuple(new_up),
                 "dec": {"conv_in": ci_ctx, "blocks": tuple(new_blocks),
                         "conv_out": co_ctx}},
    }
