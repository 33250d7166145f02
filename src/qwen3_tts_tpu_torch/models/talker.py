"""The talker: a Qwen3-style autoregressive transformer emitting one
codebook-0 codec token per 12 Hz frame.

Layers are stacked along a leading ``L`` axis in the parameter tree (the
JAX package's layout) and driven by a Python loop; callers on the hot path
pass ``blocks`` pre-split into a list of per-layer dicts
(``layers.unstack_layers``). Multi-token prediction
(``frames_per_step > 1``): the ``mtp`` subtree merges one step's frame
embeddings into the next talker input and runs a small SwiGLU block that
maps (hidden, previous frame's embedding) to the next frame's hidden,
scored by the shared codec head.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..engine.configs import ModelConfig, TalkerConfig, torch_dtype
from ..ops.linear import linear
from .init import make_init, stack_trees
from .layers import rmsnorm, rope_slice, transformer_block, unstack_layers

Params = dict[str, Any]


def init_talker(cfg: ModelConfig, seed: int = 0, device=None,
                keep=None) -> Params:
    """Random-init talker parameters with the production tree layout.

    ``device=None``: numpy draws in the JAX package's order on the host
    (equal values at float32); a device: fast synthetic values made there
    (models/init.py). ``keep(i, block)`` (``parallel.sharding.
    layer_keeper``) cuts layer i's block tree as it is drawn, or drops it
    (None); the draws are the same either way."""
    t = cfg.talker
    init = make_init(seed, torch_dtype(cfg), device)
    qz = dict(quantize=cfg.quant.enabled, group_size=cfg.quant.group_size,
              bits=cfg.quant.bits)

    def block() -> Params:
        return {
            "attn": {
                "q": init.linear(t.q_dim, t.hidden, **qz),
                "k": init.linear(t.kv_dim, t.hidden, **qz),
                "v": init.linear(t.kv_dim, t.hidden, **qz),
                "o": init.linear(t.hidden, t.q_dim, **qz),
                "q_norm": init.ones(t.head_dim),
                "k_norm": init.ones(t.head_dim),
            },
            "mlp": {
                "gate": init.linear(t.ffn, t.hidden, **qz),
                "up": init.linear(t.ffn, t.hidden, **qz),
                "down": init.linear(t.hidden, t.ffn, **qz),
            },
            "ln1": init.ones(t.hidden),
            "ln2": init.ones(t.hidden),
        }

    params: Params = {
        "text_emb": init.normal((t.vocab_size, t.hidden), 0.02),
        "codec_emb": init.normal((t.codec_vocab, t.hidden), 0.02),
        "spk_emb": init.normal((t.n_speakers, t.hidden), 0.02),
        "blocks": stack_trees(_layers(block, t.n_layers, keep)),
        "ln_f": init.ones(t.hidden),
        "head": init.linear(t.codec_vocab, t.hidden, **qz),
    }
    if t.frames_per_step > 1:
        # quantized like the rest of the tree: int8 heads reach the kernels
        params["mtp"] = _init_mtp(init, t, qz)
    return params


def _layers(block, n: int, keep) -> list:
    out = []
    for i in range(n):
        b = block() if keep is None else keep(i, block())
        if b is not None:
            out.append(b)
    return out


def _init_mtp(init, t: TalkerConfig, qz: dict) -> Params:
    """The MTP block: ``merge`` projects a step's fps frame embeddings into
    one talker input; the SwiGLU block maps (hidden + previous frame's
    embedding) to the next frame's hidden. Read once a step, not a frame."""
    return {
        "merge": init.linear(t.hidden, t.frames_per_step * t.hidden, **qz),
        "mlp": {
            "gate": init.linear(t.ffn, t.hidden, **qz),
            "up": init.linear(t.ffn, t.hidden, **qz),
            "down": init.linear(t.hidden, t.ffn, **qz),
        },
        "ln": init.ones(t.hidden),
    }


def add_mtp_params(params: Params, cfg: ModelConfig, seed: int = 0) -> Params:
    """Graft freshly initialised MTP heads onto a talker tree (real
    checkpoints carry none; ``finetune.py --mtp-fps`` trains them), drawn
    on the host as the JAX package draws them. ``cfg`` must carry the
    target ``frames_per_step``. The heads are ALWAYS dense whatever
    ``cfg.quant`` says: they exist to be trained."""
    t = cfg.talker
    if t.frames_per_step <= 1:
        raise ValueError(
            "add_mtp_params needs cfg.talker.frames_per_step > 1 "
            "(configs.with_frames_per_step)")
    if "mtp" in params:
        raise ValueError("params already carry an 'mtp' subtree")
    init = make_init(seed, torch_dtype(cfg))
    qz = dict(quantize=False, group_size=cfg.quant.group_size,
              bits=cfg.quant.bits)
    return {**params, "mtp": _init_mtp(init, t, qz)}


def talker_forward(
    params: Params,
    t: TalkerConfig,
    x_emb: torch.Tensor,           # [B, T, D] input embeddings
    cache_k: torch.Tensor,         # [L, B, S, H_kv, hd], written in place
    cache_v: torch.Tensor,
    pos,                           # write offset: int, or [B] per row
    cos_table: torch.Tensor,       # [S_rope, hd/2] full-length RoPE tables
    sin_table: torch.Tensor,
    pad_len=0,                     # left padding: int, or [B] per row
    head_last_only: bool = False,
    window_split: tuple | None = None,
    mesh=None,
):
    """Run all layers; returns (hidden [B,T,D], logits f32, cache_k,
    cache_v). Prefill (T > 1) and decode (T == 1). ``head_last_only``
    scores only the last position (prefill). ``window_split``: per-group
    attention windows of the serving engine (``layers.attention``).
    ``mesh``: the blocks are this rank's tp shard (``parallel/``), the
    caches hold its kv heads; the hidden and logits are whole on every
    rank (the embeddings, ``ln_f`` and the head are replicated)."""
    T = x_emb.shape[1]
    tp = 1 if mesh is None else mesh.tp
    cos, sin = rope_slice(cos_table, sin_table, pos, T)
    x = x_emb
    for i, bp in enumerate(unstack_layers(params["blocks"])):
        x = transformer_block(
            bp, x, cos=cos, sin=sin, cache_k=cache_k[i], cache_v=cache_v[i],
            pos=pos, n_heads=t.n_heads // tp, n_kv_heads=t.n_kv_heads // tp,
            head_dim=t.head_dim, rms_eps=t.rms_eps, qk_norm=True,
            pad_len=pad_len, window_split=window_split, mesh=mesh,
        )
    hidden = rmsnorm(x, params["ln_f"], t.rms_eps)
    head_in = hidden[:, -1:, :] if head_last_only else hidden
    logits = linear(head_in, params["head"]).float()
    return hidden, logits, cache_k, cache_v


def embed_codec_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Codebook-0 token ids -> talker input embeddings."""
    return params["codec_emb"][tokens]


def merge_step_embs(params: Params, t: TalkerConfig,
                    embs: torch.Tensor) -> torch.Tensor:
    """One step's frame embeddings [B, frames_per_step, D] -> the talker's
    next input embedding [B, D] (under the residual_sum protocol each frame
    embedding is the full feedback vector: cb0 + residual sum +
    trailing-text row). At frames_per_step == 1 the single embedding,
    otherwise the learned ``mtp.merge`` of their concatenation."""
    if t.frames_per_step == 1:
        return embs[:, 0]
    return linear(embs.reshape(embs.shape[0], t.frames_per_step * t.hidden),
                  params["mtp"]["merge"])


def merge_step_tokens(params: Params, t: TalkerConfig,
                      tokens: torch.Tensor) -> torch.Tensor:
    """One step's token ids [B, frames_per_step] -> the talker's next input
    embedding [B, D]; at frames_per_step == 1 the plain codec embedding."""
    return merge_step_embs(params, t, params["codec_emb"][tokens])


def mtp_hidden_emb(params: Params, t: TalkerConfig, hidden: torch.Tensor,
                   prev_emb: torch.Tensor) -> torch.Tensor:
    """Next-frame hidden [B, D] from the chain hidden [B, D] and the
    previous frame's INPUT embedding [B, D] (the cb0 protocol: its codec
    embedding; residual_sum: its feedback embedding, cb0 + residual sum)."""
    mtp = params["mtp"]
    x = hidden + prev_emb.to(hidden.dtype)
    h = rmsnorm(x, mtp["ln"], t.rms_eps)
    gate = linear(h, mtp["mlp"]["gate"])
    up = linear(h, mtp["mlp"]["up"])
    return x + linear(F.silu(gate) * up, mtp["mlp"]["down"])


def mtp_hidden(params: Params, t: TalkerConfig, hidden: torch.Tensor,
               prev_tok: torch.Tensor) -> torch.Tensor:
    """``mtp_hidden_emb`` conditioned on the previous frame's token [B]."""
    return mtp_hidden_emb(params, t, hidden, params["codec_emb"][prev_tok])


def mtp_logits_emb(params: Params, t: TalkerConfig, hidden: torch.Tensor,
                   prev_emb: torch.Tensor):
    """(logits f32 [B, codec_vocab], next hidden [B, D]) of one MTP frame
    conditioned on the previous frame's input embedding, scored by the
    shared codec head."""
    h = mtp_hidden_emb(params, t, hidden, prev_emb)
    logits = linear(rmsnorm(h, params["ln_f"], t.rms_eps),
                    params["head"]).float()
    return logits, h


def mtp_logits(params: Params, t: TalkerConfig, hidden: torch.Tensor,
               prev_tok: torch.Tensor):
    """``mtp_logits_emb`` conditioned on the previous frame's token [B]."""
    return mtp_logits_emb(params, t, hidden, params["codec_emb"][prev_tok])


def embed_text_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["text_emb"][tokens]


def text_projection(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The checkpoint's text-projection MLP when the tree has one (identity
    otherwise): the published talker family projects text hiddens into
    talker width (Qwen3OmniMoeTalkerResizeMLP: biased fc1 -> silu ->
    biased fc2)."""
    tp = params.get("text_proj")
    if tp is None:
        return x
    return linear(F.silu(linear(x, tp["fc1"])), tp["fc2"])
