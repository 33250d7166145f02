"""Residual-codebook predictor: a small depth transformer that, given the
talker's hidden state for a frame and its codebook-0 token, predicts the
remaining RVQ codebooks 1..Q-1 for that frame.

Residual prediction for a whole chunk of frames is batched over frames: the
depth loop runs Q-1 steps once per chunk, so its linears see chunk-sized
rows. Under the published residual_sum protocol it runs once per frame
inside the talker loop instead, and ``return_feedback`` adds the summed
embeddings of its codes, the residual half of the talker's next input.
The speculative depth decode and the draft adapter wait for ROADMAP queue
A, item 9.
"""

from __future__ import annotations

from typing import Any

import torch

from ..engine.configs import ModelConfig, torch_dtype
from ..ops.linear import linear
from .init import make_init, stack_trees
from .layers import rmsnorm, rope_tables, transformer_block, unstack_layers

Params = dict[str, Any]


def init_code_predictor(cfg: ModelConfig, seed: int = 1, device=None) -> Params:
    """Random-init predictor parameters (see talker.init_talker for
    ``device``)."""
    cp = cfg.code_predictor
    t = cfg.talker
    cc = cfg.codec
    init = make_init(seed, torch_dtype(cfg), device)
    qz = dict(quantize=cfg.quant.enabled,
              group_size=min(cfg.quant.group_size, cp.hidden),
              bits=cfg.quant.bits)
    n_res = cc.num_codebooks - 1
    q_dim = cp.n_heads * cp.head_dim

    def block() -> Params:
        return {
            "attn": {
                "q": init.linear(q_dim, cp.hidden, **qz),
                "k": init.linear(q_dim, cp.hidden, **qz),
                "v": init.linear(q_dim, cp.hidden, **qz),
                "o": init.linear(cp.hidden, q_dim, **qz),
                "q_norm": init.ones(cp.head_dim),
                "k_norm": init.ones(cp.head_dim),
            },
            "mlp": {
                "gate": init.linear(cp.ffn, cp.hidden, **qz),
                "up": init.linear(cp.ffn, cp.hidden, **qz),
                "down": init.linear(cp.hidden, cp.ffn, **qz),
            },
            "ln1": init.ones(cp.hidden),
            "ln2": init.ones(cp.hidden),
        }

    return {
        "in_proj": init.linear(cp.hidden, t.hidden, **qz),
        "cb0_emb": init.normal((cc.codebook_size, cp.hidden), 0.02),
        "res_emb": init.normal(
            (n_res, cc.residual_codebook_size, cp.hidden), 0.02),
        "heads": init.normal((n_res, cc.residual_codebook_size, cp.hidden), 0.02),
        "blocks": stack_trees([block() for _ in range(cp.n_layers)]),
        "ln_f": init.ones(cp.hidden),
    }


def predict_residuals(
    params: Params,
    cfg: ModelConfig,
    talker_hidden: torch.Tensor,   # [B, D_talker] — B is batch * frames
    cb0_tokens: torch.Tensor,      # [B] codebook-0 ids
    generator: torch.Generator | None = None,
    return_feedback: bool = False,
):
    """Depth-autoregressive prediction of the residual codebooks: codes
    [B, Q-1] (int64); with ``return_feedback``, (codes,
    ``residual_feedback_sum`` of them [B, H]).

    With ``generator`` given AND a config that asks for it (cp.top_k > 0,
    cp.top_p < 1 or cp.temperature != 1) each depth is sampled; otherwise
    greedy argmax. ``cp.depth_group`` k scores k consecutive heads per pass
    and feeds the next pass the sum of their code embeddings. Both input
    layouts: "sum" (position 0 = in_proj(hidden) + cb0 embedding) and
    "hidden_token" (positions 0-1 = [hidden, cb0 embedding])."""
    cp = cfg.code_predictor
    cc = cfg.codec
    if cp.spec_decode and cp.depth_group > 1:
        raise NotImplementedError(
            "speculative depth decode waits for ROADMAP queue A, item 9"
        )
    n_res = cc.num_codebooks - 1
    B = talker_hidden.shape[0]
    dev = talker_hidden.device
    hidden_token = cp.input_layout == "hidden_token"
    k = cp.depth_group
    n_groups = n_res // k
    depth_len = n_groups + (2 if hidden_token else 1)

    cos_t, sin_t = rope_tables(depth_len, cp.head_dim, cp.rope_theta, dev)
    layers = unstack_layers(params["blocks"])

    hid = talker_hidden[:, None, :]
    if cp.input_proj:
        hid = linear(hid, params["in_proj"])                       # [B,1,H]
    cb0 = params["cb0_emb"][cb0_tokens][:, None, :]
    if hidden_token:
        x0 = torch.cat([hid, cb0.to(hid.dtype)], dim=1)            # [B,2,H]
    else:
        x0 = hid + cb0

    cache_shape = (cp.n_layers, B, depth_len, cp.n_heads, cp.head_dim)
    cache_k = torch.zeros(cache_shape, dtype=x0.dtype, device=dev)
    cache_v = torch.zeros(cache_shape, dtype=x0.dtype, device=dev)

    def run_blocks(x, pos: int):
        T = x.shape[1]
        cos, sin = cos_t[pos:pos + T], sin_t[pos:pos + T]
        for i, bp in enumerate(layers):
            x = transformer_block(
                bp, x, cos=cos, sin=sin, cache_k=cache_k[i],
                cache_v=cache_v[i], pos=pos, n_heads=cp.n_heads,
                n_kv_heads=cp.n_heads, head_dim=cp.head_dim,
                rms_eps=cp.rms_eps, qk_norm=cp.qk_norm,
            )
        return rmsnorm(x, params["ln_f"], cp.rms_eps)

    stochastic = generator is not None and (
        cp.top_k > 0 or cp.top_p < 1.0 or cp.temperature != 1.0
    )
    if stochastic:
        from ..runtime.sampling import SamplingConfig, sample_token

        cp_sampling = SamplingConfig(
            temperature=cp.temperature, top_k=cp.top_k, top_p=cp.top_p
        )

    def score_group(h_last, g: int):
        """Group g's k residual codes from one hidden [B, H] -> [B, k]."""
        heads = params["heads"][g * k:(g + 1) * k]                  # [k, V, H]
        logits = torch.einsum("bd,kvd->bkv", h_last.float(), heads.float())
        cols = []
        for j in range(k):
            if stochastic:
                cols.append(sample_token(logits[:, j], generator, cp_sampling))
            else:
                cols.append(torch.argmax(logits[:, j], dim=-1))
        return torch.stack(cols, dim=1)

    def next_input(codes_g, g: int):
        """Summed embedding of group g's codes ([B, k] -> [B, 1, H])."""
        embs = torch.stack([params["res_emb"][g * k + j][codes_g[:, j]]
                            for j in range(k)])
        return embs.sum(dim=0)[:, None, :].to(x0.dtype)

    groups = []
    if hidden_token:
        # the two-position seed scores group 0; then one position per group
        h = run_blocks(x0, 0)
        groups.append(score_group(h[:, -1], 0))
        for g in range(1, n_groups):
            h = run_blocks(next_input(groups[-1], g - 1), g + 1)
            groups.append(score_group(h[:, -1], g))
    else:
        x_in = x0
        for g in range(n_groups):
            h = run_blocks(x_in, g)
            groups.append(score_group(h[:, -1], g))
            if g + 1 < n_groups:
                x_in = next_input(groups[-1], g)
    codes = torch.cat(groups, dim=1)
    if return_feedback:
        return codes, residual_feedback_sum(params, codes)
    return codes


def residual_feedback_sum(params: Params, codes: torch.Tensor) -> torch.Tensor:
    """Sum_d res_emb[d][codes[:, d]]: the residual-codebook half of the
    published talker feedback ([B, Q-1] codes -> [B, H]), summed in f32
    in depth order and rounded to the tables' type."""
    tables = params["res_emb"]
    per_depth = torch.stack([tables[d][codes[:, d]]
                             for d in range(codes.shape[1])])
    return per_depth.float().sum(dim=0).to(tables.dtype)
