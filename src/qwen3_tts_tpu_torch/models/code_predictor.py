"""Residual-codebook predictor: a small depth transformer that, given the
talker's hidden state for a frame and its codebook-0 token, predicts the
remaining RVQ codebooks 1..Q-1 for that frame.

Residual prediction for a whole chunk of frames is batched over frames: the
depth loop runs Q-1 steps once per chunk, so its linears see chunk-sized
rows. Under the published residual_sum protocol it runs once per frame
inside the talker loop instead, and ``return_feedback`` adds the summed
embeddings of its codes, the residual half of the talker's next input.

Speculative depth decode (``cp.spec_decode`` with ``depth_group`` > 1):
the grouped pass drafts every residual code, one teacher-forced
full-depth pass verifies them, and a loop corrects the first mismatch (or
rejection, when sampling) per row until every row is final. Greedy output
equals the depth_group=1 stream exactly; sampled output equals it in
distribution. The JAX package's ``lax.while_loop`` is a Python loop that
reads one host flag per round.

``mesh`` (``parallel/``): the depth transformer is this rank's tp shard
(``parallel.sharding.cp_mesh``), run at local heads with local caches;
its heads and embedding tables are replicated, so codes are equal on
every rank.
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
    _as_draft: bool = False,
    _return_probs: bool = False,
    mesh=None,
):
    """Depth-autoregressive prediction of the residual codebooks: codes
    [B, Q-1] (int64); with ``return_feedback``, (codes,
    ``residual_feedback_sum`` of them [B, H]).

    With ``generator`` given AND a config that asks for it (cp.top_k > 0,
    cp.top_p < 1 or cp.temperature != 1) each depth is sampled; otherwise
    greedy argmax. ``cp.depth_group`` k scores k consecutive heads per pass
    and feeds the next pass the sum of their code embeddings. Both input
    layouts: "sum" (position 0 = in_proj(hidden) + cb0 embedding) and
    "hidden_token" (positions 0-1 = [hidden, cb0 embedding]).

    ``cp.spec_decode`` with k > 1 routes to the speculative decode (greedy,
    or exact speculative sampling when sampling). ``_as_draft`` stops that
    routing (the spec paths call back in for their draft);
    ``_return_probs`` also returns the filtered distribution [B, Q-1, V]
    f32 each sampled code was drawn from. ``mesh``: a tp-sharded depth
    transformer (module docstring)."""
    cp = cfg.code_predictor
    cc = cfg.codec
    k = cp.depth_group
    stochastic = generator is not None and (
        cp.top_k > 0 or cp.top_p < 1.0 or cp.temperature != 1.0
    )
    if cp.spec_decode and k > 1 and not _as_draft:
        # temperature <= 0 is argmax whatever the other knobs say
        if stochastic and cp.temperature > 0.0:
            return predict_residuals_spec_sampled(
                params, cfg, talker_hidden, cb0_tokens, generator,
                return_feedback=return_feedback, mesh=mesh)
        return predict_residuals_spec(params, cfg, talker_hidden, cb0_tokens,
                                      return_feedback=return_feedback,
                                      mesh=mesh)
    if _return_probs and not stochastic:
        raise ValueError("_return_probs needs a sampling config and generator")
    n_res = cc.num_codebooks - 1
    B = talker_hidden.shape[0]
    dev = talker_hidden.device
    hidden_token = cp.input_layout == "hidden_token"
    n_groups = n_res // k
    depth_len = n_groups + (2 if hidden_token else 1)

    # the draft adapter (finetune.py --freeze-base): a grafted ``draft``
    # copy of the module is what the GROUPED computation reads, so the
    # primary tree (sequential decode, the spec verifier, the residual
    # feedback sum) stays the raw import's while the draft trains
    dp = params["draft"] if (k > 1 and "draft" in params) else params
    cos_t, sin_t = rope_tables(depth_len, cp.head_dim, cp.rope_theta, dev)
    layers = unstack_layers(dp["blocks"])

    hid = talker_hidden[:, None, :]
    if cp.input_proj:
        hid = linear(hid, dp["in_proj"])                           # [B,1,H]
    cb0 = dp["cb0_emb"][cb0_tokens][:, None, :]
    if hidden_token:
        x0 = torch.cat([hid, cb0.to(hid.dtype)], dim=1)            # [B,2,H]
    else:
        x0 = hid + cb0

    heads = cp.n_heads // (1 if mesh is None else mesh.tp)
    cache_shape = (cp.n_layers, B, depth_len, heads, cp.head_dim)
    cache_k = torch.zeros(cache_shape, dtype=x0.dtype, device=dev)
    cache_v = torch.zeros(cache_shape, dtype=x0.dtype, device=dev)

    def run_blocks(x, pos: int):
        T = x.shape[1]
        cos, sin = cos_t[pos:pos + T], sin_t[pos:pos + T]
        for i, bp in enumerate(layers):
            x = transformer_block(
                bp, x, cos=cos, sin=sin, cache_k=cache_k[i],
                cache_v=cache_v[i], pos=pos, n_heads=heads,
                n_kv_heads=heads, head_dim=cp.head_dim,
                rms_eps=cp.rms_eps, qk_norm=cp.qk_norm, mesh=mesh,
            )
        return rmsnorm(x, dp["ln_f"], cp.rms_eps)

    if stochastic:
        from ..runtime.sampling import filtered_logits, sample_token

        cp_sampling = cp_sampling_config(cfg)
    probs = []

    def score_group(h_last, g: int):
        """Group g's k residual codes from one hidden [B, H] -> [B, k]."""
        w = dp["heads"][g * k:(g + 1) * k]                          # [k, V, H]
        logits = torch.einsum("bd,kvd->bkv", h_last.float(), w.float())
        cols = []
        for j in range(k):
            if stochastic:
                cols.append(sample_token(logits[:, j], generator, cp_sampling))
                if _return_probs:
                    probs.append(torch.softmax(
                        filtered_logits(logits[:, j], cp_sampling), dim=-1))
            else:
                cols.append(torch.argmax(logits[:, j], dim=-1))
        return torch.stack(cols, dim=1)

    def next_input(codes_g, g: int):
        """Summed embedding of group g's codes ([B, k] -> [B, 1, H])."""
        embs = torch.stack([dp["res_emb"][g * k + j][codes_g[:, j]]
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
    outs = (codes,)
    if return_feedback:
        outs += (residual_feedback_sum(params, codes),)
    if _return_probs:
        outs += (torch.stack(probs, dim=1),)
    return outs[0] if len(outs) == 1 else outs


def cp_sampling_config(cfg: ModelConfig):
    """The code predictor's own sampling knobs (the published cp.generate:
    do_sample, top_k, top_p) as a SamplingConfig."""
    from ..runtime.sampling import SamplingConfig

    cp = cfg.code_predictor
    return SamplingConfig(temperature=cp.temperature, top_k=cp.top_k,
                          top_p=cp.top_p)


def depth_logits_teacher_forced(
    params: Params,
    cfg: ModelConfig,
    talker_hidden: torch.Tensor,   # [B, D_talker]
    cb0_tokens: torch.Tensor,      # [B]
    codes: torch.Tensor,           # [B, Q-1] candidate residual codes
    mesh=None,
) -> torch.Tensor:
    """ONE causal depth pass over the depth_group=1 layout, teacher-forced
    on ``codes``: float32 logits of every residual head [B, Q-1, V]. Row d
    is the exact depth-autoregressive distribution at depth d wherever
    codes[:, :d] are already final: the verifier of the speculative
    decode."""
    cp = cfg.code_predictor
    n_res = cfg.codec.num_codebooks - 1
    hidden_token = cp.input_layout == "hidden_token"
    dev = talker_hidden.device

    hid = talker_hidden[:, None, :]
    if cp.input_proj:
        hid = linear(hid, params["in_proj"])
    cb0 = params["cb0_emb"][cb0_tokens][:, None, :].to(hid.dtype)
    # input embeddings of depths 0..Q-3 (the last code is never an input)
    embs = torch.stack([params["res_emb"][d][codes[:, d]]
                        for d in range(n_res - 1)], dim=1).to(hid.dtype)
    if hidden_token:
        x = torch.cat([hid, cb0, embs], dim=1)           # [B, Q, H]
        off = 1
    else:
        x = torch.cat([hid + cb0, embs], dim=1)          # [B, Q-1, H]
        off = 0
    B, T, _ = x.shape
    cos_t, sin_t = rope_tables(T, cp.head_dim, cp.rope_theta, dev)
    heads = cp.n_heads // (1 if mesh is None else mesh.tp)
    cache_shape = (B, T, heads, cp.head_dim)
    for bp in unstack_layers(params["blocks"]):
        x = transformer_block(
            bp, x, cos=cos_t, sin=sin_t,
            cache_k=torch.zeros(cache_shape, dtype=x.dtype, device=dev),
            cache_v=torch.zeros(cache_shape, dtype=x.dtype, device=dev),
            pos=0, n_heads=heads, n_kv_heads=heads,
            head_dim=cp.head_dim, rms_eps=cp.rms_eps, qk_norm=cp.qk_norm,
            mesh=mesh,
        )
    h = rmsnorm(x, params["ln_f"], cp.rms_eps)[:, off:off + n_res]
    return torch.einsum("bnd,nvd->bnv", h.float(), params["heads"].float())


def depth_argmax_teacher_forced(params: Params, cfg: ModelConfig,
                                talker_hidden: torch.Tensor,
                                cb0_tokens: torch.Tensor,
                                codes: torch.Tensor,
                                mesh=None) -> torch.Tensor:
    """Argmax of ``depth_logits_teacher_forced``: the greedy verifier."""
    return depth_logits_teacher_forced(
        params, cfg, talker_hidden, cb0_tokens, codes, mesh).argmax(dim=-1)


def predict_residuals_spec(
    params: Params,
    cfg: ModelConfig,
    talker_hidden: torch.Tensor,   # [B, D_talker]
    cb0_tokens: torch.Tensor,      # [B]
    return_feedback: bool = False,
    return_rounds: bool = False,
    mesh=None,
):
    """Speculative depth decode, greedy: the depth_group=1 greedy codes
    exactly, at grouped-draft cost.

    1. DRAFT every code with the grouped path (``cfg.depth_group``);
    2. VERIFY with one teacher-forced full-depth pass;
    3. CORRECT each row's first mismatching depth to the verifier's token
       (exact there: its prefix matched) and verify again, until no row
       mismatches.

    Each round fixes one depth of every unfinished row for good, so the
    loop ends within Q-1 rounds plus the confirming one; a perfect draft
    costs the draft and ONE verifying pass. Returns codes [B, Q-1] (plus
    the feedback sum and the number of verifying passes when asked)."""
    draft = predict_residuals(params, cfg, talker_hidden, cb0_tokens,
                              _as_draft=True, mesh=mesh)
    codes = draft
    rounds = 0
    while True:
        am = depth_argmax_teacher_forced(params, cfg, talker_hidden,
                                         cb0_tokens, codes, mesh)
        rounds += 1
        mism = am != codes                                   # [B, Q-1]
        any_m = mism.any(dim=1)
        if not bool(any_m.any()):                            # one host read
            break
        first = mism.int().argmax(dim=1)
        depth = torch.arange(codes.shape[1], device=codes.device)[None, :]
        fix = (depth == first[:, None]) & any_m[:, None]
        codes = torch.where(fix, am, codes)
    outs = (codes,)
    if return_feedback:
        outs += (residual_feedback_sum(params, codes),)
    if return_rounds:
        outs += (rounds,)
    return outs[0] if len(outs) == 1 else outs


def predict_residuals_spec_sampled(
    params: Params,
    cfg: ModelConfig,
    talker_hidden: torch.Tensor,   # [B, D_talker]
    cb0_tokens: torch.Tensor,      # [B]
    generator: torch.Generator,
    return_feedback: bool = False,
    return_rounds: bool = False,
    mesh=None,
):
    """Exact speculative SAMPLING over the depth axis (the accept /
    residual-resample rule of arXiv:2211.17192), the sampled sibling of
    ``predict_residuals_spec``:

    1. DRAFT every code with the grouped sampled path, keeping the
       filtered distribution q each code was drawn from;
    2. VERIFY with one teacher-forced pass: the target p(. | prefix) at
       every depth;
    3. from each row's final frontier on, ACCEPT code x while
       u * q(x) <= p(x); at the first rejection draw from the normalized
       (p - q)+, an exact draw from p there, make the row final through
       that depth and verify again. Later drafts stay as proposals.

    The output equals the sequential depth_group=1 sampled stream in
    distribution (not bit for bit). Each round makes at least one more
    depth of every unfinished row final, so the loop ends within Q-1
    rounds."""
    from ..runtime.sampling import filtered_logits

    n_res = cfg.codec.num_codebooks - 1
    cp_sampling = cp_sampling_config(cfg)
    draft, q = predict_residuals(params, cfg, talker_hidden, cb0_tokens,
                                 generator, _as_draft=True,
                                 _return_probs=True,
                                 mesh=mesh)  # [B, Q-1], [B, Q-1, V]
    codes = draft
    B = codes.shape[0]
    dev = codes.device
    depth = torch.arange(n_res, device=dev)[None, :]
    rows = torch.arange(B, device=dev)
    m = torch.zeros(B, dtype=torch.long, device=dev)   # final depths a row
    rounds = 0
    while bool((m < n_res).any()):                     # one host read
        logits = depth_logits_teacher_forced(params, cfg, talker_hidden,
                                             cb0_tokens, codes, mesh)
        p = torch.softmax(filtered_logits(logits, cp_sampling), dim=-1)
        u = torch.rand((B, n_res), generator=generator, device=dev)
        px = p.gather(-1, codes[..., None])[..., 0]
        qx = q.gather(-1, codes[..., None])[..., 0]
        # P(u*q <= p) = min(1, p/q); depths below the frontier are final
        acc = (u * qx <= px) | (depth < m[:, None])
        rej_any = ~acc.all(dim=1)
        first = (~acc).int().argmax(dim=1)
        p_at, q_at = p[rows, first], q[rows, first]        # [B, V]
        res = (p_at - q_at).clamp_min(0.0)
        z = res.sum(dim=-1, keepdim=True)
        # z == 0 only on numeric ties (p <= q everywhere makes a rejection
        # ~impossible): draw from p itself there
        dist = torch.where(z > 1e-9, res / z.clamp_min(1e-30), p_at)
        new_tok = torch.multinomial(dist, 1, generator=generator)[:, 0]
        fix = rej_any[:, None] & (depth == first[:, None])
        codes = torch.where(fix, new_tok[:, None], codes)
        m = torch.where(rej_any, first + 1, torch.full_like(m, n_res))
        rounds += 1
    outs = (codes,)
    if return_feedback:
        outs += (residual_feedback_sum(params, codes),)
    if return_rounds:
        outs += (rounds,)
    return outs[0] if len(outs) == 1 else outs


def residual_feedback_sum(params: Params, codes: torch.Tensor) -> torch.Tensor:
    """Sum_d res_emb[d][codes[:, d]]: the residual-codebook half of the
    published talker feedback ([B, Q-1] codes -> [B, H]), summed in f32
    in depth order and rounded to the tables' type."""
    tables = params["res_emb"]
    per_depth = torch.stack([tables[d][codes[:, d]]
                             for d in range(codes.shape[1])])
    return per_depth.float().sum(dim=0).to(tables.dtype)
