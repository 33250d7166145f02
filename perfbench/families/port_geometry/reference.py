"""The plain reference of the port's geometry: its prompt, its code
predictor and a served request's teacher-forced logits.

The prompt is the dual-stream prompt of the published talker
(``Qwen3OmniMoeForConditionalGeneration._get_talker_assistant_parts``) for a
preset voice, with the speaker's row from the 16-row ``spk_emb`` table and
the text after its fourth token in a trailing buffer, one row a frame. No
padding: RoPE is relative, so the program's left padding to a bucket
changes nothing that is compared. The code predictor runs at its own
width on the raw talker hidden, with as many key/value heads as query
heads. The talker and code2wav are the shared blocks
(``reference/model.py``), which this family uses as they are.

It imports nothing of the program under test and nothing of JAX.
"""

from __future__ import annotations

import torch

from reference.model import (Weights, block, causal, code2wav,  # noqa: F401
                             rmsnorm, startup_samples, talker_pass)


def assemble(tables: dict, talker: dict, tokens: list[int],
             speaker_id: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(prompt rows [L, D], trailing-text buffer [Tb, D]) of one request.

    ``tables``: ``text_emb``, ``codec_emb`` and ``spk_emb`` as the run
    computes them; ``talker``: the configuration's talker section. The
    rows are the three chat-head text rows, the codec think head under
    tts_pad, the speaker row under tts_pad, codec_pad under tts_bos, and
    the fourth text token over codec_bos. The buffer holds the text rows
    after the fourth, cut to Tb - 2, then tts_eos unless cut, then
    tts_pad to the end."""
    text_emb, codec_emb = tables["text_emb"], tables["codec_emb"]
    dev = text_emb.device
    ids = torch.tensor([talker["tts_pad_id"], talker["tts_bos_id"],
                        talker["tts_eos_id"]], device=dev)
    pad_e, bos_e, eos_e = text_emb[ids]
    txt = text_emb[torch.tensor(tokens, dtype=torch.long, device=dev)]
    T = txt.shape[0]
    if T < 4:
        raise ValueError("a request renders to at least four tokens")
    rows = [txt[:3]]
    for tok in (talker["codec_nothink"], talker["codec_think_bos"],
                talker["codec_think_eos"]):
        rows.append((pad_e + codec_emb[tok])[None])
    rows.append((pad_e + tables["spk_emb"][speaker_id])[None])
    rows.append((bos_e + codec_emb[talker["codec_pad"]])[None])
    rows.append((txt[3] + codec_emb[talker["codec_bos"]])[None])
    Tb = talker["trailing_bucket"]
    rest = txt[4:]
    kept = rest[:Tb - 2]
    buf = pad_e[None].repeat(Tb, 1)
    if rest.shape[0] == kept.shape[0]:
        buf[kept.shape[0]] = eos_e
    buf[:kept.shape[0]] = kept
    return torch.cat(rows), buf


def predictor_pass(W: Weights, c: dict, hidden: torch.Tensor,
                   codes: torch.Tensor) -> torch.Tensor:
    """Depth logits float32 [F, Q-1, V] of F frames: the talker hidden
    [F, D] at each frame and its served codes [F, Q] (cb0, then the
    residual depths), the two-position layout [hidden, cb0 embedding,
    depth embeddings 0..Q-3], depth d scored at position d + 1."""
    p = W.raw["predictor"]
    act = W.act
    n_res = codes.shape[1] - 1
    emb = [hidden.to(act)[:, None],
           W.table(p["cb0_emb"])[codes[:, 0]].to(act)[:, None]]
    res_emb = W.table(p["res_emb"])
    for d in range(n_res - 1):
        emb.append(res_emb[d][codes[:, 1 + d]].to(act)[:, None])
    x = torch.cat(emb, dim=1)
    allowed = causal(x.shape[1], x.device)
    for i in range(c["n_layers"]):
        x = block(W, p["blocks"], i, x, n_heads=c["n_heads"],
                  n_kv=c["n_heads"], hd=c["head_dim"], eps=c["rms_eps"],
                  theta=c["rope_theta"], qk_norm=c["qk_norm"],
                  allowed=allowed)
    h = rmsnorm(x, p["ln_f"], c["rms_eps"], act)[:, 1:1 + n_res]
    return torch.einsum("fdh,dvh->fdv", h.float(), W.table(p["heads"]))


def request_inputs(W: Weights, cfg: dict, req: dict):
    """(rows [L + N, D], L) of a served request: its prompt rows, then the
    input of each decode step j = 0..N-1: frame j's codec embedding, the
    sum of its residual embeddings and trailing-text row j. ``req`` holds
    ``tokens``, ``speaker_id`` and ``codes`` [N + 1, Q] (the seed frame,
    then the N rendered frames)."""
    t = cfg["talker"]
    p, cp = W.raw["talker"], W.raw["predictor"]
    tables = {k: W.table(p[k]) for k in ("text_emb", "codec_emb", "spk_emb")}
    rows, trailing = assemble(tables, t, req["tokens"], req["speaker_id"])
    codes = req["codes"][:-1]                                  # frames 0..N-1
    n = codes.shape[0]
    res_emb = W.table(cp["res_emb"])
    fb = tables["codec_emb"][codes[:, 0]]
    for d in range(codes.shape[1] - 1):
        fb = fb + res_emb[d][codes[:, 1 + d]]
    steps = torch.arange(n, device=fb.device).clamp(max=trailing.shape[0] - 1)
    return torch.cat([rows, fb + trailing[steps]]), rows.shape[0]


def judge_tokens(W: Weights, cfg: dict, req: dict, chunk: int = 512):
    """(cb0 logits [N + 1, V], depth logits [N + 1, Q - 1, V]) at every
    served frame of one request, teacher-forced on its codes."""
    x, L = request_inputs(W, cfg, req)
    hidden, logits = talker_pass(W, cfg["talker"], x)
    h = hidden[L - 1:]                                         # frames 0..N
    codes = req["codes"]
    depth = torch.cat([
        predictor_pass(W, cfg["code_predictor"], h[i:i + chunk],
                       codes[i:i + chunk])
        for i in range(0, codes.shape[0], chunk)])
    return logits[L - 1:], depth
