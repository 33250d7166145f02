"""The port's geometry (``flagship_feedback_code2wav``): a Qwen3 talker
with a 16-row speaker table and no text projection, and a code predictor
at its own width with as many key/value heads as query heads, no input
projection, and its embedding tables at its own width.

The codec head's rows of the control tokens (BOS, EOS, PAD) are zero, so
their logit is exactly 0 while the 2,048 codes' logits spread around it:
a greedy decode never stops early or emits a control token, and every
request runs to its frame budget.
"""

from __future__ import annotations

import torch

from harness.weights import (DTYPES, Draw, block_tree, code2wav_tree, norms,
                             zero_rows)


def talker_tree(d: Draw, cfg: dict) -> dict:
    t, fmt = cfg["talker"], cfg["weights"]
    D = t["hidden"]
    head = d.linear(fmt, (t["codec_vocab"], D))
    zero_rows(head, [t["codec_bos"], t["codec_eos"], t["codec_pad"]])
    return {
        "text_emb": d.normal((t["vocab_size"], D)),
        "codec_emb": d.normal((t["codec_vocab"], D)),
        "spk_emb": d.normal((t["n_speakers"], D)),
        "blocks": block_tree(d, fmt, t["n_layers"], D,
                             t["n_heads"] * t["head_dim"],
                             t["n_kv_heads"] * t["head_dim"], t["ffn"],
                             t["head_dim"]),
        "ln_f": norms(d, (D,)),
        "head": head,
    }


def predictor_tree(d: Draw, cfg: dict) -> dict:
    c, fmt = cfg["code_predictor"], cfg["weights"]
    cb = cfg["code2wav"]["codebook_size"]
    n_res = cfg["code2wav"]["num_quantizers"] - 1
    H = c["hidden"]
    q_dim = c["n_heads"] * c["head_dim"]
    return {
        "cb0_emb": d.normal((cb, H)),
        "res_emb": d.normal((n_res, cb, H)),
        "heads": d.normal((n_res, cb, H)),
        "blocks": block_tree(d, fmt, c["n_layers"], H, q_dim, q_dim,
                             c["ffn"], c["head_dim"]),
        "ln_f": norms(d, (H,)),
    }


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Every leaf of the model, drawn on ``device`` from ``seed``:
    ``{"talker", "predictor", "code2wav"}`` trees in the program's layout."""
    with torch.no_grad():
        d = Draw(seed, device, DTYPES[cfg["dtype"]])
        return {"talker": talker_tree(d, cfg),
                "predictor": predictor_tree(d, cfg),
                "code2wav": code2wav_tree(d, cfg["code2wav"])}
