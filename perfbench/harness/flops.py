"""Frozen: the floating-point operations of the parts every model family
shares, counted from the configuration's shapes alone (2 per multiply-add),
whatever computes them: a Qwen3 talker step at its context and a code2wav
frame's 2,000 samples, and the card's peak. A family's ``flops.py``
(``perfbench/families/<family>/``) counts a served frame, a prompt and a
request's seed frame from them and its own code predictor. Elementwise
work (norms, activations, RoPE, softmax) is left out."""

from __future__ import annotations


def _talker_linear(t: dict) -> int:
    D, qd, kvd = t["hidden"], t["n_heads"] * t["head_dim"], t["n_kv_heads"] * t["head_dim"]
    per_layer = D * qd + 2 * D * kvd + qd * D + 3 * D * t["ffn"]
    return 2 * t["n_layers"] * per_layer


def talker_token(t: dict, context: int, head: bool) -> int:
    """One talker position attending ``context`` keys."""
    qd = t["n_heads"] * t["head_dim"]
    attn = 4 * context * qd * t["n_layers"]
    return _talker_linear(t) + attn + (2 * t["hidden"] * t["codec_vocab"] if head else 0)


def _conv(c_in: int, c_out: int, k: int, t_out: int, groups: int = 1) -> int:
    return 2 * (c_in // groups) * c_out * k * t_out


def code2wav_frame(w: dict, context: int) -> int:
    """One frame through the decoder: the pre-transformer step at its
    sliding window, the upsampling stages and the decoder blocks."""
    H, D = w["hidden"], w["decoder_dim"]
    hd = H // w["n_heads"]
    kvd = w["n_kv_heads"] * hd
    pre = 2 * w["n_layers"] * (2 * H * H + 2 * H * kvd + 3 * H * w["ffn"])
    pre += 4 * min(context, w["sliding_window"]) * H * w["n_layers"]
    ops, T = pre, 1
    for r in w["upsampling_ratios"]:
        ops += _conv(H, H, r, T)                      # transposed: k x T_in
        T *= r
        ops += _conv(H, H, 7, T, groups=H) + 2 * 2 * H * 4 * H * T
    ops += _conv(H, D, 7, T)
    ch = D
    for r in w["upsample_rates"]:
        out = ch // 2
        ops += _conv(ch, out, 2 * r, T)
        T *= r
        ops += 3 * (_conv(out, out, 7, T) + _conv(out, out, 1, T))
        ch = out
    ops += _conv(ch, 1, 7, T)
    return ops


def peak_ops_per_s() -> float:
    """The H100 SXM's dense bf16 rate."""
    return 989e12
