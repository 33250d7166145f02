"""Frozen: the floating-point operations a served frame needs, counted from
the configuration's shapes alone (2 per multiply-add), whatever computes
them. A frame is one talker step at its context, the 15 passes of the
code predictor over the two-position depth sequence, and code2wav's
2,000 samples; a prompt token is one talker step without the head.
Elementwise work (norms, activations, RoPE, softmax) is left out."""

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


def predictor_frame(c: dict, n_quantizers: int, codebook: int) -> int:
    """The depth transformer over its Q positions and the Q - 1 heads."""
    H, qd = c["hidden"], c["n_heads"] * c["head_dim"]
    per_pos = 2 * c["n_layers"] * (4 * H * qd + 3 * H * c["ffn"])
    positions = n_quantizers
    attn = sum(4 * (p + 1) * qd * c["n_layers"] for p in range(positions))
    heads = (n_quantizers - 1) * 2 * H * codebook
    return positions * per_pos + attn + heads


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


def frame(cfg: dict, position: int, index: int) -> int:
    """Frame ``index`` of its stream, whose talker step sits at
    ``position`` (its context holds position + 1 keys)."""
    w = cfg["code2wav"]
    return (talker_token(cfg["talker"], position + 1, head=True)
            + predictor_frame(cfg["code_predictor"], w["num_quantizers"],
                              w["codebook_size"])
            + code2wav_frame(w, index + 1))


def prompt(cfg: dict, length: int) -> int:
    """A prompt of ``length`` rows prefilled, scored at its last row."""
    t = cfg["talker"]
    return sum(talker_token(t, p + 1, head=False) for p in range(length)) \
        + 2 * t["hidden"] * t["codec_vocab"]


def prompt_rows(cfg: dict) -> int:
    """Rows of a preset-voice prompt of the published protocol: three text
    rows, the three think ids, the speaker, codec_pad, the fourth text row
    over codec_bos."""
    return 9


def peak_ops_per_s() -> float:
    """The H100 SXM's dense bf16 rate."""
    return 989e12
