"""Frozen: the floating-point operations of the port's geometry, counted
from the configuration's shapes alone (2 per multiply-add), whatever
computes them. A frame is one talker step at its context, the 15 passes of
the code predictor over the two-position depth sequence, and code2wav's
2,000 samples; a prompt token is one talker step without the head; a
request's seed frame is its prompt's code predictor. The code predictor
has as many key/value heads as query heads and no input projection.
Elementwise work (norms, activations, RoPE, softmax) is left out."""

from __future__ import annotations

from harness.flops import code2wav_frame, talker_token


def predictor_frame(c: dict, n_quantizers: int, codebook: int) -> int:
    """The depth transformer over its Q positions and the Q - 1 heads."""
    H, qd = c["hidden"], c["n_heads"] * c["head_dim"]
    per_pos = 2 * c["n_layers"] * (4 * H * qd + 3 * H * c["ffn"])
    positions = n_quantizers
    attn = sum(4 * (p + 1) * qd * c["n_layers"] for p in range(positions))
    heads = (n_quantizers - 1) * 2 * H * codebook
    return positions * per_pos + attn + heads


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


def seed_frame(cfg: dict) -> int:
    """The code predictor's work on a request's seed frame, which the
    prompt's last row scores."""
    w = cfg["code2wav"]
    return predictor_frame(cfg["code_predictor"], w["num_quantizers"],
                           w["codebook_size"])
