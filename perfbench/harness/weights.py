"""The leaf drawers that every model family's weights use, on the device,
from the seed.

One ``torch.Generator`` on the device (``Draw``) draws every leaf in the
program's tree layout (stacked layers, ``[out, in]`` linears), in the type
it is served in:

- ``int8``: each linear as the 8-bit snapshot holds it: uint8 codes, and
  a scale and a bias per group of ``group_size`` inputs, both rounded to
  bfloat16 (the snapshot's type) and kept as float32, so
  ``W = scale * q + bias`` spans about +-0.035 around zero (std 0.02);
- ``bfloat16``: the same linears dense, normal with std 0.02.

Embeddings, heads, norms and the whole code2wav decoder are dense in the
configuration's type (bfloat16) in both formats, as the program keeps
them. Shared here: ``Draw``, a Qwen3 block stack (``block_tree``) and the
12 Hz code2wav decoder (``code2wav_tree``). A family's ``weights.py``
(``perfbench/families/<family>/``) draws its talker and code predictor
with them; the same tensors go to the program and to the reference.
"""

from __future__ import annotations

import math

import torch

STD = 0.02
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Draw:
    """One generator on ``device`` seeded with ``seed``; leaves in ``dtype``."""

    def __init__(self, seed: int, device, dtype=torch.bfloat16):
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.dev = torch.device(device)
        self.dtype = dtype

    def normal(self, shape, std=STD, mean=0.0):
        x = torch.randn(shape, generator=self.gen, device=self.dev)
        return (x * std + mean).to(self.dtype)

    def linear(self, fmt: dict, shape, std=STD) -> dict:
        """A linear ``[*, out, in]`` in the configuration's weight format."""
        if fmt["format"] == "bfloat16":
            return {"w": self.normal(shape, std)}
        *lead, n, k = shape
        gs = min(fmt["group_size"], k)
        levels = (1 << fmt["bits"]) - 1
        q = torch.randint(0, levels + 1, shape, dtype=torch.uint8,
                          generator=self.gen, device=self.dev)
        # uniform codes have std levels / sqrt(12): a scale near s0 gives
        # the weight std ``std``
        s0 = std * math.sqrt(12.0) / levels
        gshape = (*lead, n, k // gs)
        u = torch.rand(gshape, generator=self.gen, device=self.dev)
        scale = (s0 * (0.75 + 0.5 * u)).to(torch.bfloat16).float()
        u = torch.rand(gshape, generator=self.gen, device=self.dev)
        bias = (-scale * (levels / 2 + 4.0 * (u - 0.5))).to(torch.bfloat16)
        return {"q": q, "scale": scale, "bias": bias.float()}


def norms(d: Draw, shape):
    """Norm weights near 1."""
    return d.normal(shape, 0.05, 1.0)


def block_tree(d: Draw, fmt: dict, L, hidden, q_dim, kv_dim, ffn, hd):
    """``L`` stacked Qwen3 blocks: q/k/v/o with per-head q/k norms, a
    SwiGLU MLP, the two pre-norms."""
    return {
        "attn": {
            "q": d.linear(fmt, (L, q_dim, hidden)),
            "k": d.linear(fmt, (L, kv_dim, hidden)),
            "v": d.linear(fmt, (L, kv_dim, hidden)),
            "o": d.linear(fmt, (L, hidden, q_dim)),
            "q_norm": norms(d, (L, hd)),
            "k_norm": norms(d, (L, hd)),
        },
        "mlp": {
            "gate": d.linear(fmt, (L, ffn, hidden)),
            "up": d.linear(fmt, (L, ffn, hidden)),
            "down": d.linear(fmt, (L, hidden, ffn)),
        },
        "ln1": norms(d, (L, hidden)),
        "ln2": norms(d, (L, hidden)),
    }


def zero_rows(lin: dict, rows: list[int]) -> None:
    """Zero the output rows ``rows`` of a raw linear, in every format."""
    for key in lin:
        lin[key][rows] = 0


def code2wav_tree(d: Draw, c: dict) -> dict:
    """The decoder with scales that keep its waveform inside [-1, 1]:
    convolutions near unit gain, residual branches at a third of it."""
    H, D = c["hidden"], c["decoder_dim"]
    hd = H // c["n_heads"]
    L = c["n_layers"]

    def conv(out_ch, in_ch, k, gain=1.0):
        return {"w": d.normal((out_ch, in_ch, k), gain / math.sqrt(in_ch * k)),
                "b": d.normal((out_ch,), 0.01)}

    def tconv(in_ch, out_ch, k, stride):
        return {"w": d.normal((in_ch, out_ch, k),
                              1.0 / math.sqrt(in_ch * k / stride)),
                "b": d.normal((out_ch,), 0.01)}

    def snake(dim):
        return {"alpha": d.normal((dim,), 0.1), "beta": d.normal((dim,), 0.1)}

    def dense(out_dim, in_dim):
        return {"w": d.normal((L, out_dim, in_dim))}

    blocks = {
        "attn": {"q": dense(c["n_heads"] * hd, H),
                 "k": dense(c["n_kv_heads"] * hd, H),
                 "v": dense(c["n_kv_heads"] * hd, H),
                 "o": dense(H, c["n_heads"] * hd)},
        "mlp": {"gate": dense(c["ffn"], H), "up": dense(c["ffn"], H),
                "down": dense(H, c["ffn"])},
        "ln1": norms(d, (L, H)),
        "ln2": norms(d, (L, H)),
        "ls_attn": d.normal((L, H), 0.01, c["layer_scale_init"]),
        "ls_mlp": d.normal((L, H), 0.01, c["layer_scale_init"]),
    }
    upsample = tuple({
        "tconv": tconv(H, H, r, r),
        "cnx": {
            "dw": conv(H, 1, 7),
            "ln_w": norms(d, (H,)),
            "ln_b": d.normal((H,), 0.02),
            "pw1": {"w": d.normal((4 * H, H), 1.0 / math.sqrt(H)),
                    "b": d.normal((4 * H,), 0.02)},
            "pw2": {"w": d.normal((H, 4 * H), 1.0 / math.sqrt(4 * H)),
                    "b": d.normal((H,), 0.02)},
            "gamma": d.normal((H,), 0.02, 0.3),
        },
    } for r in c["upsampling_ratios"])
    dec_blocks = []
    for i, r in enumerate(c["upsample_rates"]):
        in_dim, out_dim = D // 2 ** i, D // 2 ** (i + 1)
        dec_blocks.append({
            "snake": snake(in_dim),
            "tconv": tconv(in_dim, out_dim, 2 * r, r),
            "res": tuple({"a1": snake(out_dim), "c1": conv(out_dim, out_dim, 7),
                          "a2": snake(out_dim),
                          "c2": conv(out_dim, out_dim, 1, 1.0 / 3.0)}
                         for _ in range(3)),
        })
    out_dim = D // 2 ** len(c["upsample_rates"])
    return {
        "code_emb": d.normal((c["codebook_size"] * c["num_quantizers"], H)),
        "pre": {"blocks": blocks, "ln_f": norms(d, (H,))},
        "upsample": upsample,
        "decoder": {
            "conv_in": conv(D, H, 7),
            "blocks": tuple(dec_blocks),
            "snake_out": snake(out_dim),
            "conv_out": conv(1, out_dim, 7, 0.08),
        },
    }
