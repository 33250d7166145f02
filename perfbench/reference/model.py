"""The building blocks of the served model's plain reference, shared by
every model family (``perfbench/families/<family>/reference.py``).

The mathematics of the Qwen3-TTS 12 Hz model as the program implements it
(a frozen copy of its plain code): the Qwen3 block (pre-norm RMSNorm,
grouped-query attention with optional per-head q/k RMSNorm, rotate-half
RoPE, SwiGLU) and the talker's stack of them (``talker_pass``), and the
code2wav decoder (mean code embedding, sliding-window pre-transformer with
LayerScale, ConvNeXt upsampling, SnakeBeta decoder blocks). A family
assembles its prompt and its code predictor from them. Everything runs
over whole sequences with causal masks: no cache, no batching of
requests, no kernels. Matrix products take float32 with TF32 off
(``no_tf32``), or the precision's activation type for the control.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from .quant import Precision

DILATIONS = (1, 3, 9)


@contextlib.contextmanager
def no_tf32():
    """Float32 products as float32: TF32 off for matmuls and convolutions."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def lin(x, w, act, b=None):
    y = x.to(act) @ w.to(act).t()
    return y if b is None else y + b.to(act)


def rmsnorm(x, w, eps, act):
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (y * w.float()).to(act)


def rope(x, theta, act):
    """Rotate-half RoPE over x [..., T, H, hd] at positions 0..T-1."""
    T, hd = x.shape[-3], x.shape[-1]
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64) / half)
    ang = torch.arange(T, dtype=torch.float64)[:, None] * inv[None, :]
    cos = torch.cos(ang).float().to(x.device)[:, None, :].to(act)
    sin = torch.sin(ang).float().to(x.device)[:, None, :].to(act)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1)


def attend(q, k, v, allowed, act):
    """q [B, T, H, hd], k/v [B, T, Hkv, hd]; scores and softmax in float32,
    probabilities in the activation type, float32 accumulation."""
    groups = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(groups, dim=2)
    v = v.repeat_interleave(groups, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    s = s * q.shape[-1] ** -0.5
    s = s.masked_fill(~allowed, float("-inf"))
    p = torch.softmax(s, dim=-1).to(act)
    ctx = torch.einsum("bhts,bshd->bthd", p.float(), v.float()).to(act)
    return ctx.reshape(q.shape[0], q.shape[1], -1)


def causal(T, device, window=None):
    i = torch.arange(T, device=device)
    ok = i[None, :] <= i[:, None]
    if window is not None:
        ok = ok & (i[None, :] > i[:, None] - window)
    return ok


class Weights:
    """The raw trees at one precision, each weight formed on first use."""

    def __init__(self, raw: dict, prec: Precision):
        self.raw = raw
        self.prec = prec
        self.act = prec.act

    def lin(self, node: dict, layer: int | None = None) -> torch.Tensor:
        if layer is not None:
            node = {k: v[layer] for k, v in node.items()}
        return self.prec.weight(node)

    def table(self, t: torch.Tensor) -> torch.Tensor:
        return self.prec.table(t)


def block(W: Weights, blocks: dict, i: int, x, *, n_heads, n_kv, hd, eps,
          theta, qk_norm, allowed):
    """Block ``i`` of the stacked ``blocks`` over x [B, T, D]."""
    act = W.act
    a, m = blocks["attn"], blocks["mlp"]
    B, T, _ = x.shape
    h = rmsnorm(x, blocks["ln1"][i], eps, act)
    q = lin(h, W.lin(a["q"], i), act).reshape(B, T, n_heads, hd)
    k = lin(h, W.lin(a["k"], i), act).reshape(B, T, n_kv, hd)
    v = lin(h, W.lin(a["v"], i), act).reshape(B, T, n_kv, hd)
    if qk_norm:
        q = rmsnorm(q, a["q_norm"][i], eps, act)
        k = rmsnorm(k, a["k_norm"][i], eps, act)
    q, k = rope(q, theta, act), rope(k, theta, act)
    x = x + lin(attend(q, k, v, allowed, act), W.lin(a["o"], i), act)
    h = rmsnorm(x, blocks["ln2"][i], eps, act)
    g = lin(h, W.lin(m["gate"], i), act)
    u = lin(h, W.lin(m["up"], i), act)
    return x + lin(F.silu(g) * u, W.lin(m["down"], i), act)


def talker_pass(W: Weights, t: dict, x: torch.Tensor):
    """The talker over input rows x [T, D]: (hidden after the final norm
    [T, D], codec-head logits float32 [T, V])."""
    p = W.raw["talker"]
    act = W.act
    x = x.to(act)[None]
    allowed = causal(x.shape[1], x.device)
    for i in range(t["n_layers"]):
        x = block(W, p["blocks"], i, x, n_heads=t["n_heads"],
                  n_kv=t["n_kv_heads"], hd=t["head_dim"], eps=t["rms_eps"],
                  theta=t["rope_theta"], qk_norm=True, allowed=allowed)
    hidden = rmsnorm(x, p["ln_f"], t["rms_eps"], act)[0]
    return hidden, lin(hidden, W.lin(p["head"]), act).float()


# --------------------------------------------------------------------------
# code2wav
# --------------------------------------------------------------------------

def _conv(W, x, p, dilation=1, groups=1):
    w = W.table(p["w"]).to(W.act)
    k_eff = (w.shape[-1] - 1) * dilation + 1
    y = F.conv1d(F.pad(x, (k_eff - 1, 0)), w, dilation=dilation, groups=groups)
    return y + p["b"].to(W.act)[None, :, None]


def _tconv(W, x, p, stride):
    """A causal transposed convolution from silence: the first
    T_in * stride samples of the overlap-add (the last kernel - stride
    belong to the frames after the sequence)."""
    w = W.table(p["w"]).to(W.act)
    y = F.conv_transpose1d(x, w, stride=stride) + p["b"].to(W.act)[None, :, None]
    return y[..., :x.shape[-1] * stride]


def _snake(x, p, act):
    xf = x.float()
    alpha = torch.exp(p["alpha"].float())[None, :, None]
    beta = torch.exp(p["beta"].float())[None, :, None]
    return (xf + (1.0 / (beta + 1e-9)) * torch.sin(xf * alpha) ** 2).to(act)


def _layer_norm(x, w, b, act, eps=1e-6):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).pow(2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()).to(act)


def code2wav(W: Weights, c: dict, codes: torch.Tensor) -> torch.Tensor:
    """The waveform float32 [T * hop - startup] of codes [Q, T]: the causal
    decode from silence (every convolution's left context zero, every
    transposed convolution's overlap-add starting from nothing) over the
    whole sequence at once, its first ``startup_samples`` (the run-in) cut.
    Cut into chunks with their carried context this is the stream the
    program serves; the one-shot decode of the published model trims each
    transposed convolution at both ends instead, which differs from it
    within the receptive field of the start."""
    p = W.raw["code2wav"]
    act = W.act
    Q, T = codes.shape
    offs = torch.arange(Q, device=codes.device)[:, None] * c["codebook_size"]
    x = W.table(p["code_emb"])[codes + offs].mean(dim=0)[None].to(act)
    pre = p["pre"]
    H, nh, nkv = c["hidden"], c["n_heads"], c["n_kv_heads"]
    hd = H // nh
    allowed = causal(T, x.device, c["sliding_window"])
    for i in range(c["n_layers"]):
        a, m = pre["blocks"]["attn"], pre["blocks"]["mlp"]
        h = rmsnorm(x, pre["blocks"]["ln1"][i], c["rms_eps"], act)
        q = rope(lin(h, W.lin(a["q"], i), act).reshape(1, T, nh, hd),
                  c["rope_theta"], act)
        k = rope(lin(h, W.lin(a["k"], i), act).reshape(1, T, nkv, hd),
                  c["rope_theta"], act)
        v = lin(h, W.lin(a["v"], i), act).reshape(1, T, nkv, hd)
        o = lin(attend(q, k, v, allowed, act), W.lin(a["o"], i), act)
        x = x + o * pre["blocks"]["ls_attn"][i].to(act)
        h = rmsnorm(x, pre["blocks"]["ln2"][i], c["rms_eps"], act)
        g = lin(h, W.lin(m["gate"], i), act)
        u = lin(h, W.lin(m["up"], i), act)
        y = lin(F.silu(g) * u, W.lin(m["down"], i), act)
        x = x + y * pre["blocks"]["ls_mlp"][i].to(act)
    h = rmsnorm(x, pre["ln_f"], c["rms_eps"], act).transpose(1, 2)
    for stage, r in zip(p["upsample"], c["upsampling_ratios"]):
        h = _tconv(W, h, stage["tconv"], r)
        cnx = stage["cnx"]
        d = _conv(W, h, cnx["dw"], groups=h.shape[1])
        d = _layer_norm(d.transpose(1, 2), cnx["ln_w"], cnx["ln_b"], act)
        d = lin(d, W.table(cnx["pw1"]["w"]), act, cnx["pw1"]["b"])
        d = F.gelu(d, approximate="none")
        d = lin(d, W.table(cnx["pw2"]["w"]), act, cnx["pw2"]["b"])
        h = h + (d * cnx["gamma"].to(act)).transpose(1, 2)
    dec = p["decoder"]
    w = _conv(W, h, dec["conv_in"])
    for blk, r in zip(dec["blocks"], c["upsample_rates"]):
        w = _tconv(W, _snake(w, blk["snake"], act), blk["tconv"], r)
        for ru, dil in zip(blk["res"], DILATIONS):
            y = _conv(W, _snake(w, ru["a1"], act), ru["c1"], dilation=dil)
            w = w + _conv(W, _snake(y, ru["a2"], act), ru["c2"])
    w = _conv(W, _snake(w, dec["snake_out"], act), dec["conv_out"])
    return torch.clamp(w[0, 0, startup_samples(c):].float(), -1.0, 1.0)


def startup_samples(c: dict) -> int:
    """Samples of the stream's run-in, which the one-shot decode trims."""
    rates = c["upsample_rates"]
    return sum(r * math.prod(rates[i + 1:]) for i, r in enumerate(rates))


def pcm16(wav: torch.Tensor) -> torch.Tensor:
    """Float waveform -> 16-bit PCM values (clamp, scale by 32767, round
    half away from zero), as float32."""
    s = torch.clamp(wav.float(), -1.0, 1.0) * 32767.0
    return torch.trunc(torch.where(s >= 0, s + 0.5, s - 0.5))
