"""Teacher-forced passes of the talker, the code predictor and code2wav.

The mathematics of the published Qwen3-TTS 12 Hz model as the program
implements it (a frozen copy of its plain code): a Qwen3 talker (pre-norm
RMSNorm, grouped-query attention with per-head q/k RMSNorm, rotate-half
RoPE, SwiGLU), the two-position depth transformer that predicts the 15
residual codebooks, and the code2wav decoder (mean code embedding,
sliding-window pre-transformer with LayerScale, ConvNeXt upsampling,
SnakeBeta decoder blocks). Everything runs over whole sequences with
causal masks: no cache, no batching of requests, no kernels. Matrix
products take float32 with TF32 off (``no_tf32``), or the precision's
activation type for the control.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from . import prompt
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


def _lin(x, w, act, b=None):
    y = x.to(act) @ w.to(act).t()
    return y if b is None else y + b.to(act)


def _rmsnorm(x, w, eps, act):
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (y * w.float()).to(act)


def _rope(x, theta, act):
    """Rotate-half RoPE over x [..., T, H, hd] at positions 0..T-1."""
    T, hd = x.shape[-3], x.shape[-1]
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64) / half)
    ang = torch.arange(T, dtype=torch.float64)[:, None] * inv[None, :]
    cos = torch.cos(ang).float().to(x.device)[:, None, :].to(act)
    sin = torch.sin(ang).float().to(x.device)[:, None, :].to(act)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1)


def _attend(q, k, v, allowed, act):
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


def _causal(T, device, window=None):
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


def _block(W: Weights, blocks: dict, i: int, x, *, n_heads, n_kv, hd, eps,
           theta, qk_norm, allowed):
    act = W.act
    a, m = blocks["attn"], blocks["mlp"]
    B, T, _ = x.shape
    h = _rmsnorm(x, blocks["ln1"][i], eps, act)
    q = _lin(h, W.lin(a["q"], i), act).reshape(B, T, n_heads, hd)
    k = _lin(h, W.lin(a["k"], i), act).reshape(B, T, n_kv, hd)
    v = _lin(h, W.lin(a["v"], i), act).reshape(B, T, n_kv, hd)
    if qk_norm:
        q = _rmsnorm(q, a["q_norm"][i], eps, act)
        k = _rmsnorm(k, a["k_norm"][i], eps, act)
    q, k = _rope(q, theta, act), _rope(k, theta, act)
    x = x + _lin(_attend(q, k, v, allowed, act), W.lin(a["o"], i), act)
    h = _rmsnorm(x, blocks["ln2"][i], eps, act)
    g = _lin(h, W.lin(m["gate"], i), act)
    u = _lin(h, W.lin(m["up"], i), act)
    return x + _lin(F.silu(g) * u, W.lin(m["down"], i), act)


def talker_pass(W: Weights, t: dict, x: torch.Tensor):
    """The talker over input rows x [T, D]: (hidden after the final norm
    [T, D], codec-head logits float32 [T, V])."""
    p = W.raw["talker"]
    act = W.act
    x = x.to(act)[None]
    allowed = _causal(x.shape[1], x.device)
    for i in range(t["n_layers"]):
        x = _block(W, p["blocks"], i, x, n_heads=t["n_heads"],
                   n_kv=t["n_kv_heads"], hd=t["head_dim"], eps=t["rms_eps"],
                   theta=t["rope_theta"], qk_norm=True, allowed=allowed)
    hidden = _rmsnorm(x, p["ln_f"], t["rms_eps"], act)[0]
    return hidden, _lin(hidden, W.lin(p["head"]), act).float()


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
    allowed = _causal(x.shape[1], x.device)
    for i in range(c["n_layers"]):
        x = _block(W, p["blocks"], i, x, n_heads=c["n_heads"],
                   n_kv=c["n_heads"], hd=c["head_dim"], eps=c["rms_eps"],
                   theta=c["rope_theta"], qk_norm=c["qk_norm"],
                   allowed=allowed)
    h = _rmsnorm(x, p["ln_f"], c["rms_eps"], act)[:, 1:1 + n_res]
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
    rows, trailing = prompt.assemble(tables, t, req["tokens"],
                                     req["speaker_id"])
    codes = req["codes"][:-1]                                  # frames 0..N-1
    n = codes.shape[0]
    res_emb = W.table(cp["res_emb"])
    fb = tables["codec_emb"][codes[:, 0]]
    for d in range(codes.shape[1] - 1):
        fb = fb + res_emb[d][codes[:, 1 + d]]
    steps = torch.arange(n, device=fb.device).clamp(max=trailing.shape[0] - 1)
    return torch.cat([rows, fb + trailing[steps]]), rows.shape[0]


def judge_tokens(W: Weights, cfg: dict, req: dict, block: int = 512):
    """(cb0 logits [N + 1, V], depth logits [N + 1, Q - 1, V]) at every
    served frame of one request, teacher-forced on its codes."""
    x, L = request_inputs(W, cfg, req)
    hidden, logits = talker_pass(W, cfg["talker"], x)
    h = hidden[L - 1:]                                         # frames 0..N
    codes = req["codes"]
    depth = torch.cat([
        predictor_pass(W, cfg["code_predictor"], h[i:i + block],
                       codes[i:i + block])
        for i in range(0, codes.shape[0], block)])
    return logits[L - 1:], depth


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
    allowed = _causal(T, x.device, c["sliding_window"])
    for i in range(c["n_layers"]):
        a, m = pre["blocks"]["attn"], pre["blocks"]["mlp"]
        h = _rmsnorm(x, pre["blocks"]["ln1"][i], c["rms_eps"], act)
        q = _rope(_lin(h, W.lin(a["q"], i), act).reshape(1, T, nh, hd),
                  c["rope_theta"], act)
        k = _rope(_lin(h, W.lin(a["k"], i), act).reshape(1, T, nkv, hd),
                  c["rope_theta"], act)
        v = _lin(h, W.lin(a["v"], i), act).reshape(1, T, nkv, hd)
        o = _lin(_attend(q, k, v, allowed, act), W.lin(a["o"], i), act)
        x = x + o * pre["blocks"]["ls_attn"][i].to(act)
        h = _rmsnorm(x, pre["blocks"]["ln2"][i], c["rms_eps"], act)
        g = _lin(h, W.lin(m["gate"], i), act)
        u = _lin(h, W.lin(m["up"], i), act)
        y = _lin(F.silu(g) * u, W.lin(m["down"], i), act)
        x = x + y * pre["blocks"]["ls_mlp"][i].to(act)
    h = _rmsnorm(x, pre["ln_f"], c["rms_eps"], act).transpose(1, 2)
    for stage, r in zip(p["upsample"], c["upsampling_ratios"]):
        h = _tconv(W, h, stage["tconv"], r)
        cnx = stage["cnx"]
        d = _conv(W, h, cnx["dw"], groups=h.shape[1])
        d = _layer_norm(d.transpose(1, 2), cnx["ln_w"], cnx["ln_b"], act)
        d = _lin(d, W.table(cnx["pw1"]["w"]), act, cnx["pw1"]["b"])
        d = F.gelu(d, approximate="none")
        d = _lin(d, W.table(cnx["pw2"]["w"]), act, cnx["pw2"]["b"])
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
