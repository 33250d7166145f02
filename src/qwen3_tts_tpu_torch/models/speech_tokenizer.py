"""Speech tokenizer: reference-audio waveform -> codec codes, in PyTorch.

A checkpoint of the Base (cloning) model ships the encoder that turns the
reference clip into codec codes. Its architecture family is the Mimi codec
(transformers ``models/mimi/modeling_mimi.py``): a SEANet conv encoder ->
a causal (optionally sliding-window) transformer -> a x2 strided
downsample -> a split residual vector quantizer:

    wav [B, n]  (sampling_rate, mono)
      -> SEANet: conv_in (K=7) -> per ratio [num_res x ResnetBlock, ELU,
         strided causal conv (K=2r, stride r, channels x2)] -> ELU ->
         conv_out (K=3) to hidden                                [B, T', H]
      -> transformer: pre-LN (LayerNorm with bias) GQA attention (RoPE,
         causal, optional sliding window) + LayerScale, exact-GELU fc1/fc2
         MLP + LayerScale                                        [B, T', H]
      -> optional x2 downsample conv (K=2*div, stride 2, replicate pad)
      -> split RVQ: semantic books then acoustic books, each family
         input-projected, euclidean-nearest encode               [B, Q, T]

Every conv is causal (left pad K_eff - stride, plus the "extra" right pad
that makes the last frame whole), so trailing zeros cannot change a whole
frame's codes. The geometry comes from the checkpoint's tensor shapes
(``st_config_from_tensors``); its config section fills what shapes cannot
say (head_dim, sliding window, rope theta). Runs in float32, off the decode
loop (once per reference clip). The import half works on numpy, as the JAX
package's does, so that the imported trees are bit-equal to its own; the
trees are then torch tensors.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from .layers import apply_rope, rope_tables

Params = dict[str, Any]


@dataclass(frozen=True)
class SpeechTokenizerConfig:
    """Geometry of the Mimi-family encoder. Field names mirror the HF
    ``MimiConfig`` where one exists; the defaults are the published Mimi
    values at 24 kHz."""

    # SEANet conv encoder
    audio_channels: int = 1
    num_filters: int = 64
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel_size: int = 3
    num_residual_layers: int = 1
    dilation_growth_rate: int = 2
    compress: int = 2
    # waveform-side order (largest first, as in MimiConfig); the encoder
    # applies them reversed (smallest ratio first)
    upsampling_ratios: tuple[int, ...] = (8, 6, 5, 4)
    # transformer
    hidden: int = 512
    n_layers: int = 8
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 64
    ffn: int = 2048
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    # None = full causal attention (what transformers' MimiModel builds on
    # this path); a checkpoint whose config sets a window gets it
    sliding_window: int | None = None
    # frame-rate downsample (encodec_frame_rate / frame_rate); 1 = absent
    frame_div: int = 2
    # split residual vector quantizer
    codebook_size: int = 2048
    codebook_dim: int = 256
    num_quantizers: int = 16
    num_semantic_quantizers: int = 1
    quant_input_proj: bool = True
    sampling_rate: int = 24_000

    @property
    def hop(self) -> int:
        """Waveform samples per emitted code frame."""
        return math.prod(self.upsampling_ratios) * (
            2 if self.frame_div > 1 else 1)

    @property
    def frame_rate(self) -> float:
        return self.sampling_rate / self.hop


# --------------------------------------------------------------------------
# init (numpy, the JAX package's draws in its order)
# --------------------------------------------------------------------------

def _conv(rng, out_ch, in_ch, k, dtype, bias=True, std=0.05) -> Params:
    p = {"w": rng.normal(0, std, (out_ch, in_ch, k)).astype(dtype)}
    if bias:
        p["b"] = np.zeros(out_ch, dtype=dtype)
    return p


def _dense(rng, out_dim, in_dim, dtype, std=0.02) -> Params:
    return {"w": rng.normal(0, std, (in_dim, out_dim)).astype(dtype)}


def init_speech_tokenizer(cfg: SpeechTokenizerConfig, seed: int = 7,
                          dtype=np.float32) -> Params:
    """A random numpy tree: conv weights [out, in, k], dense weights
    [in, out] (``x @ w``), codebooks [size, dim]."""
    rng = np.random.default_rng(seed)
    c = cfg

    stages = []
    ch = c.num_filters
    for ratio in reversed(c.upsampling_ratios):
        res = []
        for _ in range(c.num_residual_layers):
            hid = max(1, ch // c.compress)
            res.append({
                "c1": _conv(rng, hid, ch, c.residual_kernel_size, dtype),
                "c2": _conv(rng, ch, hid, 1, dtype),
            })
        stages.append({"res": res,
                       "down": _conv(rng, ch * 2, ch, 2 * ratio, dtype)})
        ch *= 2

    def block() -> Params:
        H, hd = c.hidden, c.head_dim
        return {
            "q": _dense(rng, c.n_heads * hd, H, dtype),
            "k": _dense(rng, c.n_kv_heads * hd, H, dtype),
            "v": _dense(rng, c.n_kv_heads * hd, H, dtype),
            "o": _dense(rng, H, c.n_heads * hd, dtype),
            "fc1": _dense(rng, c.ffn, H, dtype),
            "fc2": _dense(rng, H, c.ffn, dtype),
            "ln1_w": np.ones(H, dtype=dtype),
            "ln1_b": np.zeros(H, dtype=dtype),
            "ln2_w": np.ones(H, dtype=dtype),
            "ln2_b": np.zeros(H, dtype=dtype),
            "scale_attn": np.full(H, 0.01, dtype=dtype),
            "scale_mlp": np.full(H, 0.01, dtype=dtype),
        }

    def rvq(n_books: int) -> Params:
        q: Params = {"codebooks": [
            rng.normal(0, 1.0, (c.codebook_size, c.codebook_dim)).astype(dtype)
            for _ in range(n_books)]}
        if c.quant_input_proj:
            q["in_proj"] = _dense(rng, c.codebook_dim, c.hidden, dtype)
        return q

    params: Params = {
        "enc": {
            "conv_in": _conv(rng, c.num_filters, c.audio_channels,
                             c.kernel_size, dtype),
            "stages": stages,
            "conv_out": _conv(rng, c.hidden, ch, c.last_kernel_size, dtype),
        },
        "tf": [block() for _ in range(c.n_layers)],
        "quant": {
            "sem": rvq(c.num_semantic_quantizers),
            "ac": rvq(c.num_quantizers - c.num_semantic_quantizers),
        },
    }
    if c.frame_div > 1:
        params["down"] = _conv(rng, c.hidden, c.hidden, 2 * c.frame_div,
                               dtype, bias=False)
    return params


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _causal_pad(x: torch.Tensor, k: int, stride: int,
                mode: str = "constant") -> torch.Tensor:
    """Mimi/EnCodec causal padding of x [B, C, n]: ``k - stride`` on the
    left, plus the "extra" right pad that makes the final (partial) frame
    whole (transformers MimiConv1d._get_extra_padding_for_conv1d)."""
    n = x.shape[-1]
    pad_total = k - stride
    n_frames = -(-(n - k + pad_total) // stride)
    extra = max(0, n_frames * stride + k - pad_total - n)
    if mode == "replicate":
        parts = [x[..., :1].expand(*x.shape[:-1], pad_total), x]
        if extra:
            parts.append(x[..., -1:].expand(*x.shape[:-1], extra))
        return torch.cat(parts, dim=-1)
    return F.pad(x, (pad_total, extra))


def _causal_conv(x: torch.Tensor, p: Params, *, stride: int = 1,
                 dilation: int = 1, mode: str = "constant") -> torch.Tensor:
    """A causal conv on x [B, C, n], torch-layout weight [out, in, k]."""
    k_eff = (p["w"].shape[-1] - 1) * dilation + 1
    return F.conv1d(_causal_pad(x, k_eff, stride, mode), p["w"].to(x.dtype),
                    p["b"].to(x.dtype) if "b" in p else None,
                    stride=stride, dilation=dilation)


def seanet_encode(params: Params, cfg: SpeechTokenizerConfig,
                  wav: torch.Tensor) -> torch.Tensor:
    """wav [B, n] -> latents [B, T', hidden] at the pre-downsample rate."""
    enc = params["enc"]
    x = _causal_conv(wav[:, None, :], enc["conv_in"])
    for stage, ratio in zip(enc["stages"], reversed(cfg.upsampling_ratios)):
        for j, res in enumerate(stage["res"]):
            d = cfg.dilation_growth_rate ** j
            y = _causal_conv(F.elu(x), res["c1"], dilation=d)
            y = _causal_conv(F.elu(y), res["c2"])
            x = x + y
        x = _causal_conv(F.elu(x), stage["down"], stride=ratio)
    x = _causal_conv(F.elu(x), enc["conv_out"])
    return x.transpose(1, 2)


def _layer_norm(x, w, b, eps):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def st_transformer(params: Params, cfg: SpeechTokenizerConfig,
                   x: torch.Tensor) -> torch.Tensor:
    """The causal (optionally sliding-window) transformer over latents
    [B, T, H]."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    cos_t, sin_t = rope_tables(T, hd, cfg.rope_theta, x.device)
    i = torch.arange(T, device=x.device)[:, None]
    j = torch.arange(T, device=x.device)[None, :]
    allowed = j <= i
    if cfg.sliding_window is not None:
        allowed &= i - j < cfg.sliding_window
    bias = torch.zeros((T, T), dtype=torch.float32, device=x.device)
    bias = bias.masked_fill(~allowed, torch.finfo(torch.float32).min)

    for blk in params["tf"]:
        h = _layer_norm(x, blk["ln1_w"], blk["ln1_b"], cfg.norm_eps)
        q = (h @ blk["q"]["w"]).reshape(B, T, cfg.n_heads, hd)
        k = (h @ blk["k"]["w"]).reshape(B, T, cfg.n_kv_heads, hd)
        v = (h @ blk["v"]["w"]).reshape(B, T, cfg.n_kv_heads, hd)
        q = apply_rope(q, cos_t, sin_t)
        k = apply_rope(k, cos_t, sin_t)
        if cfg.n_kv_heads != cfg.n_heads:
            rep = cfg.n_heads // cfg.n_kv_heads
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
        scores = torch.einsum("bthd,bshd->bhts", q, k) / np.sqrt(hd)
        probs = torch.softmax(scores.float() + bias, dim=-1)
        ctx = torch.einsum("bhts,bshd->bthd", probs.to(x.dtype), v)
        x = x + (ctx.reshape(B, T, -1) @ blk["o"]["w"]) * blk["scale_attn"]
        h = _layer_norm(x, blk["ln2_w"], blk["ln2_b"], cfg.norm_eps)
        mlp = F.gelu(h @ blk["fc1"]["w"], approximate="none")
        x = x + (mlp @ blk["fc2"]["w"]) * blk["scale_mlp"]
    return x


def _rvq_encode(q: Params, x: torch.Tensor, n_books: int) -> torch.Tensor:
    """Residual euclidean-nearest encode: x [B, T, D_in] -> [B, n, T].
    argmin |r - c|^2 is taken as argmin (|c|^2 - 2 r.c), as the JAX
    package does: no [B, T, S, D] difference tensor."""
    if "in_proj" in q:
        x = x @ q["in_proj"]["w"]
    residual = x.float()
    out = []
    for b in range(n_books):
        cb = q["codebooks"][b].float()                       # [S, D]
        d2 = torch.sum(cb * cb, dim=-1)[None, None, :] - 2.0 * (residual @ cb.T)
        idx = torch.argmin(d2, dim=-1)                       # [B, T]
        out.append(idx)
        residual = residual - cb[idx]
    return torch.stack(out, dim=1)


def st_encode(params: Params, cfg: SpeechTokenizerConfig,
              wav: torch.Tensor) -> torch.Tensor:
    """Full encode: wav [B, n] -> codec codes [B, Q, T] (int64; semantic
    books first, then acoustic, the order the codec decoder consumes)."""
    lat = st_transformer(params, cfg, seanet_encode(params, cfg, wav))
    if "down" in params:
        x = _causal_conv(lat.transpose(1, 2), params["down"], stride=2,
                         mode="replicate")
        lat = x.transpose(1, 2)                              # [B, T, H]
    sem = _rvq_encode(params["quant"]["sem"], lat, cfg.num_semantic_quantizers)
    n_ac = cfg.num_quantizers - cfg.num_semantic_quantizers
    if n_ac:
        ac = _rvq_encode(params["quant"]["ac"], lat, n_ac)
        return torch.cat([sem, ac], dim=1)
    return sem


def st_frames(cfg: SpeechTokenizerConfig, n_samples: int) -> int:
    """Code frames ``st_encode`` emits for an n-sample clip (every conv
    pads to whole output frames: ceil division through the strides)."""
    t = n_samples
    for ratio in reversed(cfg.upsampling_ratios):
        t = -(-t // ratio)
    if cfg.frame_div > 1:
        t = -(-t // 2)
    return max(1, t)


# --------------------------------------------------------------------------
# checkpoint import (Mimi tensor layout)
# --------------------------------------------------------------------------

_ENC_CONV = re.compile(r"^encoder\.layers\.(\d+)\.conv\.(weight|bias)$")
_ENC_RES = re.compile(
    r"^encoder\.layers\.(\d+)\.block\.(1|3)\.conv\.(weight|bias)$")
_TF = re.compile(r"^encoder_transformer\.layers\.(\d+)\.(.+)$")
_QUANT = re.compile(
    r"^quantizer\.(semantic|acoustic)_residual_vector_quantizer\.(.+)$")
_CB = re.compile(r"^layers\.(\d+)\.codebook\.(embed_sum|cluster_usage"
                 r"|embed|initialized)$")


def _np32(arr) -> np.ndarray:
    """A checkpoint tensor (torch, bf16 included, or numpy) as float32
    numpy (exact widening)."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().float().numpy()
    return np.asarray(arr, np.float32)


def st_config_from_tensors(tensors: dict, hf_cfg: dict | None = None
                           ) -> SpeechTokenizerConfig:
    """The encoder geometry from checkpoint tensor shapes (Mimi layout,
    names without the ``speech_tokenizer.`` prefix). Raises ValueError when
    the layout is not recognised: callers then preserve the tensors.
    ``hf_cfg`` (the checkpoint's ``speech_tokenizer_config`` section) fills
    the fields shapes cannot express."""
    hf = hf_cfg or {}

    conv_w = {}
    for name, arr in tensors.items():
        m = _ENC_CONV.match(name)
        if m and m.group(2) == "weight":
            conv_w[int(m.group(1))] = tuple(arr.shape)
    if 0 not in conv_w or len(conv_w) < 2:
        raise ValueError("speech_tokenizer layout not recognised: no "
                         "Mimi-style encoder.layers.N.conv tensors")
    idxs = sorted(conv_w)
    num_filters, audio_channels, kernel_size = conv_w[idxs[0]]
    hidden, _, last_kernel = conv_w[idxs[-1]]
    # interior convs are the strided downsamples: ratio = K // 2
    ratios_enc_order = [conv_w[i][-1] // 2 for i in idxs[1:-1]]
    if not ratios_enc_order or any(r < 1 for r in ratios_enc_order):
        raise ValueError("speech_tokenizer layout not recognised: no "
                         "downsample convs")

    res_by_stage: dict[int, int] = {}
    res_kernel, compress = 3, 2
    for name, arr in tensors.items():
        m = _ENC_RES.match(name)
        if m and m.group(2) == "1" and m.group(3) == "weight":
            li = int(m.group(1))
            stage = sum(1 for i in idxs[1:-1] if i < li)
            res_by_stage[stage] = res_by_stage.get(stage, 0) + 1
            hid, dim, res_kernel = tuple(arr.shape)
            compress = max(1, dim // max(1, hid))
    num_res = res_by_stage.get(0, 1)

    tf_layers: set[int] = set()
    ffn = q_rows = kv_rows = None
    for name, arr in tensors.items():
        m = _TF.match(name)
        if not m:
            continue
        tf_layers.add(int(m.group(1)))
        if m.group(2) == "mlp.fc1.weight":
            ffn = arr.shape[0]
        elif m.group(2) == "self_attn.q_proj.weight":
            q_rows = arr.shape[0]
        elif m.group(2) == "self_attn.k_proj.weight":
            kv_rows = arr.shape[0]
    if not tf_layers or ffn is None or q_rows is None:
        raise ValueError("speech_tokenizer layout not recognised: no "
                         "Mimi-style encoder_transformer tensors")

    head_dim = int(hf.get("head_dim", 64))
    if q_rows % head_dim:
        head_dim = q_rows // int(hf.get("num_attention_heads", 8))
    n_heads = int(hf.get("num_attention_heads", q_rows // head_dim))
    n_kv = int(hf.get("num_key_value_heads", (kv_rows or q_rows) // head_dim))

    sem_books = ac_books = 0
    cb_size = cb_dim = None
    has_in_proj = False
    for name, arr in tensors.items():
        m = _QUANT.match(name)
        if not m:
            continue
        fam, rest = m.groups()
        if rest == "input_proj.weight":
            has_in_proj = True
        cm = _CB.match(rest)
        if cm and cm.group(2) in ("embed_sum", "embed"):
            if fam == "semantic":
                sem_books += 1
            else:
                ac_books += 1
            cb_size, cb_dim = tuple(arr.shape)
    if cb_size is None:
        raise ValueError("speech_tokenizer layout not recognised: no "
                         "quantizer codebooks")

    down = tensors.get("downsample.conv.weight")
    frame_div = (down.shape[-1] // 2) if down is not None else 1

    return SpeechTokenizerConfig(
        audio_channels=audio_channels,
        num_filters=num_filters,
        kernel_size=kernel_size,
        last_kernel_size=last_kernel,
        residual_kernel_size=res_kernel,
        num_residual_layers=num_res,
        dilation_growth_rate=int(hf.get("dilation_growth_rate", 2)),
        compress=compress,
        upsampling_ratios=tuple(reversed(ratios_enc_order)),
        hidden=hidden,
        n_layers=len(tf_layers),
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        ffn=ffn,
        norm_eps=float(hf.get("norm_eps", 1e-5)),
        rope_theta=float(hf.get("rope_theta", 10_000.0)),
        sliding_window=(int(hf["sliding_window"])
                        if hf.get("sliding_window") is not None else None),
        frame_div=frame_div,
        codebook_size=cb_size,
        codebook_dim=cb_dim,
        num_quantizers=sem_books + ac_books,
        num_semantic_quantizers=max(1, sem_books),
        quant_input_proj=has_in_proj,
        sampling_rate=int(hf.get("sampling_rate", 24_000)),
    )


def import_speech_tokenizer(tensors: dict, cfg: SpeechTokenizerConfig,
                            unmapped: list[str]) -> tuple[Params, int]:
    """Map Mimi-layout ``speech_tokenizer.*`` tensors (prefix stripped)
    onto the tree of ``init_speech_tokenizer(cfg)`` (its seed's values stay
    where nothing maps). Returns (float32 tensor tree, tensors mapped);
    names that do not fit land in ``unmapped`` as
    ``speech_tokenizer:<name> (<why>)``."""
    params = init_speech_tokenizer(cfg)
    count = 0
    eps = 1e-5

    # encoder conv index map: conv_in, per stage [res..., ELU, down], conv_out
    n_stages = len(cfg.upsampling_ratios)
    per_stage = cfg.num_residual_layers + 2

    def enc_slot(li: int):
        if li == 0:
            return params["enc"]["conv_in"], None
        if li == 1 + n_stages * per_stage + 1:
            return params["enc"]["conv_out"], None
        stage, off = divmod(li - 1, per_stage)
        if stage >= n_stages:
            return None, None
        if off < cfg.num_residual_layers:
            return None, (stage, off)                # a resnet block
        if off == cfg.num_residual_layers + 1:
            return params["enc"]["stages"][stage]["down"], None
        return None, None                            # the ELU slot

    # cluster_usage normalises embed_sum into the codebook
    usage: dict[tuple[str, int], np.ndarray] = {}
    for name, arr in tensors.items():
        m = _QUANT.match(name)
        if m:
            cm = _CB.match(m.group(2))
            if cm and cm.group(2) == "cluster_usage":
                usage[(m.group(1), int(cm.group(1)))] = _np32(arr)

    def put(slot: dict, key: str, arr: np.ndarray, name: str) -> None:
        nonlocal count
        if key in slot and np.shape(slot[key]) == np.shape(arr):
            slot[key] = np.asarray(arr, np.float32)
            count += 1
        else:
            unmapped.append(f"speech_tokenizer:{name} (shape mismatch)")

    tf_key = {
        "self_attn.q_proj.weight": "q", "self_attn.k_proj.weight": "k",
        "self_attn.v_proj.weight": "v", "self_attn.o_proj.weight": "o",
        "mlp.fc1.weight": "fc1", "mlp.fc2.weight": "fc2",
    }
    tf_vec = {
        "input_layernorm.weight": "ln1_w", "input_layernorm.bias": "ln1_b",
        "post_attention_layernorm.weight": "ln2_w",
        "post_attention_layernorm.bias": "ln2_b",
        "self_attn_layer_scale.scale": "scale_attn",
        "mlp_layer_scale.scale": "scale_mlp",
    }

    for name in sorted(tensors):
        arr = _np32(tensors[name])
        m = _ENC_CONV.match(name)
        if m:
            slot, _ = enc_slot(int(m.group(1)))
            if slot is None:
                unmapped.append(f"speech_tokenizer:{name} (no slot)")
            else:
                put(slot, "w" if m.group(2) == "weight" else "b", arr, name)
            continue
        m = _ENC_RES.match(name)
        if m:
            _, res_pos = enc_slot(int(m.group(1)))
            if res_pos is None:
                unmapped.append(f"speech_tokenizer:{name} (no slot)")
                continue
            stage, j = res_pos
            blk = params["enc"]["stages"][stage]["res"][j]
            sub = blk["c1"] if m.group(2) == "1" else blk["c2"]
            put(sub, "w" if m.group(3) == "weight" else "b", arr, name)
            continue
        m = _TF.match(name)
        if m:
            li, rest = int(m.group(1)), m.group(2)
            if li >= cfg.n_layers:
                unmapped.append(f"speech_tokenizer:{name} (layer oob)")
                continue
            blk = params["tf"][li]
            if rest in tf_key:
                # torch Linear [out, in] -> the x @ w layout [in, out]
                put(blk[tf_key[rest]], "w", arr.T, name)
            elif rest in tf_vec:
                if np.shape(blk[tf_vec[rest]]) == np.shape(arr):
                    blk[tf_vec[rest]] = arr
                    count += 1
                else:
                    unmapped.append(f"speech_tokenizer:{name} (shape mismatch)")
            elif "rotary_emb" in rest:
                count += 1                           # derived, not stored
            else:
                unmapped.append(f"speech_tokenizer:{name} (no mapping)")
            continue
        if name == "downsample.conv.weight":
            if "down" in params:
                put(params["down"], "w", arr, name)
            else:
                unmapped.append(f"speech_tokenizer:{name} (no downsample)")
            continue
        m = _QUANT.match(name)
        if m:
            q = params["quant"]["sem" if m.group(1) == "semantic" else "ac"]
            rest = m.group(2)
            if rest == "input_proj.weight":          # conv1x1 [D, H, 1]
                put(q["in_proj"], "w", arr[..., 0].T, name)
                continue
            if rest == "output_proj.weight":
                count += 1                           # decode side, unused
                continue
            cm = _CB.match(rest)
            if cm:
                bi, kind = int(cm.group(1)), cm.group(2)
                if bi >= len(q["codebooks"]):
                    unmapped.append(f"speech_tokenizer:{name} (book oob)")
                elif kind in ("embed_sum", "embed"):
                    cb = arr
                    if kind == "embed_sum":
                        u = usage.get((m.group(1), bi))
                        if u is not None:
                            cb = cb / np.clip(u, eps, None)[:, None]
                    if np.shape(q["codebooks"][bi]) == np.shape(cb):
                        q["codebooks"][bi] = cb
                        count += 1
                    else:
                        unmapped.append(
                            f"speech_tokenizer:{name} (shape mismatch)")
                else:
                    count += 1                       # usage/init markers
                continue
            unmapped.append(f"speech_tokenizer:{name} (no mapping)")
            continue
        if name.startswith(("decoder.", "decoder_transformer.", "upsample.")):
            count += 1  # the decode half of a full-codec package: decoding
            continue    # runs through the model's own codec
        unmapped.append(f"speech_tokenizer:{name} (no mapping)")

    from ..engine.weights import tree_to

    return tree_to(params, "cpu"), count
