"""Whisper-class ASR in PyTorch (the JAX package's models/whisper.py):
the transcription model behind ``transcription.py`` and ``quality.py``.

Plain functions on tensors, in float32 as the JAX package computes it:

- the log-mel frontend (hann STFT at hop 160 over the 30 s window, the
  Slaney mel bank, log10 with a floor 8 below the window's max, then
  (x+4)/4), as transformers' WhisperFeatureExtractor;
- the encoder (two convolutions, stride 1 then 2, exact GELU, sinusoid
  positions from the checkpoint, pre-norm blocks);
- the decoder step with a self-attention KV cache, cross K/V computed once
  per window, and the head tied to the token embedding;
- ``greedy_decode``: the JAX package's fixed-length scan with a done mask
  gives, for the tokens after the forced prefix, every sampled token up to
  and including the first EOS, then EOS. This loop stops once EOS has been
  emitted and pads with EOS, so the tokens and ``n_valid`` are the same;
- ``import_hf_whisper``: HF checkpoints (``model.safetensors`` through
  ``engine/safetensors_io.py``, F16/BF16/F32 widened to float32, or
  ``pytorch_model.bin``) into the JAX package's tree, its stacked layers
  as stacked tensors;
- ``WhisperASR``: a loaded checkpoint with its detokenizer
  (``engine/tokenizer.py::WhisperTokenizer``; no ``transformers``), on the
  CUDA device unless QWEN3_TTS_ASR_DEVICE=cpu.

The linears, attention and norms are ordinary torch ops: the JAX package
computes them as XLA ops, with no Pallas kernel.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

Params = dict[str, Any]

SAMPLE_RATE = 16_000
N_FFT = 400
HOP = 160
CHUNK_SECONDS = 30
N_SAMPLES = CHUNK_SECONDS * SAMPLE_RATE  # 480_000


@dataclass(frozen=True)
class WhisperConfig:
    d_model: int = 384
    encoder_layers: int = 4
    decoder_layers: int = 4
    n_heads: int = 6
    ffn: int = 1536
    n_mels: int = 80
    max_source_positions: int = 1500
    max_target_positions: int = 448
    vocab_size: int = 51_865
    eos_token_id: int = 50_257
    decoder_start_token_id: int = 50_258

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def from_hf(d: dict) -> "WhisperConfig":
        return WhisperConfig(
            d_model=d["d_model"],
            encoder_layers=d["encoder_layers"],
            decoder_layers=d["decoder_layers"],
            n_heads=d["encoder_attention_heads"],
            ffn=d["encoder_ffn_dim"],
            n_mels=d["num_mel_bins"],
            max_source_positions=d["max_source_positions"],
            max_target_positions=d["max_target_positions"],
            vocab_size=d["vocab_size"],
            eos_token_id=d.get("eos_token_id", 50_257),
            decoder_start_token_id=d.get("decoder_start_token_id", 50_258),
        )


# --------------------------------------------------------------------------
# log-mel frontend
# --------------------------------------------------------------------------

def _hz_to_mel_slaney(f: np.ndarray | float) -> np.ndarray | float:
    """Slaney mel scale: linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3)
    logstep = math.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz,
        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
        f / (200.0 / 3),
    )


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3)
    logstep = math.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel,
        min_log_hz * np.exp(logstep * (m - min_log_mel)),
        m * (200.0 / 3),
    )


def mel_filters(n_mels: int) -> np.ndarray:
    """[n_freq=201, n_mels] slaney-normalized triangular filter bank (the
    matrix of transformers' mel_filter_bank(norm='slaney',
    mel_scale='slaney'))."""
    n_freq = 1 + N_FFT // 2
    fft_freqs = np.linspace(0, SAMPLE_RATE / 2, n_freq)
    mel_pts = np.linspace(
        _hz_to_mel_slaney(0.0), _hz_to_mel_slaney(8000.0), n_mels + 2
    )
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    slopes = hz_pts[None, :] - fft_freqs[:, None]  # [F, n_mels+2]
    down = -slopes[:, :-2] / fdiff[None, :-1]
    up = slopes[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    return (fb * enorm[None, :]).astype(np.float32)


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80,
                        filters: torch.Tensor | None = None) -> torch.Tensor:
    """[N_SAMPLES] float32 mono 16 kHz -> [3000, n_mels] log-mel features,
    on ``audio``'s device. ``filters`` is ``mel_filters(n_mels)`` there
    (made when not given). The last frame of the 3001-frame STFT is
    dropped, as the feature extractor does."""
    pad = N_FFT // 2
    x = F.pad(audio.float()[None, None], (pad, pad), mode="reflect")[0, 0]
    frames = x.unfold(0, N_FFT, HOP)[: N_SAMPLES // HOP]  # [3000, 400]
    n = torch.arange(N_FFT, device=x.device, dtype=torch.float32)
    window = 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / N_FFT))
    power = torch.fft.rfft(frames * window, dim=-1).abs() ** 2  # [T, 201]
    if filters is None:
        filters = torch.from_numpy(mel_filters(n_mels)).to(x.device)
    log_spec = torch.log10(torch.clamp(power @ filters, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


def pad_or_trim(audio: np.ndarray) -> np.ndarray:
    """Zero-pad / trim a mono float waveform to the 30 s window."""
    if len(audio) >= N_SAMPLES:
        return audio[:N_SAMPLES]
    return np.pad(audio, (0, N_SAMPLES - len(audio)))


# --------------------------------------------------------------------------
# model blocks
# --------------------------------------------------------------------------

def _layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["w"], p["b"], eps)


def _linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    return F.linear(x, p["w"], p.get("b"))  # HF stores [out, in]


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    # [T, D] -> [n_heads, T, head_dim]
    T, D = x.shape
    return x.reshape(T, n_heads, D // n_heads).transpose(0, 1)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
    """q [H, Tq, hd] (already scaled), k/v [H, Tk, hd] -> [Tq, H*hd]."""
    probs = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    out = probs @ v                                  # [H, Tq, hd]
    return out.transpose(0, 1).reshape(q.shape[1], -1)


def _mha(p: Params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    hd = x.shape[-1] // n_heads
    q = _split_heads(_linear(x, p["q"]) * hd ** -0.5, n_heads)
    k = _split_heads(_linear(x, p["k"]), n_heads)
    v = _split_heads(_linear(x, p["v"]), n_heads)
    return _linear(_attention(q, k, v), p["o"])


def _mlp(p: Params, h: torch.Tensor) -> torch.Tensor:
    return _linear(F.gelu(_linear(h, p["fc1"])), p["fc2"])  # exact GELU


def layer(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a stacked layer tree (views, no copies)."""
    if isinstance(stacked, dict):
        return {k: layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def encode(params: Params, cfg: WhisperConfig,
           features: torch.Tensor) -> torch.Tensor:
    """[3000, n_mels] log-mel -> [T_enc, D] encoder states (T_enc=1500)."""
    x = features.T[None]  # [1, n_mels, T] for conv over time
    x = F.gelu(F.conv1d(x, params["conv1"]["w"], params["conv1"]["b"],
                        padding=1))
    x = F.gelu(F.conv1d(x, params["conv2"]["w"], params["conv2"]["b"],
                        stride=2, padding=1))
    x = x[0].T  # [T_enc, D]
    x = x + params["enc_pos"][: x.shape[0]]
    for i in range(cfg.encoder_layers):
        lp = layer(params["enc_layers"], i)
        x = x + _mha(lp["attn"], _layer_norm(x, lp["ln1"]), cfg.n_heads)
        x = x + _mlp(lp, _layer_norm(x, lp["ln2"]))
    return _layer_norm(x, params["enc_ln"])


def cross_kv(params: Params, cfg: WhisperConfig,
             enc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-layer cross-attention K/V of the encoder states:
    [L, H, T_enc, hd] each."""
    ks, vs = [], []
    for i in range(cfg.decoder_layers):
        xa = layer(params["dec_layers"], i)["xattn"]
        ks.append(_split_heads(_linear(enc, xa["k"]), cfg.n_heads))
        vs.append(_split_heads(_linear(enc, xa["v"]), cfg.n_heads))
    return torch.stack(ks), torch.stack(vs)


def decoder_step(
    params: Params,
    cfg: WhisperConfig,
    tok: int,
    pos: int,
    cache_k: torch.Tensor,       # [L, T_max, H, hd], written at ``pos``
    cache_v: torch.Tensor,
    cross_k: torch.Tensor,       # [L, H, T_enc, hd]
    cross_v: torch.Tensor,
    layers: list | None = None,
) -> torch.Tensor:
    """One decode step: the logits [V] after token ``tok`` at ``pos``; the
    step's keys and values are written into the caches in place. Attention
    reads the cache's first ``pos + 1`` rows (the rows the JAX package's
    mask keeps). ``layers``: the decoder's per-layer views, made once per
    window by the caller (made here when not given)."""
    H, hd = cfg.n_heads, cfg.head_dim
    if layers is None:
        layers = [layer(params["dec_layers"], i)
                  for i in range(cfg.decoder_layers)]
    x = (params["tok_emb"][tok] + params["dec_pos"][pos])[None]  # [1, D]
    for i, lp in enumerate(layers):
        h = _layer_norm(x, lp["ln1"])
        q = _split_heads(_linear(h, lp["attn"]["q"]) * hd ** -0.5, H)
        cache_k[i, pos] = _linear(h, lp["attn"]["k"]).reshape(H, hd)
        cache_v[i, pos] = _linear(h, lp["attn"]["v"]).reshape(H, hd)
        out = _attention(q, cache_k[i, : pos + 1].transpose(0, 1),
                         cache_v[i, : pos + 1].transpose(0, 1))
        x = x + _linear(out, lp["attn"]["o"])
        h = _layer_norm(x, lp["ln_x"])
        qx = _split_heads(_linear(h, lp["xattn"]["q"]) * hd ** -0.5, H)
        x = x + _linear(_attention(qx, cross_k[i], cross_v[i]),
                        lp["xattn"]["o"])
        x = x + _mlp(lp, _layer_norm(x, lp["ln2"]))
    x = _layer_norm(x, params["dec_ln"])
    return (x @ params["tok_emb"].T)[0]  # tied head


def greedy_decode(
    params: Params,
    cfg: WhisperConfig,
    features: torch.Tensor,      # [3000, n_mels]
    prefix,                      # [P] int forced prefix (sot, lang, ...)
    max_new: int = 0,
) -> tuple[np.ndarray, int]:
    """Transcribe one 30 s window: (tokens int32 [max_new], n_valid), the
    JAX package's result. The prefix is teacher-forced; generation stops
    once EOS is emitted and the rest of ``tokens`` is EOS."""
    prefix = [int(t) for t in np.asarray(prefix).reshape(-1)]
    P = len(prefix)
    if max_new <= 0:
        max_new = cfg.max_target_positions - P
    if P + max_new > cfg.max_target_positions:
        raise ValueError(
            f"a {P}-token prefix and {max_new} new tokens need more than the "
            f"checkpoint's {cfg.max_target_positions} decoder positions")
    enc = encode(params, cfg, features)
    ck_x, cv_x = cross_kv(params, cfg, enc)
    shape = (cfg.decoder_layers, P + max_new, cfg.n_heads, cfg.head_dim)
    cache_k = torch.zeros(shape, dtype=enc.dtype, device=enc.device)
    cache_v = torch.zeros_like(cache_k)
    eos = cfg.eos_token_id
    layers = [layer(params["dec_layers"], i) for i in range(cfg.decoder_layers)]
    gen: list[int] = []
    tok = prefix[0]
    for pos in range(P + max_new):
        logits = decoder_step(params, cfg, tok, pos, cache_k, cache_v,
                              ck_x, cv_x, layers)
        if pos + 1 < P:           # inside the forced prefix
            tok = prefix[pos + 1]
            continue
        tok = int(torch.argmax(logits))
        gen.append(tok)
        if tok == eos or len(gen) == max_new:
            break
    n_valid = gen.index(eos) if eos in gen else max_new
    tokens = np.full(max_new, eos, np.int32)
    tokens[: len(gen)] = gen
    return tokens, n_valid


# --------------------------------------------------------------------------
# HF checkpoint import
# --------------------------------------------------------------------------

def _stack(trees: list) -> Params:
    """A list of per-layer trees -> one tree of [L, ...] tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _read_raw(model_dir: str) -> dict[str, torch.Tensor]:
    """The checkpoint's tensors as float32 CPU tensors, ``model.`` prefix
    removed."""
    st_path = os.path.join(model_dir, "model.safetensors")
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(st_path):
        from ..engine.safetensors_io import load_file

        raw = load_file(st_path)
    elif os.path.exists(bin_path):
        raw = torch.load(bin_path, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(
            f"{model_dir}: no model.safetensors or pytorch_model.bin"
        )
    return {k.removeprefix("model."): v.float() for k, v in raw.items()}


def import_hf_whisper(model_dir: str) -> tuple[Params, WhisperConfig]:
    """Load an HF Whisper checkpoint into the JAX package's tree layout
    (float32 CPU tensors). Raises FileNotFoundError/KeyError on a layout
    it cannot map: a half-mapped ASR model must never load."""
    with open(os.path.join(model_dir, "config.json")) as fh:
        cfg = WhisperConfig.from_hf(json.load(fh))
    raw = _read_raw(model_dir)

    def lin(prefix: str) -> Params:
        p = {"w": raw[f"{prefix}.weight"]}
        if f"{prefix}.bias" in raw:
            p["b"] = raw[f"{prefix}.bias"]
        return p

    def attn(prefix: str) -> Params:
        return {
            "q": lin(f"{prefix}.q_proj"),
            "k": lin(f"{prefix}.k_proj"),  # no bias in checkpoints
            "v": lin(f"{prefix}.v_proj"),
            "o": lin(f"{prefix}.out_proj"),
        }

    def ln(prefix: str) -> Params:
        return {"w": raw[f"{prefix}.weight"], "b": raw[f"{prefix}.bias"]}

    def enc_layer(i: int) -> Params:
        p = f"encoder.layers.{i}"
        return {
            "attn": attn(f"{p}.self_attn"),
            "ln1": ln(f"{p}.self_attn_layer_norm"),
            "fc1": lin(f"{p}.fc1"),
            "fc2": lin(f"{p}.fc2"),
            "ln2": ln(f"{p}.final_layer_norm"),
        }

    def dec_layer(i: int) -> Params:
        p = f"decoder.layers.{i}"
        return {
            "attn": attn(f"{p}.self_attn"),
            "ln1": ln(f"{p}.self_attn_layer_norm"),
            "xattn": attn(f"{p}.encoder_attn"),
            "ln_x": ln(f"{p}.encoder_attn_layer_norm"),
            "fc1": lin(f"{p}.fc1"),
            "fc2": lin(f"{p}.fc2"),
            "ln2": ln(f"{p}.final_layer_norm"),
        }

    params: Params = {
        "conv1": {"w": raw["encoder.conv1.weight"],
                  "b": raw["encoder.conv1.bias"]},
        "conv2": {"w": raw["encoder.conv2.weight"],
                  "b": raw["encoder.conv2.bias"]},
        "enc_pos": raw["encoder.embed_positions.weight"],
        "enc_layers": _stack(
            [enc_layer(i) for i in range(cfg.encoder_layers)]
        ),
        "enc_ln": ln("encoder.layer_norm"),
        "tok_emb": raw["decoder.embed_tokens.weight"],
        "dec_pos": raw["decoder.embed_positions.weight"],
        "dec_layers": _stack(
            [dec_layer(i) for i in range(cfg.decoder_layers)]
        ),
        "dec_ln": ln("decoder.layer_norm"),
    }
    return params, cfg


# --------------------------------------------------------------------------
# high-level ASR wrapper (what transcription.py's provider calls)
# --------------------------------------------------------------------------

def asr_device(device=None) -> torch.device:
    """Where ASR runs: QWEN3_TTS_ASR_DEVICE=cpu pins it to the CPU (the TTS
    engine usually owns the card's memory in the same process); otherwise
    ``device``, by default the CUDA device (raises without one)."""
    from ..engine.api import resolve_device

    if os.environ.get("QWEN3_TTS_ASR_DEVICE", "auto") == "cpu":
        return torch.device("cpu")
    return resolve_device(device)


class WhisperASR:
    """One loaded Whisper checkpoint + its detokenizer, ready to transcribe
    WAV files window by window (30 s windows, joined without carry:
    enrollment references are a few seconds long)."""

    def __init__(self, model_dir: str, device=None):
        import time

        from ..engine.tokenizer import WhisperTokenizer
        from ..engine.weights import tree_to

        self.device = asr_device(device)
        t0 = time.perf_counter()
        params, self.cfg = import_hf_whisper(model_dir)
        t1 = time.perf_counter()
        self.params = tree_to(params, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.load_times = {"import_s": t1 - t0,
                           "to_device_s": time.perf_counter() - t1}
        self.filters = torch.from_numpy(mel_filters(self.cfg.n_mels)).to(
            self.device)
        self.tokenizer = WhisperTokenizer(model_dir)
        self.prefix = self._build_prefix()

    def _build_prefix(self) -> np.ndarray:
        """<|startoftranscript|> [<|lang|> <|transcribe|> <|notimestamps|>]:
        multilingual checkpoints carry the task tokens, English-only ones
        (a vocabulary without them) fall back to the start token alone."""
        ids = [self.cfg.decoder_start_token_id]
        lang = os.environ.get("QWEN3_TTS_ASR_LANG", "en")
        for tok_str in (f"<|{lang}|>", "<|transcribe|>", "<|notimestamps|>"):
            tid = self.tokenizer.token_to_id(tok_str)
            if tid is None:
                break
            ids.append(tid)
        return np.asarray(ids, np.int32)

    def decode_window(self, window: np.ndarray, *, max_new: int = 224
                      ) -> tuple[np.ndarray, int]:
        """One padded 30 s window -> (tokens, n_valid)."""
        with torch.no_grad():
            audio = torch.from_numpy(np.asarray(window, np.float32)).to(
                self.device)
            feats = log_mel_spectrogram(audio, self.cfg.n_mels, self.filters)
            return greedy_decode(self.params, self.cfg, feats, self.prefix,
                                 max_new=max_new)

    def transcribe_array(
        self, audio: np.ndarray, rate: int, *, max_new: int = 224
    ) -> str:
        """Mono float waveform -> text."""
        from ..audio import resample

        if rate != SAMPLE_RATE:
            audio = resample(audio.astype(np.float32), rate, SAMPLE_RATE)
        audio = np.asarray(audio, np.float32)
        texts = []
        for c in range(max(1, math.ceil(len(audio) / N_SAMPLES))):
            window = pad_or_trim(audio[c * N_SAMPLES: (c + 1) * N_SAMPLES])
            toks, n = self.decode_window(window, max_new=max_new)
            texts.append(self.tokenizer.decode(
                toks[:n], skip_special_tokens=True).strip())
        return " ".join(t for t in texts if t).strip()

    def transcribe_wav(self, wav_path: str) -> str:
        from ..audio import read_wav, to_mono

        data, rate = read_wav(wav_path)
        return self.transcribe_array(to_mono(data), rate)
