"""Decode-configuration quality harness (the JAX package's quality.py).

Synthesize the same texts under a baseline decode and each variant of the
same weights, transcribe both (this package's Whisper through
``transcription.py``, or any callable), and score

- **ASR round-trip WER delta** (variant - baseline) against the input
  text: catches audible degradation, robust to benign token divergence;
- **DTW log-mel spectral distance** (variant vs baseline waveform), which
  needs no ASR: frames are DTW-aligned before the per-frame log-mel L2 is
  averaged. 0 = identical;
- **waveform identical-prefix fraction**, a gate for variants that should
  be bit-identical under greedy decode and information for protocol
  changes.

Variants: ``kv=int8`` (the int8 KV cache), ``dg=K`` (grouped depth
prediction), ``spec=1`` (speculative depth decode: with ``dg`` > 1, the
depth_group=1 greedy codes at grouped-draft cost), ``fps=N`` (multi-token
prediction, on a model whose talker carries MTP heads) and ``cpb=1`` (the
batched-cp MTP chain, with ``fps`` > 1).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import wave
from typing import Any, Callable

import numpy as np

Transcribe = Callable[[str], "str | None"]

# The offline mel-DTW gate of decode-recovery fine-tunes (the JAX
# package's thresholds, calibrated there on its freeze-base rig):
#   drift_db = mel-DTW(recovered at the base shape, original): the
#     fine-tune's weight movement alone; every recovery stays under
#     MEL_DRIFT_MAX_DB;
#   total_db = mel-DTW(recovered at the trained shape, original): what the
#     user hears after switching decode shape, gated only for lossless
#     claims (speculative decode) under MEL_GATE_MAX_DB. Lossy shapes
#     (fps > 1, plain dg > 1) make other valid utterances, whose mel-DTW
#     saturates whatever their quality: their verdict rides the ASR WER.
MEL_DRIFT_MAX_DB = 3.0
MEL_GATE_MAX_DB = 6.0


def mel_gate_passes(drift_db: float, total_db: float,
                    lossless: bool) -> bool:
    """The calibrated offline pass rule (see the constants above)."""
    if drift_db > MEL_DRIFT_MAX_DB:
        return False
    return total_db <= MEL_GATE_MAX_DB if lossless else True


DEFAULT_TEXTS = [
    "The quick brown fox jumps over the lazy dog.",
    "TPU inference keeps every decode shape static and bucketed.",
    "She sells sea shells by the sea shore on a bright summer morning.",
    "Quantized caches halve the attention window bandwidth.",
]


def wer(ref: str, hyp: str) -> float:
    """Word error rate via Levenshtein distance over whitespace tokens."""
    r = ref.lower().split()
    h = hyp.lower().split()
    if not r:
        return 0.0 if not h else 1.0
    d = np.arange(len(h) + 1, dtype=np.int32)
    for i, rw in enumerate(r, 1):
        prev_diag = d[0]
        d[0] = i
        for j, hw in enumerate(h, 1):
            cur = min(
                d[j] + 1,                       # deletion
                d[j - 1] + 1,                   # insertion
                prev_diag + (rw != hw),         # substitution
            )
            prev_diag = d[j]
            d[j] = cur
    return float(d[-1]) / len(r)


def divergence_frac(a: np.ndarray, b: np.ndarray) -> float:
    """Fraction of the shorter waveform that is bit-identical before the
    first mismatch (1.0 = fully identical over the overlap)."""
    n = min(len(a), len(b))
    if n == 0:
        return 1.0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return 1.0 if neq.size == 0 else float(neq[0]) / n


def log_mel(pcm: np.ndarray, sr: int, *, n_mels: int = 40,
            n_fft: int = 512, hop: int | None = None) -> np.ndarray:
    """[N] int16/float PCM -> [T, n_mels] log10 mel power spectrogram
    (hann window, HTK mel scale over 0..sr/2). Self-contained numpy — the
    Whisper frontend (models/whisper.py) is pinned to 16 kHz / 30 s pads,
    while quality metrics need the waveform's own rate and length."""
    x = np.asarray(pcm, np.float32)
    if pcm.dtype == np.int16:
        x = x / 32768.0
    hop = hop or n_fft // 2
    if len(x) < n_fft:
        x = np.pad(x, (0, n_fft - len(x)))
    starts = np.arange(0, len(x) - n_fft + 1, hop)
    frames = x[starts[:, None] + np.arange(n_fft)] * np.hanning(n_fft)
    power = np.abs(np.fft.rfft(frames, axis=-1)) ** 2  # [T, F]

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    mel_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2), n_mels + 2)
    hz_pts = 700.0 * (10.0 ** (mel_pts / 2595.0) - 1.0)
    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    slopes = hz_pts[None, :] - freqs[:, None]  # [F, n_mels+2]
    lower = -slopes[:, :n_mels] / np.maximum(hz_pts[1:-1] - hz_pts[:-2],
                                             1e-6)
    upper = slopes[:, 2:] / np.maximum(hz_pts[2:] - hz_pts[1:-1], 1e-6)
    bank = np.maximum(0.0, np.minimum(lower, upper))  # [F, n_mels]
    return np.log10(np.maximum(power @ bank, 1e-10)).astype(np.float32)


def _dtw_mean_cost(cost: np.ndarray) -> float:
    """Classic DTW (steps right/down/diagonal) over a [Ta, Tb] local-cost
    matrix, vectorized over anti-diagonals; returns the optimal path cost
    normalized by (Ta + Tb)."""
    ta, tb = cost.shape
    dist = np.full((ta, tb), np.inf, np.float64)
    dist[0, 0] = cost[0, 0]
    for k in range(1, ta + tb - 1):
        i = np.arange(max(0, k - tb + 1), min(ta - 1, k) + 1)
        j = k - i
        im, jm = np.maximum(i - 1, 0), np.maximum(j - 1, 0)
        up = np.where(i > 0, dist[im, j], np.inf)
        left = np.where(j > 0, dist[i, jm], np.inf)
        diag = np.where((i > 0) & (j > 0), dist[im, jm], np.inf)
        dist[i, j] = cost[i, j] + np.minimum(np.minimum(up, left), diag)
    return float(dist[-1, -1] / (ta + tb))


def mel_dtw_dist(a: np.ndarray, b: np.ndarray, sr: int,
                 *, max_frames: int = 900) -> float:
    """DTW-aligned mean log-mel L2 between two waveforms, in dB-like units
    (10 x log10-mel Euclidean distance per aligned frame pair). Length
    differences are absorbed by the alignment; identical audio -> ~0
    (the pairwise-L2 expansion trick leaves float-epsilon residue, so
    exact zero is not guaranteed — compare against a ~0.1 dB floor).
    Long clips are strided down to <= ``max_frames`` mel frames per side
    to bound the O(Ta*Tb) alignment."""
    ma, mb = log_mel(a, sr), log_mel(b, sr)
    stride = max(1, (max(len(ma), len(mb)) + max_frames - 1) // max_frames)
    ma, mb = ma[::stride], mb[::stride]
    if len(ma) == 0 or len(mb) == 0:
        return 0.0 if len(ma) == len(mb) else float("inf")
    # pairwise L2 via the expansion trick
    sq = (
        (ma ** 2).sum(-1)[:, None] + (mb ** 2).sum(-1)[None, :]
        - 2.0 * (ma @ mb.T)
    )
    cost = np.sqrt(np.maximum(sq, 0.0))
    return 10.0 * _dtw_mean_cost(cost)


def parse_variant(spec: str) -> dict[str, Any]:
    """``"fps=2+dg=5"`` / ``"kv=int8"`` / ``"dg=5+spec=1"`` /
    ``"fps=2+cpb=1"`` -> option dict. Keys: fps (int), dg (int),
    kv ("int8"|"dense"), spec (bool — speculative depth decode, bit-exact
    dg=1 greedy output), cpb (bool — batched-cp MTP,
    TalkerConfig.mtp_cp_batch)."""
    out: dict[str, Any] = {}
    for part in spec.split("+"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"variant part {part!r}: expected key=value")
        k, v = part.split("=", 1)
        k = k.strip().lower()
        if k in ("fps", "frames_per_step"):
            out["fps"] = int(v)
        elif k in ("dg", "depth_group"):
            out["dg"] = int(v)
        elif k == "kv":
            if v not in ("int8", "dense"):
                raise ValueError(f"kv={v!r}: expected int8 or dense")
            out["kv"] = v
        elif k == "spec":
            out["spec"] = v.strip().lower() in ("1", "true", "on", "yes")
        elif k in ("cpb", "mtp_cp_batch", "cp_batch"):
            out["cpb"] = v.strip().lower() in ("1", "true", "on", "yes")
        else:
            raise ValueError(f"unknown variant key {k!r} in {spec!r}")
    if not out:
        raise ValueError(f"empty variant spec {spec!r}")
    return out


def variant_model(model, opts: dict[str, Any]):
    """A model VIEW decoding ``model``'s weights under a different decode
    configuration (fps/dg/spec/cpb). Parameter trees are shared, not
    copied; only the config changes. A model trained at fps=N carries the
    MTP parameters, so any smaller fps decodes from the same tree; fps > 1
    on a tree without them raises."""
    from .engine.api import Qwen3TTSModel

    cfg = model.cfg
    if opts.get("fps", 1) > 1 and "mtp" not in model.params:
        raise ValueError(
            f"variant fps={opts['fps']} needs the MTP chain parameters, but "
            f"model {model.name!r} was not trained with them (decode at "
            "fps=1, or graft and train the heads first)")
    if "fps" in opts:
        cfg = dataclasses.replace(
            cfg, talker=dataclasses.replace(
                cfg.talker, frames_per_step=opts["fps"]
            )
        )
    if "cpb" in opts:
        if opts["cpb"] and cfg.talker.frames_per_step <= 1:
            raise ValueError(
                "variant cpb=1 (batched-cp MTP) needs frames_per_step > 1 "
                "(combine with fps=N)"
            )
        cfg = dataclasses.replace(
            cfg, talker=dataclasses.replace(
                cfg.talker, mtp_cp_batch=bool(opts["cpb"])
            )
        )
    if "dg" in opts:
        cfg = dataclasses.replace(
            cfg, code_predictor=dataclasses.replace(
                cfg.code_predictor, depth_group=opts["dg"]
            )
        )
    if "spec" in opts:
        cfg = dataclasses.replace(
            cfg, code_predictor=dataclasses.replace(
                cfg.code_predictor, spec_decode=bool(opts["spec"])
            )
        )
    return Qwen3TTSModel(
        cfg=cfg,
        params=model.params,
        cp_params=model.cp_params,
        codec_params=model.codec_params,
        tokenizer=model.tokenizer,
        device=model.device,
        template=model.template,
        name=f"{model.name}@{opts}",
        sampling=model.sampling,
        st_params=model.st_params,
        st_cfg=model.st_cfg,
    )


def _synthesize(model, text: str, voice, max_frames, kv: str | None,
                transcribe: Transcribe | None = None):
    """One utterance -> (pcm int16 array, transcript or None). The kv
    format is an engine-construction env knob, applied around the call;
    the WAV is transcribed before its temporary directory goes."""
    from .engine.api import generate_audio

    prev = os.environ.get("QWEN3_TTS_KV")
    if kv is not None:
        os.environ["QWEN3_TTS_KV"] = kv
    try:
        with tempfile.TemporaryDirectory(prefix="q3tts_quality_") as d:
            generate_audio(model=model, text=text, voice=voice,
                           output_path=d, max_frames=max_frames)
            path = os.path.join(d, "audio_000.wav")
            with wave.open(path) as w:
                pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
            hyp = (transcribe(path) or "") if transcribe else None
        return pcm, hyp
    finally:
        if kv is not None:
            if prev is None:
                os.environ.pop("QWEN3_TTS_KV", None)
            else:
                os.environ["QWEN3_TTS_KV"] = prev


def compare_decode_configs(
    model,
    variants: dict[str, dict[str, Any]],
    texts: list[str],
    transcribe: Transcribe | None,
    *,
    voice: str | None = "ryan",
    max_frames: int | None = None,
    baseline: dict[str, Any] | None = None,
) -> dict:
    """Score each named variant against the baseline decode of the SAME
    weights. Returns::

        {"baseline": {...opts},
         "variants": {name: {"rows": [...], "median_wer_delta": f|None,
                             "median_identical_frac": f,
                             "protocol_changing": bool}}}

    ``median_wer_delta`` is None when no transcriber is available (the
    waveform metrics — ``mel_dist`` and ``identical_frac`` — are still
    reported). ``protocol_changing`` marks variants whose token stream
    legitimately differs from the baseline's (fps/dg) — identical_frac is
    informational there, a gate only for pure-numerics variants (kv);
    ``median_mel_dist`` is the ASR-free fidelity number (DTW log-mel
    distance, 0 = identical audio)."""
    base_opts = dict(baseline or {"fps": 1, "dg": 1})
    base_model = variant_model(model, base_opts)
    base_rows = []
    for text in texts:
        pcm, hyp = _synthesize(base_model, text, voice, max_frames,
                               base_opts.get("kv"), transcribe)
        base_rows.append({
            "pcm": pcm,
            "wer": wer(text, hyp) if hyp is not None else None,
        })

    report: dict = {"baseline": base_opts, "texts": texts, "variants": {}}
    for name, opts in variants.items():
        vm = variant_model(model, opts)
        rows = []
        for text, base in zip(texts, base_rows):
            pcm, hyp = _synthesize(vm, text, voice, max_frames,
                                   opts.get("kv"), transcribe)
            rows.append({
                "text": text,
                "wer_baseline": base["wer"],
                "wer_variant": (
                    wer(text, hyp) if hyp is not None else None
                ),
                "identical_frac": divergence_frac(base["pcm"], pcm),
                "mel_dist": mel_dtw_dist(
                    base["pcm"], pcm, model.cfg.codec.sample_rate
                ),
            })
        deltas = [
            r["wer_variant"] - r["wer_baseline"] for r in rows
            if r["wer_variant"] is not None
        ]
        report["variants"][name] = {
            "opts": opts,
            "rows": rows,
            "median_wer_delta": (
                float(np.median(deltas)) if deltas else None
            ),
            "median_identical_frac": float(np.median(
                [r["identical_frac"] for r in rows]
            )),
            "median_mel_dist": float(np.median(
                [r["mel_dist"] for r in rows]
            )),
            "protocol_changing": bool(
                opts.get("fps", base_opts.get("fps", 1))
                != base_opts.get("fps", 1)
                or opts.get("dg", base_opts.get("dg", 1))
                != base_opts.get("dg", 1)
            ),
        }
    return report


def gate_passes(report: dict, max_wer_delta: float) -> bool:
    """True iff every variant with a measured WER delta stays within the
    budget (variants without ASR coverage do not pass silently — they are
    simply not gated; callers decide whether unmeasured = blocked)."""
    return all(
        v["median_wer_delta"] <= max_wer_delta
        for v in report["variants"].values()
        if v["median_wer_delta"] is not None
    )
