"""WSOLA time-stretching (speed control without pitch change).

The reference delegates speed to the model (generate_audio(speed=...),
reference custom.py:163-170). Checkpoints that honor the speed control tag
do it natively; for everything else the engine guarantees the observable
contract — speed 1.3 means ~1.3x faster speech at the same pitch — with a
host-side waveform-similarity overlap-add pass (numpy, no extra deps).
"""

from __future__ import annotations

import numpy as np


def time_stretch(
    wav: np.ndarray,
    rate: float,
    sample_rate: int,
    *,
    frame_ms: float = 30.0,
    search_ms: float = 8.0,
) -> np.ndarray:
    """Stretch ``wav`` (float32 mono) by ``rate`` (>1 = faster/shorter).

    WSOLA: fixed synthesis hop, analysis hop scaled by ``rate``, each frame
    aligned within ±search window by cross-correlation against the natural
    continuation of the previous output frame.
    """
    if not 0.25 <= rate <= 4.0:
        raise ValueError(
            f"speed rate {rate} out of the supported range [0.25, 4.0]"
        )
    x = np.asarray(wav, dtype=np.float32)
    if abs(rate - 1.0) < 1e-3 or len(x) == 0:
        return x

    frame = max(256, int(sample_rate * frame_ms / 1000.0))
    frame -= frame % 2
    if len(x) < frame:
        # shorter than one analysis frame (~30 ms): WSOLA has nothing to
        # overlap, so time-scale by interpolation instead — the pitch shift
        # is inaudible at sub-frame durations
        out_len = max(1, int(round(len(x) / rate)))
        src = np.linspace(0.0, len(x) - 1.0, out_len, dtype=np.float64)
        return np.interp(src, np.arange(len(x), dtype=np.float64), x).astype(
            np.float32
        )
    hop_s = frame // 2                      # synthesis hop (50% overlap)
    hop_a = max(1, int(round(hop_s * rate)))  # analysis hop
    search = max(1, int(sample_rate * search_ms / 1000.0))
    window = np.hanning(frame).astype(np.float32)

    n_out_frames = max(1, (len(x) - frame) // hop_a + 1)
    out_len = (n_out_frames - 1) * hop_s + frame
    out = np.zeros(out_len, np.float32)
    norm = np.zeros(out_len, np.float32)

    # first frame verbatim
    seg = x[:frame]
    out[:frame] += seg * window
    norm[:frame] += window
    prev_start = 0

    for i in range(1, n_out_frames):
        target = i * hop_a                  # nominal analysis position
        # natural continuation of the previous frame:
        nat = x[prev_start + hop_s: prev_start + hop_s + frame]
        lo = max(0, target - search)
        hi = min(len(x) - frame, target + search)
        if hi <= lo or len(nat) < frame:
            best = min(max(target, 0), max(len(x) - frame, 0))
        else:
            # pick the candidate start maximizing correlation with `nat`
            corr_len = min(frame, hop_s * 2)
            nat_h = nat[:corr_len]
            cands = np.lib.stride_tricks.sliding_window_view(
                x[lo: hi + corr_len], corr_len
            )[: hi - lo + 1]
            # NORMALIZED cross-correlation: a raw dot product lets loud
            # candidates (clicks/plosives) win regardless of waveform
            # similarity, splicing dissimilar segments
            norms = np.sqrt(np.sum(cands * cands, axis=1)) + 1e-6
            scores = (cands @ nat_h) / norms
            best = lo + int(np.argmax(scores))
        seg = x[best: best + frame]
        pos = i * hop_s
        out[pos: pos + frame] += seg * window
        norm[pos: pos + frame] += window
        prev_start = best

    norm[norm < 1e-6] = 1.0
    return (out / norm).astype(np.float32)
