"""Training data pipeline: (text, wav) pairs -> teacher-forcing batches
(the JAX package's training/data.py, kept as this package's own copy).

Reference audio is encoded to ground-truth codec codes with the model's
own reference encoder (``Qwen3TTSModel.encode_reference``, the cloning
path: the codec encoder, or a checkpoint's speech tokenizer), text goes
through the model's tokenizer, and examples are right-padded into the
bucketed batch layout that ``training.loss`` consumes
(text_tokens/text_mask/codes/frame_mask/speaker_id).

Batches are numpy arrays on the host; the train step moves them to the
parameters' device. Bucketing (text length, frame length) keeps the shapes
to a few, so the allocator reuses its blocks from step to step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

#: bucket ladders for the two padded axes
TEXT_BUCKETS = (16, 32, 64, 128, 256, 512)
FRAME_BUCKETS = (8, 16, 32, 64, 128, 256, 512)


def _bucket(n: int, ladder: tuple) -> int:
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]


@dataclass
class Example:
    """One encoded training example (host arrays)."""

    text_tokens: np.ndarray   # [Tt] int32
    codes: np.ndarray         # [Q, Tf] int32
    speaker_id: int = -1      # built-in speaker row to condition on (-1 = none)


def encode_example(model, text: str, wav: np.ndarray, sample_rate: int) -> Example:
    """Tokenize ``text`` and encode ``wav`` (float32 mono at
    ``sample_rate``, resampled to the codec's rate if needed) into
    ground-truth codes on the model's device."""
    from ..audio import resample
    from ..engine.tokenizer import clamp_ids

    sr = model.cfg.codec.sample_rate
    if sample_rate != sr:
        wav = resample(wav, sample_rate, sr)
    codes, _ = model.encode_reference(np.asarray(wav, np.float32))
    ids = clamp_ids(
        model.tokenizer.encode(text), model.cfg.talker.vocab_size
    )
    return Example(
        text_tokens=np.asarray(ids, np.int32),
        codes=np.asarray(codes, np.int32),
    )


def pad_batch(examples: Sequence[Example], pad_id: int = 0) -> dict:
    """Right-pad a list of examples into one bucketed batch dict.

    Examples longer than the largest bucket are truncated with a loud
    warning: truncated codes paired with full text corrupt alignment and
    EOS behaviour, so callers should split long clips upstream instead."""
    import warnings

    assert examples
    tt = _bucket(max(len(e.text_tokens) for e in examples), TEXT_BUCKETS)
    tf = _bucket(max(e.codes.shape[1] for e in examples), FRAME_BUCKETS)
    q = examples[0].codes.shape[0]
    B = len(examples)

    text = np.full((B, tt), pad_id, np.int32)
    text_mask = np.zeros((B, tt), bool)
    codes = np.zeros((B, q, tf), np.int32)
    frame_mask = np.zeros((B, tf), bool)
    speaker_id = np.full((B,), -1, np.int32)
    for i, e in enumerate(examples):
        if len(e.text_tokens) > tt or e.codes.shape[1] > tf:
            warnings.warn(
                f"example {i} exceeds the largest bucket "
                f"(text {len(e.text_tokens)}>{tt} or frames "
                f"{e.codes.shape[1]}>{tf}) and is being TRUNCATED — split "
                "long clips before batching (alignment/EOS training "
                "degrades on truncated pairs)",
                stacklevel=2,
            )
        nt = min(len(e.text_tokens), tt)
        nf = min(e.codes.shape[1], tf)
        text[i, :nt] = e.text_tokens[:nt]
        text_mask[i, :nt] = True
        codes[i, :, :nf] = e.codes[:, :nf]
        frame_mask[i, :nf] = True
        speaker_id[i] = e.speaker_id
    return {
        "text_tokens": text,
        "text_mask": text_mask,
        "codes": codes,
        "frame_mask": frame_mask,
        "speaker_id": speaker_id,
    }


def dp_rows(batch: dict, mesh) -> dict:
    """This rank's contiguous rows of a global batch on ``mesh`` (the
    block at its dp coordinate, as ``P("dp")`` places a batch in the JAX
    package); the batch itself without a dp axis."""
    if mesh is None or mesh.plan.dp == 1:
        return batch
    dp = mesh.plan.dp
    rows = len(next(iter(batch.values())))
    if rows % dp:
        raise ValueError(f"batch of {rows} rows does not split over dp={dp}")
    n = rows // dp
    d = mesh.coord("dp")
    return {k: v[d * n:(d + 1) * n] for k, v in batch.items()}


def batches_from_pairs(
    model,
    pairs: Sequence[tuple[str, np.ndarray, int]],
    *,
    batch_size: int,
    shuffle_seed: int | None = 0,
) -> Iterator[dict]:
    """(text, wav, sample_rate) pairs -> stream of padded batch dicts.

    Examples are length-sorted before batching so bucket padding waste is
    minimal, then batch order is shuffled.
    """
    examples = [
        encode_example(model, text, wav, rate) for text, wav, rate in pairs
    ]
    if model.cfg.talker.feedback == "residual_sum":
        # the published training layout puts 3 head text rows + the first
        # text token in the prompt (training/loss.py mirrors the decode
        # layout with a static 3-row head); an example with fewer than 4
        # real tokens would be trained on a different head than inference
        # builds, so it is rejected instead of fine-tuned off-distribution
        short = [i for i, e in enumerate(examples)
                 if len(e.text_tokens) < 4]
        if short:
            raise ValueError(
                f"feedback='residual_sum' training needs >=4 text tokens "
                f"per example (3-row chatml head + first text token); "
                f"examples {short[:8]} are shorter — drop them or extend "
                "their prompts"
            )
    examples.sort(key=lambda e: (e.codes.shape[1], len(e.text_tokens)))
    groups = [
        examples[i: i + batch_size]
        for i in range(0, len(examples), batch_size)
    ]
    if shuffle_seed is not None:
        rng = np.random.default_rng(shuffle_seed)
        rng.shuffle(groups)
    for group in groups:
        yield pad_batch(group)
