"""Public engine API: ``load_model`` and ``generate_audio``.

The same call shapes as the JAX package (and the mlx_audio functions its
reference app consumes):

- ``load_model(model_path, device=None) -> model``: a checkpoint
  directory (an HF/MLX snapshot, cached on first import as
  ``_tpu_native/``, or a native directory) or a ``synthetic:`` name
- ``generate_audio(model=, text=, voice=, instruct=, speed=, ref_audio=,
  ref_text=, output_path=, ...)`` writing ``audio_000.wav`` into
  ``output_path`` and returning metrics (rtf, ttfa_s, frames, ...). Text
  longer than one segment runs its segments concurrently through the
  model's serving engine (``Qwen3TTSModel.serving_engine``,
  ``runtime/serving.py``) unless ``QWEN3_TTS_LONGFORM=serial``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA, the default raises rather than falling
back. The port covers checkpoints (``engine/weights.py``) and synthetic
models (``synthetic:tiny|flagship`` with the rvq codec and
``synthetic:tiny-code2wav|flagship-code2wav`` with the code2wav decoder)
in all three modes (custom, design and base, i.e. cloning from
``ref_audio``), and, through ``Qwen3TTSModel.synthetic``, any config of
``engine/configs.py``: the published residual_sum protocol, multi-token
prediction (``frames_per_step`` > 1, on a talker tree with MTP heads),
the batched-cp MTP chain and speculative depth decode. ``speed != 1`` on a
model without native speed is a host-side WSOLA stretch of the whole
signal, and each call emits one ``profiling.emit_metrics`` line when
QWEN3_TTS_METRICS is set.
"""

from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from . import configs
from .configs import ModelConfig, torch_dtype
from .tokenizer import load_tokenizer

_SYNTH_RE = re.compile(
    r"^synthetic:(tiny|flagship|tiny-code2wav|flagship-code2wav)"
    r"(?::(custom|design|base))?$"
)
# cloning references are padded to a frame bucket: a few shapes for the
# allocator to keep, and trailing zeros cannot change a whole frame's codes
# (every conv and the attention are causal); the padding is trimmed after
REF_FRAME_BUCKETS = (64, 128, 256, 512, 1024, 2048)
MAX_REF_SECONDS = 30.0  # the acoustic prompt's bound


def _ref_bucket(frames: int) -> int:
    return next((b for b in REF_FRAME_BUCKETS if frames <= b),
                -(-frames // 2048) * 2048)


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; asking for CUDA without it raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU"
        )
    return dev


def compute_format() -> str:
    """Runtime weight format: ``int8`` (u8 codes + f32 scale/bias resident,
    the int8 kernels carry every linear) or ``bf16`` (weights dequantized
    once at load). Override with QWEN3_TTS_COMPUTE=int8|bf16.

    ``auto`` means int8 on every device: the JAX package defaults to bf16
    on a TPU only because dequantizing there measured slower than bf16
    weights (TPU v5e, PERF.md at commit dae56a7, "int8-resident weights in
    the feedback loop"), a TPU measurement that says nothing about a GPU,
    where the weight bytes bound decode and int8 halves them."""
    mode = os.environ.get("QWEN3_TTS_COMPUTE", "auto")
    if mode in ("int8", "bf16"):
        return mode
    if mode not in ("", "auto"):
        raise ValueError(
            f"QWEN3_TTS_COMPUTE={mode!r}: expected 'int8' or 'bf16' "
            "(lowercase) — refusing to silently fall back to auto-detection"
        )
    return "int8"


def apply_compute_format(model: "Qwen3TTSModel") -> "Qwen3TTSModel":
    """Convert a loaded model's linears to the runtime compute format."""
    if model.cfg.quant.enabled and compute_format() == "bf16":
        from ..ops.quant import dequantize_tree

        dtype = torch_dtype(model.cfg)
        model.params = dequantize_tree(model.params, dtype)
        model.cp_params = dequantize_tree(model.cp_params, dtype)
        model._generator = None
        model._serving = None
    return model


@dataclass
class Qwen3TTSModel:
    """A loaded model: config, parameter trees on ``device``, tokenizer,
    prompt template and the generator (decode-layout parameters, built on
    first use)."""

    cfg: ModelConfig
    params: Any                       # talker
    cp_params: Any                    # code predictor
    codec_params: Any
    tokenizer: Any
    device: torch.device
    name: str = "qwen3-tts"
    sampling: Any = None              # None = SamplingConfig() defaults
    import_report: Any = None         # weights.ImportReport of an HF import
    template: Any = None              # runtime.prompts.PromptTemplate
    # a checkpoint's speech tokenizer (models/speech_tokenizer.py): the
    # mapped float32 tree and its SpeechTokenizerConfig; None = cloning
    # through the synthetic codec encoder
    st_params: Any = None
    st_cfg: Any = None
    # speech_tokenizer.* tensors in an unknown layout, preserved for the
    # native cache
    st_raw: Any = field(default=None, repr=False)
    load_times: dict = field(default_factory=dict)   # seconds of each step
    # the tp mesh that parallel.shard_model sliced the trees for (None:
    # whole trees); the generator and serving engine decode over it
    mesh: Any = field(default=None, repr=False)
    _generator: Any = field(default=None, repr=False)
    _serving: Any = field(default=None, repr=False)

    def to(self, device) -> "Qwen3TTSModel":
        """Move the parameter trees to ``device`` (in place)."""
        from .weights import tree_to

        self.device = torch.device(device)
        self.params = tree_to(self.params, self.device)
        self.cp_params = tree_to(self.cp_params, self.device)
        self.codec_params = tree_to(self.codec_params, self.device)
        if self.st_params is not None:
            self.st_params = tree_to(self.st_params, self.device)
        self._generator = None
        self._serving = None
        return self

    @property
    def generator(self):
        from ..runtime.generate import Generator
        from ..runtime.sampling import SamplingConfig

        if self._generator is None:
            self._generator = Generator(
                cfg=self.cfg, params=self.params, cp_params=self.cp_params,
                codec_params=self.codec_params,
                sampling=self.sampling or SamplingConfig(), mesh=self.mesh,
            )
        return self._generator

    def serving_engine(self, max_streams: int = 8):
        """The model's multi-stream engine (``runtime/serving.py``), built
        on first use over the generator's decode-layout trees and kept;
        rebuilt when ``max_streams`` changes."""
        from ..runtime.serving import ServingEngine

        if self._serving is None or self._serving.B != max_streams:
            self._serving = ServingEngine(self, max_streams=max_streams,
                                          sampling=self.sampling)
        return self._serving

    @classmethod
    def synthetic(cls, cfg: ModelConfig, seed: int = 0,
                  device=None) -> "Qwen3TTSModel":
        """Random-initialised model with the production tree layout. On the
        CPU the values are drawn with numpy in the JAX package's order; on
        CUDA they are made on the device (models/init.py)."""
        from ..models.code_predictor import init_code_predictor
        from ..models.codec import init_codec
        from ..models.talker import init_talker

        dev = resolve_device(device)
        on_card = dev if dev.type == "cuda" else None
        return apply_compute_format(cls(
            cfg=cfg,
            params=init_talker(cfg, seed, device=on_card),
            cp_params=init_code_predictor(cfg, seed + 1, device=on_card),
            codec_params=init_codec(cfg, seed + 2, device=on_card,
                                    encoder=True),
            tokenizer=load_tokenizer(None, cfg.talker.vocab_size),
            device=dev,
            name=f"synthetic-{cfg.mode}",
        ))

    # -- cloning -------------------------------------------------------------

    def encode_reference(self, wav: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray | None]:
        """Reference waveform (mono float32 at the codec's rate) ->
        (codes int32 [Q, T_ref], speaker vector float32 [D_talker] or None),
        on the model's device. A checkpoint's speech tokenizer returns codes
        only: the published protocol conditions cloning on the reference
        codes (and its transcript). Otherwise the synthetic codec encoder
        returns codes and the mean-pooled speaker vector, the padding
        frames masked out of the mean."""
        wav = np.asarray(wav, dtype=np.float32)
        n = len(wav)
        if self.st_params is not None:
            from ..models.speech_tokenizer import st_encode, st_frames

            st_cfg = self.st_cfg
            T = st_frames(st_cfg, n)
            padded = np.zeros(_ref_bucket(T) * st_cfg.hop, np.float32)
            padded[:n] = wav
            codes = st_encode(self.st_params, st_cfg,
                              torch.from_numpy(padded).to(self.device)[None])
            return codes[0, :, :T].cpu().numpy().astype(np.int32), None

        from ..models.codec import encode_waveform, rvq_quantize, speaker_embedding

        T = max(1, -(-n // self.cfg.codec.hop))
        padded = np.zeros(_ref_bucket(T) * self.cfg.codec.hop, np.float32)
        padded[:n] = wav
        w = torch.from_numpy(padded).to(self.device)[None]
        latent = encode_waveform(self.codec_params, self.cfg, w)
        codes = rvq_quantize(self.codec_params, self.cfg, latent)
        mask = (torch.arange(latent.shape[1], device=latent.device) < T)
        spk = speaker_embedding(self.codec_params, self.cfg,
                                latent * mask[None, :, None].to(latent.dtype),
                                n_frames=T)
        return (codes[0, :, :T].cpu().numpy().astype(np.int32),
                spk[0].float().cpu().numpy())


def load_model(model_path: str, device=None, *, seed: int = 0,
               **kwargs) -> Qwen3TTSModel:
    """Load a checkpoint directory (HF/MLX snapshot or native format;
    ``kwargs`` go to ``weights.load_checkpoint``: ``mode``, ``cache``,
    ``allow_partial``) or build a synthetic model from
    ``synthetic:<size>[:custom|design|base]``, size one of tiny, flagship,
    tiny-code2wav, flagship-code2wav, on ``device`` (default: the CUDA
    device)."""
    dev = resolve_device(device)
    m = _SYNTH_RE.match(model_path or "")
    if not m:
        if not os.path.isdir(model_path or ""):
            raise FileNotFoundError(f"model path does not exist: {model_path}")
        from .weights import load_checkpoint

        return apply_compute_format(
            load_checkpoint(model_path, device=dev, seed=seed, **kwargs))
    size, mode = m.group(1), m.group(2) or "custom"
    cfg = {
        "tiny": lambda: configs.tiny(mode, quant=True),
        "flagship": lambda: configs.flagship(mode),
        "tiny-code2wav": lambda: configs.tiny_code2wav(mode),
        "flagship-code2wav": lambda: configs.flagship_code2wav(mode),
    }[size]()
    return Qwen3TTSModel.synthetic(cfg, seed=seed, device=dev)


# --------------------------------------------------------------------------
# generate_audio
# --------------------------------------------------------------------------

# latin enders need trailing whitespace (don't split "3.14"); CJK full-width
# enders split unconditionally
_SENTENCE_SPLIT = re.compile(r"(?<=[.!?;])\s+|(?<=[。！？；])\s*")
_MAX_SEGMENT_CHARS = 600
_SEGMENT_GAP_S = 0.15


def _split_segments(text: str) -> list[str]:
    """Split on sentence boundaries, packing sentences into <= 600-char
    segments."""
    sentences = [s for s in _SENTENCE_SPLIT.split(text.strip()) if s]
    segments: list[str] = []
    cur = ""
    for s in sentences:
        while len(s) > _MAX_SEGMENT_CHARS:  # pathological unbroken run
            if cur:
                segments.append(cur)
                cur = ""
            segments.append(s[:_MAX_SEGMENT_CHARS])
            s = s[_MAX_SEGMENT_CHARS:]
        if not cur:
            cur = s
        elif len(cur) + 1 + len(s) <= _MAX_SEGMENT_CHARS:
            cur = f"{cur} {s}"
        else:
            segments.append(cur)
            cur = s
    if cur:
        segments.append(cur)
    return segments or [""]


def _estimate_frames(text: str, frame_rate: float) -> int:
    """Frame budget heuristic: ~15 chars/sec speech, 60% headroom."""
    est_seconds = max(1.0, len(text) / 15.0)
    return int(est_seconds * frame_rate * 1.6) + 24


def prepare_segments(
    model: Qwen3TTSModel,
    text: str,
    *,
    voice: str | None = None,
    instruct: str | None = None,
    speed: float = 1.0,
    ref_audio: str | None = None,
    ref_text: str | None = None,
    max_frames: int | None = None,
) -> tuple[list, list[int]]:
    """Split ``text`` into segments, encode the cloning reference
    ``ref_audio`` (a WAV path; mono-mixed, resampled to the codec's rate,
    cut to 30 s) once, and build one (prompt, frame budget) pair per
    segment."""
    from ..runtime.prompts import build_prompt

    cfg = model.cfg
    acoustic_codes = speaker_vector = None
    if ref_audio is not None:
        from ..audio import read_wav, resample, to_mono

        sr = cfg.codec.sample_rate
        data, rate = read_wav(ref_audio)
        wav_ref = resample(to_mono(data), rate, sr)[:int(MAX_REF_SECONDS * sr)]
        acoustic_codes, speaker_vector = model.encode_reference(wav_ref)
    segments = _split_segments(text)
    prompts = [
        build_prompt(
            model.tokenizer, cfg.mode, segment, voice=voice,
            speakers=cfg.speakers,
            speaker_tokens=(dict(cfg.talker.speaker_tokens)
                            if cfg.talker.speaker_tokens else None),
            instruct=instruct, speed=speed, ref_text=ref_text,
            acoustic_codes=acoustic_codes, speaker_vector=speaker_vector,
            template=model.template,
        )
        for segment in segments
    ]
    budgets = [
        max_frames if max_frames is not None
        else _estimate_frames(segment, cfg.codec.frame_rate)
        for segment in segments
    ]
    return prompts, budgets


def generate_audio(
    *,
    model: Qwen3TTSModel,
    text: str,
    voice: str | None = None,
    instruct: str | None = None,
    speed: float = 1.0,
    ref_audio: str | None = None,
    ref_text: str | None = None,
    output_path: str,
    max_frames: int | None = None,
    seed: int = 0,
    on_chunk: Callable[[np.ndarray], None] | None = None,
    file_name: str = "audio_000.wav",
) -> dict:
    """Synthesise ``text`` and write ``output_path/audio_000.wav`` (mono
    16-bit PCM, 24 kHz). Returns {frames, audio_s, wall_s, ttfa_s, rtf,
    segments, sample_rate}.

    Text of several segments without an ``on_chunk`` consumer runs them
    concurrently through the serving engine, its sampling seeded with
    ``seed`` (QWEN3_TTS_LONGFORM=serving, the default); any other value, or
    an ``on_chunk`` consumer, runs them one after another."""
    cfg = model.cfg
    sr = cfg.codec.sample_rate
    prompts, budgets = prepare_segments(
        model, text, voice=voice, instruct=instruct, speed=speed,
        ref_audio=ref_audio, ref_text=ref_text, max_frames=max_frames,
    )
    pieces: list[np.ndarray] = []
    total_frames = 0
    ttfa = None
    wall = 0.0
    longform = os.environ.get("QWEN3_TTS_LONGFORM", "serving")
    if len(prompts) > 1 and on_chunk is None and longform == "serving":
        engine = model.serving_engine()
        engine.rng.manual_seed(seed)  # reproducible per call
        t0 = time.perf_counter()
        results = engine.run(prompts, max_frames=budgets)
        wall = time.perf_counter() - t0
        pieces = [wav for wav, _ in results]
        total_frames = sum(s.frames for _, s in results)
        ttfa = min((s.ttfa_s for _, s in results if s.ttfa_s is not None),
                   default=0.0)
    else:
        for seg_idx, (prompt, budget) in enumerate(zip(prompts, budgets)):
            result = model.generator.synthesize(
                prompt, max_frames=budget, seed=seed + seg_idx,
                on_chunk=on_chunk,
            )
            pieces.append(result.wav)
            total_frames += result.frames
            wall += result.wall_s
            if ttfa is None:
                ttfa = result.ttfa_s

    gap = np.zeros(int(_SEGMENT_GAP_S * sr), dtype=pieces[0].dtype)
    out = pieces[0] if len(pieces) == 1 else np.concatenate(
        [p for pair in zip(pieces, [gap] * len(pieces)) for p in pair][:-1]
    )

    # speed contract: a checkpoint that does not honour the speed tag gets
    # the host-side WSOLA stretch of the whole signal (audio/stretch.py)
    if abs(speed - 1.0) >= 1e-3 and not cfg.native_speed and len(out):
        from ..audio.stretch import time_stretch
        from ..ops.pcm import pcm16_to_f32

        out = time_stretch(pcm16_to_f32(out), float(speed), sr)

    from ..audio import write_wav

    os.makedirs(output_path, exist_ok=True)
    write_wav(os.path.join(output_path, file_name), out, sr)
    audio_s = len(out) / sr
    metrics = {
        "frames": total_frames,
        "audio_s": audio_s,
        "wall_s": wall,
        "ttfa_s": ttfa or 0.0,
        "rtf": (audio_s / wall) if wall > 0 else 0.0,
        "segments": len(prompts),
        "sample_rate": sr,
    }
    from ..profiling import emit_metrics

    emit_metrics("generate_audio", {
        "mode": cfg.mode, "chars": len(text),
        **{k: round(v, 4) if isinstance(v, float) else v
           for k, v in metrics.items()},
    })
    return metrics
