"""Synthesis pipeline: prompt embedding -> prefill -> chunked
autoregressive decode -> residual-codebook prediction -> streaming codec
decode -> 16-bit PCM, under either decode protocol (``TalkerConfig.feedback``)
and either codec decoder (``ModelConfig.codec_arch``).

Eager PyTorch with the JAX package's structure:

- decode runs in chunks; under the cb0 protocol a chunk is ``chunk`` talker
  steps (token sampled on the device and fed back without a host read),
  one batched code-predictor pass over the chunk's frames, one incremental
  codec decode and the PCM conversion. Under the published residual_sum
  protocol the code predictor runs once per frame inside the talker loop,
  since each step's input sums the previous frame's codebook embeddings and
  one trailing-text row (``make_decode_chunk_fn_feedback``);
- multi-token prediction (``frames_per_step`` fps > 1): each talker step
  emits fps frames, frame 0 from the main head and the others through the
  MTP chain (``models.talker.mtp_logits``), and the next step's input is
  the merge of the fps frames' embeddings, so the talker advances one
  cache position per fps frames;
- the host reads ONE packed tensor per chunk (valid-frame count, codes and
  PCM), which is where EOS is detected and the chunk is clipped; its copy
  starts at dispatch (pinned, ``non_blocking``), and ``Generator.stream``
  keeps up to ``pipeline_depth`` chunks in flight once the first chunk is
  read, so the host's read of chunk k overlaps the card's work on k+1;
- the common prompt shapes assemble from an ``AssemblyPlan`` computed on
  the host: one upload of the padded token rows, then gathers and masked
  writes into the bucket on the device (``Generator.fast_assembly_plan``);
  clone prompts and prompts that a bucket would cut keep the eager chain;
- prompts are LEFT-padded to length buckets (RoPE is relative and padded
  keys are masked, so left padding is exact), and decode attention reads a
  bucketed prefix of the KV cache.

The KV caches and the codec's stream state are updated in place.

Under tensor parallelism (``Generator(mesh=...)``, after
``parallel.shard_model``) every rank runs this same loop on its shard:
the talker and code predictor at local heads with local kv caches, one
tp sum after each o and down projection, and everything after the sum
(norms, heads, sampling, the codec) whole and equal on every rank. So
every host decision (the chunk plan, EOS, the frame budget) is the same
on every rank, as the ranks' collectives need; sampled decode seeds each
rank's ``torch.Generator`` alike.
"""

from __future__ import annotations

import itertools
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..engine.configs import ModelConfig, torch_dtype
from ..models.code_predictor import predict_residuals
from ..models.codec import (
    decode_codes_streaming,
    init_codec_stream_state,
    max_stream_frames,
)
from ..models.layers import (
    fuse_block_projections, kv_cache_init, rope_tables, unstack_layers,
)
from ..models.talker import (
    merge_step_embs,
    merge_step_tokens,
    mtp_logits,
    mtp_logits_emb,
    talker_forward,
    text_projection,
)
from ..ops.grouped_qmv import grouped_layout, pack_grouped_tree
from ..ops.pcm import wav_to_pcm16
from ..parallel.sharding import cache_sharding, cp_mesh
from ..profiling import trace
from .prompts import PromptSpec
from .sampling import SamplingConfig, sample_token

PROMPT_BUCKETS = (64, 128, 256, 512, 1024, 2048)
# decode attention reads only a bucketed prefix of the KV cache
ATTN_BUCKETS = (512, 1024, 2048, 4096)


def bucket_len(n: int) -> int:
    for b in PROMPT_BUCKETS:
        if n <= b:
            return b
    return PROMPT_BUCKETS[-1]


def attn_bucket(needed: int, s_max: int) -> int:
    for b in ATTN_BUCKETS:
        if needed <= b <= s_max:
            return b
    return s_max


@dataclass(frozen=True)
class AssemblyPlan:
    """A prompt assembly computed on the host (``Generator.fast_assembly_plan``):
    everything ``Generator.assemble_plans_batched`` needs, with the shapes
    and the left pad resolved without touching the device, so the serving
    engine can defer the assembly and batch the cold start's prompts."""

    proto: str        # "pub" (published residual_sum) | "cb0"
    tb_tok: int       # text-token bucket (a power of two >= 8)
    Lb: int           # prompt bucket
    pad: int          # left pad inside the bucket
    spk_kind: str     # "codec" | "table" | "none"
    spk_idx: int
    toks: np.ndarray  # [tb_tok] int32, zero past T
    T: int


class _HostCopy:
    """One device->host copy: into pinned memory, ``non_blocking``, with a
    CUDA event to wait on (a CPU tensor is its own host copy)."""

    def __init__(self, dev: torch.Tensor, start: bool):
        self.dev = dev
        self.host = None
        self.event = None
        if start:
            self.start()

    def start(self) -> None:
        if self.host is not None:
            return
        if not self.dev.is_cuda:
            self.host = self.dev
            return
        self.host = torch.empty(self.dev.shape, dtype=self.dev.dtype,
                                pin_memory=True)
        self.host.copy_(self.dev, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def numpy(self) -> np.ndarray:
        self.start()
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host->device copy of ``arr`` (through pinned memory and
    ``non_blocking`` on CUDA, so the host does not wait for it)."""
    host = torch.from_numpy(arr)
    if device.type != "cuda":
        return host.to(device)
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    pinned.copy_(host)
    return pinned.to(device, non_blocking=True)


def _has_lora(tree: Any) -> bool:
    if isinstance(tree, dict):
        return "lora_a" in tree or any(_has_lora(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_lora(v) for v in tree)
    return False


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.tp > 1


def fuse_decode_params(cp_params: Any, codec_params: Any,
                       mesh=None) -> tuple[Any, Any]:
    """Fuse q/k/v -> qkv and gate/up -> gate_up in the code predictor's and
    the codec's latent-transformer blocks (fewer, larger products in their
    many small sequential steps; identical numerics). The talker keeps the
    split layout, as in the JAX package. Skipped when unmerged LoRA
    adapters are present; idempotent. Under a tp ``mesh`` the code
    predictor keeps its split layout (a concatenated qkv of out-sharded
    slices is not one head-local shard), as in the JAX package."""
    def fusable(blocks) -> bool:
        return (isinstance(blocks, dict) and "qkv" not in blocks["attn"]
                and not _has_lora(blocks))

    if not _sharded(mesh):
        if fusable(cp_params.get("blocks")):
            cp_params = {**cp_params, "blocks": fuse_block_projections(
                cp_params["blocks"])}
        draft = cp_params.get("draft")
        if draft is not None and fusable(draft.get("blocks")):
            # freeze-base recovery's draft adapter runs the same decode path
            cp_params = {**cp_params, "draft": {
                **draft, "blocks": fuse_block_projections(draft["blocks"])}}
    dec = codec_params.get("dec", {})
    if fusable(dec.get("tf_blocks")):
        codec_params = {**codec_params, "dec": {
            **dec, "tf_blocks": fuse_block_projections(dec["tf_blocks"])}}
    return cp_params, codec_params


def fuse_talker_params(params: Any, mesh=None) -> Any:
    """Opt-in (QWEN3_TTS_FUSE_TALKER=1) q/k/v -> qkv and gate/up -> gate_up
    relayout of the TALKER's blocks: half the products a layer of a
    single-frame pass. Off by default, as in the JAX package: the fused
    copy sits beside the model's canonical split tree. A no-op for a tp
    ``mesh``'s trees, for unmerged LoRA adapters and for an already fused
    tree; identical numerics (``models.layers.attention`` and the MLP take
    the fused keys)."""
    if os.environ.get("QWEN3_TTS_FUSE_TALKER", "0") in ("0", ""):
        return params
    blocks = params.get("blocks")
    if (not isinstance(blocks, dict) or "qkv" in blocks["attn"]
            or _has_lora(params) or _sharded(mesh)):
        return params
    return {**params, "blocks": fuse_block_projections(blocks)}


def group_quantized(*trees, device, mesh=None):
    """Relayout every quantized linear into the grouped format of kernel A
    when the QWEN3_TTS_INT8_LAYOUT policy says so for ``device`` (auto =
    grouped on CUDA). Runs after fuse_decode_params so the fused qkv /
    gate_up projections (fuse_talker_params' too) are grouped; identity on
    dense trees. A tp ``mesh``'s trees keep the split row-major layout, as
    in the JAX package: kernel B runs every int8 linear at the shard
    shapes."""
    if _sharded(mesh) or not grouped_layout(device):
        return trees if len(trees) > 1 else trees[0]
    out = tuple(pack_grouped_tree(t) for t in trees)
    return out if len(out) > 1 else out[0]


def default_chunk_schedule(t) -> tuple:
    """The decode-chunk ladder: a small first chunk for time to first
    audio, then the steady 32-frame chunk (the last entry repeats)."""
    if t.feedback == "residual_sum" and t.frames_per_step == 1:
        return (4, 32)
    return (8, 32)


def align_chunk_schedule(schedule, fps: int) -> tuple:
    """Round each chunk size up to a multiple of ``frames_per_step``."""
    out = tuple(-(-int(c) // fps) * fps for c in schedule)
    if any(c <= 0 for c in out):
        raise ValueError(f"chunk sizes must be positive: {schedule}")
    return out


def chunk_plan(schedule, max_frames: int, fps: int = 1) -> Iterator[int]:
    """The decode chunks of an utterance of ``max_frames`` frames that runs
    to its end: the schedule (its last entry repeating), the last chunk cut
    to what is left (rounded up to ``fps``). An utterance that reaches EOS
    stops after a prefix of these."""
    done = 0
    for i in itertools.count():
        if done >= max_frames:
            return
        chunk = min(schedule[min(i, len(schedule) - 1)],
                    -(-(max_frames - done) // fps) * fps)
        yield chunk
        done += chunk


def cp_samples(cfg: ModelConfig, sampling: SamplingConfig) -> bool:
    """Whether the code predictor samples its residual codes: the config
    asks for it AND the talker itself samples (greedy talker decode keeps
    greedy residuals)."""
    cp = cfg.code_predictor
    wants = cp.top_k > 0 or cp.top_p < 1.0 or cp.temperature != 1.0
    return wants and not (sampling.greedy or sampling.temperature <= 0.0)


@dataclass
class GenerationResult:
    wav: np.ndarray                   # [n_samples] int16 PCM mono (24 kHz)
    frames: int
    sample_rate: int
    ttfa_s: float                     # time to first audio chunk
    wall_s: float
    audio_s: float
    codes: np.ndarray | None = None   # [Q, frames] when collect_codes=True

    @property
    def rtf(self) -> float:
        """Real-time factor: audio seconds produced per wall second."""
        return self.audio_s / self.wall_s if self.wall_s > 0 else 0.0


# --------------------------------------------------------------------------
# stages
# --------------------------------------------------------------------------

def make_prefill_fn(cfg: ModelConfig, mesh=None) -> Callable:
    t = cfg.talker
    S = cfg.max_seq_len

    def prefill(params, emb, pad_len: int, cache_k, cache_v):
        cos_t, sin_t = rope_tables(S, t.head_dim, t.rope_theta, emb.device)
        hidden, logits, ck, cv = talker_forward(
            params, t, emb, cache_k, cache_v, 0, cos_t, sin_t,
            pad_len=pad_len, head_last_only=True, mesh=mesh,
        )
        return hidden[:, -1, :], logits[:, -1, :], ck, cv

    return prefill


def seed_tokens(params, cfg: ModelConfig, sampling: SamplingConfig, hidden,
                logits, generator) -> torch.Tensor:
    """The cb0 protocol's seed step: frame 0 from the prefill logits, the
    other fps - 1 frames through the MTP chain. hidden [B, D], logits
    [B, V] -> tokens [B, fps]; they condition the first decode step and
    are not rendered."""
    t = cfg.talker
    toks = [sample_token(logits, generator, sampling)]
    h = hidden
    for _ in range(1, t.frames_per_step):
        lg, h = mtp_logits(params, t, h, toks[-1])
        toks.append(sample_token(lg, generator, sampling))
    return torch.stack(toks, dim=1)


def _hold_inactive(active, new, old):
    """``new`` where a serving slot decodes, ``old`` where it holds (an
    inactive slot keeps its position and counters); ``active`` None: every
    row decodes."""
    if active is None:
        return new
    mask = active.reshape(active.shape + (1,) * (new.dim() - 1))
    return torch.where(mask, new, old)


def make_decode_chunk_fn(cfg: ModelConfig, chunk: int,
                         sampling: SamplingConfig,
                         attn_len: int | None = None,
                         window_split: tuple | None = None,
                         mesh=None) -> Callable:
    """One chunk: ``chunk`` talker steps + batched residual prediction +
    incremental codec decode + PCM. Attention reads the first ``attn_len``
    cache slots (the caller guarantees pos + chunk <= attn_len for every
    decoding row), split per row group by ``window_split``.

    ONE chunk function serves both engines: ``Generator.stream`` passes int
    positions and counters and no ``active`` mask (every row decodes); the
    serving engine passes [B] tensors and its slot mask, and an inactive
    slot holds its position and frame counter and emits ``codec_pad``.
    ``mesh``: the trees and caches are this rank's tp shard."""
    t = cfg.talker
    S = cfg.max_seq_len
    A = attn_len or S
    cb_size = cfg.codec.codebook_size
    fps = t.frames_per_step
    if chunk % fps:
        raise ValueError(f"chunk {chunk} is not a multiple of fps {fps}")
    n_steps = chunk // fps
    cp_stoch = cp_samples(cfg, sampling)
    cpm = cp_mesh(cfg, mesh)

    def decode_chunk(params, cp_params, codec_params, cache_k, cache_v,
                     cstate, pos, pad_len, n_frames, last_token, generator,
                     active=None):
        """last_token [B, fps]; pos/pad_len/n_frames ints or [B] tensors;
        returns (cache_k, cache_v, cstate, pos, tok, n_frames, n_valid [B],
        codes [B, Q, chunk], pcm [B, chunk*hop])."""
        cos_t, sin_t = rope_tables(S, t.head_dim, t.rope_theta,
                                   last_token.device)
        ck, cv = cache_k[:, :, :A], cache_v[:, :, :A]  # views: writes land
        tok = last_token
        toks, hiddens = [], []
        for s in range(n_steps):
            with trace("qwen3_tts.model.talker"):
                emb = merge_step_tokens(params, t, tok)[:, None, :]
                hidden, logits, _, _ = talker_forward(
                    params, t, emb, ck, cv, pos, cos_t, sin_t,
                    pad_len=pad_len, window_split=window_split, mesh=mesh,
                )
                h = hidden[:, -1, :]
                frame = [sample_token(logits[:, -1, :], generator, sampling)]
                hj = h
                for _ in range(1, fps):  # MTP frames from the same weights
                    lg, hj = mtp_logits(params, t, hj, frame[-1])
                    frame.append(sample_token(lg, generator, sampling))
            tok = _hold_inactive(active, torch.stack(frame, dim=1),
                                 t.codec_pad)                # [B, fps]
            pos = _hold_inactive(active, pos + 1, pos)
            toks.append(tok)
            hiddens.append(h)
        tokens_bc = torch.cat(toks, dim=1)                   # [B, chunk]
        B = tokens_bc.shape[0]
        with trace("qwen3_tts.model.predictor"):
            # each step's hidden conditions all its fps frames' residuals
            flat_h = torch.stack(hiddens, dim=1).repeat_interleave(
                fps, dim=1).reshape(B * chunk, -1)
            # control tokens (BOS/EOS/PAD >= codebook_size) are clamped for
            # the predictor; the host masks frames at/after EOS anyway
            flat_cb0 = tokens_bc.reshape(-1).clamp(0, cb_size - 1)
            residuals = predict_residuals(
                cp_params, cfg, flat_h, flat_cb0,
                generator=generator if cp_stoch else None, mesh=cpm,
            )
        codes = torch.cat(
            [flat_cb0.reshape(B, chunk, 1),
             residuals.reshape(B, chunk, -1)], dim=-1,
        ).transpose(1, 2)                                    # [B, Q, chunk]
        with trace("qwen3_tts.model.code2wav"):
            wav_chunk, cstate = decode_codes_streaming(
                codec_params, cfg, codes, cstate, n_frames)
            pcm = wav_to_pcm16(wav_chunk)
        is_eos = (tokens_bc == t.codec_eos).int()
        n_valid = torch.where(is_eos.any(dim=1), is_eos.argmax(dim=1),
                              torch.full_like(is_eos[:, 0], chunk))
        return (cache_k, cache_v, cstate, pos, tok,
                _hold_inactive(active, n_frames + chunk, n_frames), n_valid,
                codes, pcm)

    return decode_chunk


def feedback_step_frames(params, cp_params, cfg: ModelConfig,
                         sampling: SamplingConfig, hidden, cb0, generator,
                         dtype, mesh=None):
    """The fps frames of one residual_sum step after its first token:
    ``cb0`` [B] was drawn from the talker head at ``hidden`` [B, D];
    frames 1..fps-1 come through the MTP chain. Returns (tok [B, fps],
    feedback sums [B, fps, D] in ``dtype``, residual codes [B, fps, Q-1]).

    By default each frame has its own predictor pass and the chain
    conditions frame j+1 on frame j's full feedback embedding (cb0 +
    residual sum). Under ``mtp_cp_batch`` the chain conditions on cb0
    embeddings alone, so ONE predictor pass covers all fps frames as
    batch rows. ``mesh``: the model's tp mesh (``Generator``)."""
    t = cfg.talker
    fps = t.frames_per_step
    cb = cfg.codec.codebook_size
    cp_gen = generator if cp_samples(cfg, sampling) else None
    cpm = cp_mesh(cfg, mesh)
    codec_emb = params["codec_emb"]
    h = hidden
    if t.mtp_cp_batch and fps > 1:
        toks, hs = [], []
        for j in range(fps):
            toks.append(cb0)
            hs.append(h)
            if j + 1 < fps:
                lg, h = mtp_logits_emb(params, t, h, codec_emb[cb0].to(dtype))
                cb0 = sample_token(lg, generator, sampling)
        tok = torch.stack(toks, dim=1)                             # [B, fps]
        B = tok.shape[0]
        res, rs = predict_residuals(
            cp_params, cfg, torch.stack(hs, dim=1).reshape(B * fps, -1),
            tok.reshape(-1).clamp(0, cb - 1), generator=cp_gen,
            return_feedback=True, mesh=cpm)
        return (tok, rs.reshape(B, fps, -1).to(dtype),
                res.reshape(B, fps, -1))
    toks, rss, ress = [], [], []
    for j in range(fps):
        res, rs = predict_residuals(cp_params, cfg, h, cb0.clamp(0, cb - 1),
                                    generator=cp_gen, return_feedback=True,
                                    mesh=cpm)
        toks.append(cb0)
        rss.append(rs.to(dtype))
        ress.append(res)
        if j + 1 < fps:  # the MTP chain: next frame, same weight pass
            lg, h = mtp_logits_emb(params, t, h,
                                   codec_emb[cb0].to(dtype) + rss[-1])
            cb0 = sample_token(lg, generator, sampling)
    return (torch.stack(toks, dim=1), torch.stack(rss, dim=1),
            torch.stack(ress, dim=1))


def seed_feedback_frames(params, cp_params, cfg: ModelConfig,
                         sampling: SamplingConfig, hidden, logits, generator,
                         mesh=None):
    """The published protocol's seed step: frame 0 from the prefill
    logits, then ``feedback_step_frames``. hidden [B, D], logits [B, V] ->
    (tok [B, fps], feedback sums [B, fps, D], residual codes
    [B, fps, Q-1]); the frames condition the first decode step and are not
    rendered."""
    cb0 = sample_token(logits, generator, sampling)
    return feedback_step_frames(params, cp_params, cfg, sampling, hidden,
                                cb0, generator, hidden.dtype, mesh)


def trailing_lookup(trailing: torch.Tensor, g) -> torch.Tensor:
    """Row ``g`` (an int, or one per row: a [B] tensor) of the
    trailing-text buffer [B, Tb, D] -> [B, D]. The buffer's last row is
    tts_pad (Generator._assemble_published), so clamping the index
    conditions every frame past the text on tts_pad."""
    last = trailing.shape[1] - 1
    if isinstance(g, torch.Tensor):
        rows = torch.arange(trailing.shape[0], device=trailing.device)
        return trailing[rows, g.clamp(0, last)]
    return trailing[:, min(max(g, 0), last)]


def make_decode_chunk_fn_feedback(cfg: ModelConfig, chunk: int,
                                  sampling: SamplingConfig,
                                  attn_len: int | None = None,
                                  window_split: tuple | None = None,
                                  mesh=None) -> Callable:
    """The published protocol's chunk (transformers
    Qwen3OmniMoeTalkerForConditionalGeneration.prepare_inputs_for_generation):
    each talker step consumes the SUM of the previous frame's codebook
    embeddings (cb0 through the talker's codec_emb, residual d through the
    code predictor's depth-d table) and one trailing-text row, so the code
    predictor runs once per frame inside the loop. Then the streaming codec
    and PCM, as the cb0 chunk (whose docstring says how both engines drive
    it: ``active``, ``window_split``, ``mesh``).

    At fps > 1 a talker pass emits fps frames (``feedback_step_frames``),
    each keeping its own feedback sum and trailing-text row, and the next
    pass consumes the MERGE of the fps frames' feedback embeddings."""
    t = cfg.talker
    fps = t.frames_per_step
    if chunk % fps:
        raise ValueError(f"chunk {chunk} is not a multiple of fps {fps}")
    n_steps = chunk // fps
    S = cfg.max_seq_len
    A = attn_len or S
    cb_size = cfg.codec.codebook_size

    def decode_chunk(params, cp_params, codec_params, cache_k, cache_v,
                     cstate, trailing, pos, pad_len, n_frames, last_token,
                     res_sum, g, generator, active=None):
        """trailing [B, Tb, D]; last_token [B, fps]; res_sum [B, fps, D]
        the feedback sums of last_token's residual codes; g the trailing
        rows consumed; pos/pad_len/n_frames/g ints or [B] tensors. Returns
        (cache_k, cache_v, cstate, pos, tok, n_frames, res_sum, g,
        n_valid [B], codes [B, Q, chunk], pcm [B, chunk*hop])."""
        cos_t, sin_t = rope_tables(S, t.head_dim, t.rope_theta,
                                   last_token.device)
        ck, cv = cache_k[:, :, :A], cache_v[:, :, :A]  # views: writes land
        tok, rs = last_token, res_sum
        toks, residuals = [], []
        for _ in range(n_steps):
            with trace("qwen3_tts.model.talker"):
                # the previous step's fps frames, each its full feedback
                # embedding plus its own trailing-text row, merged into one
                # input
                prev = params["codec_emb"][tok].to(rs.dtype) + rs  # [B,fps,D]
                trail = torch.stack([trailing_lookup(trailing, g + j)
                                     for j in range(fps)], dim=1)
                emb = merge_step_embs(params, t, prev + trail)[:, None, :]
                hidden, logits, _, _ = talker_forward(
                    params, t, emb, ck, cv, pos, cos_t, sin_t,
                    pad_len=pad_len, window_split=window_split, mesh=mesh,
                )
                cb0 = sample_token(logits[:, -1, :], generator, sampling)
            with trace("qwen3_tts.model.predictor"):
                frame_toks, rs_new, res = feedback_step_frames(
                    params, cp_params, cfg, sampling, hidden[:, -1, :], cb0,
                    generator, rs.dtype, mesh)
            tok = _hold_inactive(active, frame_toks, t.codec_pad)  # [B, fps]
            rs = _hold_inactive(active, rs_new, rs)
            pos = _hold_inactive(active, pos + 1, pos)
            g = _hold_inactive(active, g + fps, g)
            toks.append(tok)
            residuals.append(res)
        tokens_bc = torch.cat(toks, dim=1)                         # [B, chunk]
        codes = torch.cat(
            [tokens_bc.clamp(0, cb_size - 1)[:, :, None],
             torch.cat(residuals, dim=1)], dim=-1,
        ).transpose(1, 2)                                          # [B, Q, chunk]
        with trace("qwen3_tts.model.code2wav"):
            wav_chunk, cstate = decode_codes_streaming(
                codec_params, cfg, codes, cstate, n_frames)
            pcm = wav_to_pcm16(wav_chunk)
        is_eos = (tokens_bc == t.codec_eos).int()
        n_valid = torch.where(is_eos.any(dim=1), is_eos.argmax(dim=1),
                              torch.full_like(is_eos[:, 0], chunk))
        return (cache_k, cache_v, cstate, pos, tok,
                _hold_inactive(active, n_frames + chunk, n_frames), rs, g,
                n_valid, codes, pcm)

    return decode_chunk


# --------------------------------------------------------------------------
# the synthesis loop
# --------------------------------------------------------------------------

def _first_device(tree) -> torch.device:
    if isinstance(tree, dict):
        return _first_device(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _first_device(tree[0])
    return tree.device


@dataclass
class Generator:
    """Owns the decode-layout parameters and stage functions of one model."""

    cfg: ModelConfig
    params: Any                       # talker params
    cp_params: Any                    # code-predictor params
    codec_params: Any
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    # adaptive chunk schedule (None = default_chunk_schedule); the last
    # entry repeats for the rest of the utterance
    chunk_schedule: tuple | None = None
    # chunks kept in flight, counting the one being read, once the first
    # chunk is read (1: no chunk dispatched ahead of a read)
    pipeline_depth: int = 2
    # the tp mesh of trees that parallel.shard_model sliced (None: whole)
    mesh: Any = None

    def __post_init__(self):
        t = self.cfg.talker
        if self.mesh is not None and (self.mesh.plan.dp > 1
                                      or self.mesh.plan.pp > 1):
            raise ValueError(
                f"decode shards over tp only, got mesh {self.mesh.shape}: "
                "dp and pp are training's axes (training.train)")
        self.device = _first_device(self.params)
        self.dtype = torch_dtype(self.cfg)
        self.cp_params, self.codec_params = fuse_decode_params(
            self.cp_params, self.codec_params, self.mesh)
        self.params = fuse_talker_params(self.params, self.mesh)  # opt-in
        self.params, self.cp_params, self.codec_params = group_quantized(
            self.params, self.cp_params, self.codec_params, device=self.device,
            mesh=self.mesh)
        # per-layer views for the Python layer loops (built once)
        self.params = {**self.params,
                       "blocks": unstack_layers(self.params["blocks"])}
        self.cp_params = {**self.cp_params,
                          "blocks": unstack_layers(self.cp_params["blocks"])}
        if "draft" in self.cp_params:
            draft = self.cp_params["draft"]
            self.cp_params["draft"] = {
                **draft, "blocks": unstack_layers(draft["blocks"])}
        if "dec" in self.codec_params:       # rvq codec
            dec = self.codec_params["dec"]
            self.codec_params = {**self.codec_params, "dec": {
                **dec, "tf_blocks": unstack_layers(dec["tf_blocks"])}}
        else:                                # code2wav
            c2w = self.codec_params["c2w"]
            self.codec_params = {**self.codec_params, "c2w": {
                **c2w, "pre": {**c2w["pre"],
                               "blocks": unstack_layers(c2w["pre"]["blocks"])}}}
        if self.chunk_schedule is None:
            self.chunk_schedule = default_chunk_schedule(t)
        self.chunk_schedule = align_chunk_schedule(
            self.chunk_schedule, t.frames_per_step)
        # how the last stream's prompt was assembled ("plan" or "eager")
        # and the host's milliseconds for it
        self.last_assembly: dict | None = None

    @property
    def chunk(self) -> int:
        """First-chunk size (TTFA granularity)."""
        return self.chunk_schedule[0]

    def _prefill_fn(self):
        return make_prefill_fn(self.cfg, self.mesh)

    def kv_shape(self, batch: int, length: int) -> tuple:
        """This rank's talker cache shape [L, batch, length, H_kv, hd]
        (the kv heads of its tp shard)."""
        t = self.cfg.talker
        shape = (t.n_layers, batch, length, t.n_kv_heads, t.head_dim)
        if self.mesh is None:
            return shape
        return cache_sharding(self.mesh).local_shape(shape)

    def _alloc_cache(self, batch: int = 1):
        """The talker's K and V caches [L, batch, S, H_kv, hd]: dense, or
        ``KVQuant`` pairs under QWEN3_TTS_KV=int8 (read per utterance)."""
        shape = self.kv_shape(batch, self.cfg.max_seq_len)
        return (kv_cache_init(shape, self.dtype, device=self.device),
                kv_cache_init(shape, self.dtype, device=self.device))

    # -- prompt embedding (once per utterance) ----------------------------

    def assemble_prompt(self, prompt: PromptSpec) -> tuple[torch.Tensor, int]:
        """(emb [1, L_bucket, D], pad_len) of ``prompt``."""
        emb, pad, _ = self.assemble_prompt_full(prompt)
        return emb, pad

    def assemble_prompt_full(self, prompt: PromptSpec):
        """(emb [1, L_bucket, D], pad_len, trailing [1, Tb, D] or None): the
        trailing-text buffer exists under the residual_sum protocol only."""
        if self.cfg.talker.feedback == "residual_sum":
            return self._assemble_published(prompt)
        emb, pad = self._assemble_cb0(prompt)
        return emb, pad, None

    def _prompt_cap(self) -> int:
        max_prompt = max(16, self.cfg.max_seq_len - 2 * max(self.chunk_schedule))
        allowed = [b for b in PROMPT_BUCKETS if b <= max_prompt]
        return allowed[-1] if allowed else max_prompt

    def _pub_head_len(self, spk_kind: str) -> int:
        """Rows of the published prompt head, which the text does not change
        (the text after its first four tokens conditions through the
        trailing buffer): the one source of the plan's L, bucket and pad."""
        return 3 + len(self.cfg.talker.codec_prompt_head) + (
            1 if spk_kind != "none" else 0) + 2

    def fast_assembly_plan(self, prompt: PromptSpec) -> AssemblyPlan | None:
        """The ``AssemblyPlan`` of a common prompt, or None: clone
        conditioning (a speaker vector or acoustic codes), a prompt too
        short for the plan's layout, one that its bucket would cut, and
        (cb0) one with both a speaker id and a speaker token keep the eager
        chain. The tokenizer-mismatch ``ValueError`` is raised here, at plan
        time, so a deferred plan does not postpone it."""
        t = self.cfg.talker
        if not getattr(self, "_fast_assembly", True):  # tests: eager chain
            return None
        if prompt.speaker_vector is not None:
            return None
        if prompt.acoustic_codes is not None and prompt.acoustic_codes.size:
            return None
        toks = np.asarray(prompt.text_tokens)
        out_of_range = toks.size and (int(toks.max()) >= t.vocab_size
                                      or int(toks.min()) < 0)
        if t.feedback == "residual_sum":
            if out_of_range:
                raise ValueError(
                    f"token id {int(toks.max())} out of range for "
                    f"vocab_size {t.vocab_size}: tokenizer/config mismatch")
            if toks.size < 4:
                return None
            if prompt.speaker_token is not None:
                spk_kind, spk_idx = "codec", int(prompt.speaker_token)
            elif prompt.speaker_id is not None:
                spk_kind, spk_idx = "table", int(prompt.speaker_id)
            else:
                spk_kind, spk_idx = "none", 0
            L = self._pub_head_len(spk_kind)
            proto = "pub"
        else:
            if toks.size < 1 or (prompt.speaker_id is not None
                                 and prompt.speaker_token is not None):
                return None
            if out_of_range:
                # only tiny synthetic configs may alias ids, as the eager
                # chain does
                if t.vocab_size >= 512:
                    raise ValueError(
                        f"token id {int(toks.max())} out of range for "
                        f"vocab_size {t.vocab_size}: tokenizer/config mismatch"
                    )
                toks = toks % t.vocab_size
            if prompt.speaker_id is not None:
                spk_kind, spk_idx = "table", int(prompt.speaker_id)
            elif prompt.speaker_token is not None:
                spk_kind, spk_idx = "codec", int(prompt.speaker_token)
            else:
                spk_kind, spk_idx = "none", 0
            L = (spk_kind == "table") + toks.size + len(t.codec_prompt_head) \
                + (spk_kind == "codec") + 1
            proto = "cb0"
        Lb = min(bucket_len(L), self._prompt_cap())
        if L > Lb:  # a prompt the bucket cuts keeps the eager chain
            return None
        T = int(toks.size)
        tb_tok = 8
        while tb_tok < T:
            tb_tok *= 2
        padded = np.zeros(tb_tok, np.int32)
        padded[:T] = toks
        return AssemblyPlan(proto=proto, tb_tok=tb_tok, Lb=Lb, pad=Lb - L,
                            spk_kind=spk_kind, spk_idx=spk_idx, toks=padded,
                            T=T)

    def assemble_from_plan(self, plan: AssemblyPlan):
        """(emb [1, Lb, D], pad, trailing [1, Tb, D] or None) of one plan."""
        emb, trailing = self.assemble_plans_batched([plan])
        return emb, plan.pad, trailing

    def assemble_plans_batched(self, plans: list):
        """(emb [N, Lb, D], trailing [N, Tb, D] or None) of N plans that
        share (proto, Lb, spk_kind): the row each bucket position takes is
        worked out on the host, then ONE host->device copy carries the token
        rows (lifted to the group's largest text bucket), the ids and those
        row indices, and the card gathers the rows. No host read. Exactly
        the N rows are built: eager PyTorch has no compile variants to
        bound, so the batch is not padded to a power of two (the JAX
        package pads it)."""
        p0 = plans[0]
        if any((p.proto, p.Lb, p.spk_kind) != (p0.proto, p0.Lb, p0.spk_kind)
               for p in plans):
            raise ValueError("assemble_plans_batched: plans of one "
                             "(proto, Lb, spk_kind) group only")
        tb = max(p.tb_tok for p in plans)
        toks = np.zeros((len(plans), tb), np.int64)
        for i, p in enumerate(plans):
            toks[i, :p.tb_tok] = p.toks
        T = np.array([p.T for p in plans])[:, None]
        spk = np.array([p.spk_idx for p in plans])
        if p0.proto == "pub":
            return self._assemble_pub_rows(p0, toks, T, spk)
        pad = np.array([p.pad for p in plans])[:, None]
        return self._assemble_cb0_rows(p0, toks, T, pad, spk), None

    def _uploaded(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        """``arrays`` on the device (int64) through one ``_upload``."""
        flat = _upload(np.concatenate([np.asarray(a, np.int64).ravel()
                                       for a in arrays]), self.device)
        return [x.view(a.shape) for x, a in
                zip(flat.split([a.size for a in arrays]), arrays)]

    def _assemble_cb0_rows(self, p0: AssemblyPlan, toks, T, pad,
                           spk) -> torch.Tensor:
        """``_assemble_cb0``'s rows, gathered from one table: the N prompts'
        text rows, their tail rows (codec head, speaker token, BOS), their
        speaker rows (table kind) and a zero row. Bucket row i of prompt n
        holds its logical row j = i - pad: zero padding (j < 0), the
        speaker (j = 0, table kind), a text row or a tail row."""
        t = self.cfg.talker
        p = self.params
        N, tb = toks.shape
        s = int(p0.spk_kind == "table")
        cols = [np.broadcast_to(np.asarray(t.codec_prompt_head, np.int64),
                                (N, len(t.codec_prompt_head)))]
        if p0.spk_kind == "codec":
            cols.append(spk[:, None])
        cols.append(np.full((N, 1), t.codec_bos))
        tail = np.concatenate(cols, axis=1)                    # [N, n_tail]
        n_tail = tail.shape[1]
        spk_row = N * tb + N * n_tail                          # table rows
        zero = spk_row + s * N
        n = np.arange(N)[:, None]
        j = np.arange(p0.Lb)[None, :] - pad
        idx = np.where(j < 0, zero, np.where(
            j < s, spk_row + n, np.where(
                j < s + T, n * tb + j - s, N * tb + n * n_tail + j - s - T)))
        toks_d, tail_d, spk_d, idx_d = self._uploaded(toks, tail, spk, idx)
        rows = [p["text_emb"][toks_d].flatten(0, 1),
                p["codec_emb"][tail_d].flatten(0, 1)]
        if s:
            rows.append(p["spk_emb"][spk_d])
        rows.append(p["text_emb"].new_zeros((1, p["text_emb"].shape[1])))
        return torch.cat(rows)[idx_d]

    def _assemble_pub_rows(self, p0: AssemblyPlan, toks, T, spk):
        """``_assemble_published``'s rows (no clone rows, T >= 4), each the
        sum of a gathered text-side row (the N prompts' projected text rows,
        tts_pad, tts_bos, tts_eos, zero) and a codec-side row (their codec
        ids' embeddings, their speaker rows, zero); the head is
        text-independent, so its pad is static. The trailing buffer
        gathers text rows 4..T-1 cut to Tb - 2, then tts_eos unless cut,
        then tts_pad."""
        t = self.cfg.talker
        p = self.params
        N, tb = toks.shape
        nh = len(t.codec_prompt_head)
        kind = p0.spk_kind
        cols = [np.broadcast_to(np.asarray(t.codec_prompt_head, np.int64),
                                (N, nh))]
        if kind == "codec":
            cols.append(spk[:, None])
        cols += [np.full((N, 1), t.codec_pad), np.full((N, 1), t.codec_bos)]
        codec_ids = np.concatenate(cols, axis=1)               # [N, k]
        k = codec_ids.shape[1]
        # text-side table: N * tb text rows, tts_pad, tts_bos, tts_eos, zero
        PAD, BOS, EOS, ZERO_T = N * tb, N * tb + 1, N * tb + 2, N * tb + 3
        # codec-side table: N * k codec rows, N speaker rows (table), zero
        ZERO_C = N * k + (N if kind == "table" else 0)
        n = np.arange(N)[:, None]
        txt_col = [n * tb + r for r in range(3)]
        left = txt_col + [PAD] * nh
        right = [ZERO_C] * 3 + [n * k + h for h in range(nh)]
        if kind != "none":
            left.append(PAD)
            right.append(n * k + nh if kind == "codec" else N * k + n)
        left += [BOS, n * tb + 3]
        right += [n * k + k - 2, n * k + k - 1]
        left = [ZERO_T] * p0.pad + left
        right = [ZERO_C] * p0.pad + right
        left, right = (np.concatenate([np.broadcast_to(c, (N, 1))
                                       for c in side], axis=1)
                       for side in (left, right))
        Tb = t.trailing_bucket
        i = np.arange(Tb)[None, :]
        n_trail = np.minimum(T - 4, Tb - 2)
        trail = np.where(i < n_trail, n * tb + 4 + i, np.where(
            (i == n_trail) & (T - 4 <= Tb - 2), EOS, PAD))
        ctl = np.array([t.tts_pad_id, t.tts_bos_id, t.tts_eos_id])
        ctl_d, toks_d, codec_d, spk_d, left_d, right_d, trail_d = \
            self._uploaded(ctl, toks, codec_ids, spk, left, right, trail)
        D = p["text_emb"].shape[1]
        text_side = torch.cat([
            text_projection(p, p["text_emb"][toks_d]).flatten(0, 1),
            text_projection(p, p["text_emb"][ctl_d])])
        text_side = torch.cat([text_side, text_side.new_zeros((1, D))])
        codec_side = [p["codec_emb"][codec_d].flatten(0, 1)]
        if kind == "table":
            codec_side.append(p["spk_emb"][spk_d])
        codec_side = torch.cat(codec_side + [
            p["codec_emb"].new_zeros((1, p["codec_emb"].shape[1]))])
        return (text_side[left_d] + codec_side[right_d],
                text_side[trail_d])

    def _assemble_cb0(self, prompt: PromptSpec) -> tuple[torch.Tensor, int]:
        """The cb0-protocol prompt [speaker]? [text] [codec head]
        [speaker token]? [acoustic cb0]? [codec BOS], left-padded to a
        bucket: from the plan when ``fast_assembly_plan`` gives one, else
        the eager chain. Returns (emb [1, L_bucket, D], pad_len)."""
        plan = self.fast_assembly_plan(prompt)
        if plan is not None:
            emb, pad, _ = self.assemble_from_plan(plan)
            return emb, pad
        t = self.cfg.talker
        p = self.params
        dev = self.device
        parts = []
        if prompt.speaker_id is not None:
            parts.append(p["spk_emb"][prompt.speaker_id][None, :])
        if prompt.speaker_vector is not None:
            parts.append(torch.as_tensor(
                np.asarray(prompt.speaker_vector, np.float32), device=dev
            ).to(p["spk_emb"].dtype)[None, :])
        if prompt.text_tokens.size:
            toks_np = np.asarray(prompt.text_tokens)
            if int(toks_np.max()) >= t.vocab_size or int(toks_np.min()) < 0:
                # only tiny synthetic configs may alias ids (their tables are
                # smaller than the byte tokenizer's 256 ids)
                if t.vocab_size >= 512:
                    raise ValueError(
                        f"token id {int(toks_np.max())} out of range for "
                        f"vocab_size {t.vocab_size}: tokenizer/config mismatch"
                    )
                toks_np = toks_np % t.vocab_size
            parts.append(p["text_emb"][torch.as_tensor(toks_np.astype(np.int64),
                                                       device=dev)])
        for tok in t.codec_prompt_head:
            parts.append(p["codec_emb"][tok][None, :])
        if prompt.speaker_token is not None:
            parts.append(p["codec_emb"][int(prompt.speaker_token)][None, :])
        if prompt.acoustic_codes is not None and prompt.acoustic_codes.size:
            cb0_np = np.asarray(prompt.acoustic_codes[0])
            cb_size = self.cfg.codec.codebook_size
            if int(cb0_np.max()) >= cb_size or int(cb0_np.min()) < 0:
                if cb_size >= 512:
                    raise ValueError(
                        f"acoustic code {int(cb0_np.max())} out of range for "
                        f"codebook_size {cb_size}"
                    )
                cb0_np = cb0_np % cb_size
            parts.append(p["codec_emb"][torch.as_tensor(
                cb0_np.astype(np.int64), device=dev)])
        parts.append(p["codec_emb"][t.codec_bos][None, :])
        emb = torch.cat(parts, dim=0)                        # [L, D]

        # head conditioning rows must survive truncation
        n_head = (prompt.speaker_id is not None) + (
            prompt.speaker_vector is not None)
        L = emb.shape[0]
        Lb = min(bucket_len(L), self._prompt_cap())
        if L > Lb:  # over-long prompt: keep head conditioning + the tail
            emb = torch.cat([emb[:n_head], emb[L - (Lb - n_head):]], dim=0)
            L = Lb
        pad = Lb - L
        padded = torch.zeros((Lb, emb.shape[1]), dtype=emb.dtype, device=dev)
        padded[pad:] = emb
        return padded[None], pad

    def _assemble_published(self, prompt: PromptSpec):
        """The published dual-stream prompt (transformers
        Qwen3OmniMoeForConditionalGeneration._get_talker_assistant_parts),
        every row a text hidden plus a codec embedding:

            txt[0..2]                            (codec stream: zeros)
            tts_pad + [nothink, think_bos, think_eos]
            tts_pad + speaker codec token or spk_emb row
            tts_pad + acoustic cb0 (+ residual) codes (cloning)
            tts_bos + codec_pad
            txt[3]  + codec_bos                  (the first text token)

        left-padded to a bucket. The rest of the text conditions during
        decode, one row a frame, then tts_eos, then tts_pad: the returned
        trailing buffer [1, Tb, D], whose last row is always tts_pad.
        From the plan when ``fast_assembly_plan`` gives one, else the eager
        chain. Returns (emb [1, L_bucket, D], pad_len, trailing)."""
        t = self.cfg.talker
        p = self.params
        dev = self.device
        toks_np = np.asarray(prompt.text_tokens)
        if toks_np.size and (int(toks_np.max()) >= t.vocab_size
                             or int(toks_np.min()) < 0):
            raise ValueError(
                f"token id {int(toks_np.max())} out of range for "
                f"vocab_size {t.vocab_size}: tokenizer/config mismatch")
        plan = self.fast_assembly_plan(prompt)
        if plan is not None:
            return self.assemble_from_plan(plan)
        ctl = torch.tensor([t.tts_pad_id, t.tts_bos_id, t.tts_eos_id],
                           device=dev)
        pad_e, bos_e, eos_e = text_projection(p, p["text_emb"][ctl])
        txt = (text_projection(p, p["text_emb"][torch.as_tensor(
            toks_np.astype(np.int64), device=dev)]) if toks_np.size
            else pad_e.new_zeros((0, pad_e.shape[-1])))
        T = txt.shape[0]
        # the published head is the 3 chatml rows <|im_start|>assistant\n;
        # shorter prompts keep at least the last token for the codec_bos row
        n_head = min(3, max(T - 1, 0))
        codec_emb = p["codec_emb"]
        parts = []
        if prompt.speaker_vector is not None:
            parts.append(torch.as_tensor(
                np.asarray(prompt.speaker_vector, np.float32), device=dev
            ).to(pad_e.dtype)[None, :])
        if n_head:
            parts.append(txt[:n_head])
        for tok in t.codec_prompt_head:
            parts.append((pad_e + codec_emb[tok])[None, :])
        if prompt.speaker_token is not None:
            parts.append((pad_e + codec_emb[int(prompt.speaker_token)])[None, :])
        elif prompt.speaker_id is not None:
            parts.append((pad_e + p["spk_emb"][prompt.speaker_id])[None, :])
        if prompt.acoustic_codes is not None and prompt.acoustic_codes.size:
            parts.append(self._acoustic_rows(prompt.acoustic_codes, pad_e))
        parts.append((bos_e + codec_emb[t.codec_pad])[None, :])
        first_txt = txt[n_head] if T > n_head else pad_e
        parts.append((first_txt + codec_emb[t.codec_bos])[None, :])
        emb = torch.cat(parts, dim=0)

        L = emb.shape[0]
        Lb = min(bucket_len(L), self._prompt_cap())
        if L > Lb:  # over-long acoustic context: keep the head and the tail
            keep = n_head + (prompt.speaker_vector is not None)
            emb = torch.cat([emb[:keep], emb[L - (Lb - keep):]], dim=0)
            L = Lb
        pad = Lb - L
        padded = torch.zeros((Lb, emb.shape[1]), dtype=emb.dtype, device=dev)
        padded[pad:] = emb

        # text rows after the first, cut to Tb - 2 so that the last row is
        # always tts_pad; a cut text drops its tts_eos row too (pad forever
        # beats repeating eos every frame)
        Tb = t.trailing_bucket
        all_rows = txt[n_head + 1:]
        trail_rows = all_rows[:Tb - 2]
        n_trail = trail_rows.shape[0]
        buf = pad_e[None, :].repeat(Tb, 1)
        if all_rows.shape[0] == n_trail:
            buf[n_trail] = eos_e
        buf[:n_trail] = trail_rows
        return padded[None], pad, buf[None]

    def _acoustic_rows(self, codes: np.ndarray, pad_e: torch.Tensor):
        """Cloning rows of the published prompt: tts_pad + codec_emb[cb0] +
        the code predictor's residual embeddings of the same frame, as every
        decoded frame feeds back (depths the codes lack are left out)."""
        cfg = self.cfg
        codes = np.asarray(codes)                                  # [Q, T]
        cb0 = codes[0]
        if int(cb0.max()) >= cfg.codec.codebook_size or int(cb0.min()) < 0:
            raise ValueError(
                f"acoustic code {int(cb0.max())} out of range for "
                f"codebook_size {cfg.codec.codebook_size}")
        dev = self.device
        rows = pad_e[None, :] + self.params["codec_emb"][
            torch.as_tensor(cb0.astype(np.int64), device=dev)]
        use = min(codes.shape[0] - 1, cfg.codec.num_codebooks - 1)
        if use:
            res = codes[1:1 + use]
            r_size = cfg.codec.residual_codebook_size
            if int(res.max()) >= r_size or int(res.min()) < 0:
                raise ValueError(
                    f"residual acoustic code {int(res.max())} out of range "
                    f"for residual_codebook_size {r_size}")
            tables = self.cp_params["res_emb"]
            per_depth = torch.stack([
                tables[d][torch.as_tensor(res[d].astype(np.int64), device=dev)]
                for d in range(use)])
            rows = rows + per_depth.float().sum(dim=0).to(rows.dtype)
        return rows

    # -- streaming synthesis ----------------------------------------------

    def stream(
        self,
        prompt: PromptSpec,
        *,
        max_frames: int,
        seed: int = 0,
        collect_codes: bool = False,
    ) -> Iterator[tuple[np.ndarray, dict]]:
        """Yield (wav_chunk int16 PCM [n], info) as audio becomes available;
        the last yield carries info["final"] = True and the whole utterance
        (the concatenation of the streamed chunks). ``collect_codes`` adds
        the codec codes [Q, frames] to the final info.

        Speculative pipelining: once the first chunk is read, up to
        ``pipeline_depth`` chunks are in flight (dispatched, their host
        copies started), so the card decodes chunk k+1 while the host waits
        for chunk k. Chunks dispatched past EOS cost compute, never the
        output. The first chunk is read before the second is dispatched:
        in eager PyTorch dispatching a chunk is the host's whole work for
        it, so a second chunk queued ahead of the first read would land in
        the time to first audio."""
        cfg = self.cfg
        t = cfg.talker
        fps = t.frames_per_step
        hop = cfg.codec.hop
        Q = cfg.codec.num_codebooks
        feedback = t.feedback == "residual_sum"
        t_asm = time.perf_counter()
        plan = self.fast_assembly_plan(prompt)
        emb, pad, trailing = (self.assemble_from_plan(plan) if plan is not None
                              else self.assemble_prompt_full(prompt))
        self.last_assembly = {
            "assembly": "eager" if plan is None else "plan",
            "assembly_ms": (time.perf_counter() - t_asm) * 1e3}
        Lb = emb.shape[1]
        # the talker cache (positions) and the codec's position tables
        # (frames) both cap the utterance
        budget = min((cfg.max_seq_len - Lb) * fps,
                     max_stream_frames(cfg) - 2 * max(self.chunk_schedule))
        max_frames = max(1, min(max_frames, budget))
        # a code2wav stream leads with a run-in that the one-shot decode
        # trims: dropped from the first audio, once per utterance
        startup_skip = (cfg.code2wav.startup_samples
                        if cfg.codec_arch == "code2wav" else 0)

        start = time.perf_counter()
        cache_k, cache_v = self._alloc_cache()
        hidden_last, logits, cache_k, cache_v = self._prefill_fn()(
            self.params, emb, pad, cache_k, cache_v)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        cstate = init_codec_stream_state(cfg, 1, dtype=self.dtype,
                                         device=self.device)
        if feedback:
            tok, res_sum, _ = seed_feedback_frames(
                self.params, self.cp_params, cfg, self.sampling, hidden_last,
                logits, gen, self.mesh)                  # [1, fps], [1, fps, D]
            # the feedback carry holds the config's dtype, as in the JAX
            # package, also where imported float32 tables widen the hidden
            res_sum = res_sum.to(self.dtype)
        else:
            tok = seed_tokens(self.params, cfg, self.sampling, hidden_last,
                              logits, gen)                   # [1, fps]
        state = {"cache_k": cache_k, "cache_v": cache_v, "cstate": cstate,
                 "pos": Lb, "tok": tok, "n_frames": 0, "g": 0}
        if feedback:
            state["res_sum"] = res_sum
        inflight: list[tuple[int, _HostCopy]] = []
        dispatched = 0

        def dispatch(chunk: int) -> None:
            """Enqueue one chunk and start the host copy of its packed
            (valid count, codes, PCM): a fresh tensor, no view of the state
            that the next chunk updates."""
            nonlocal dispatched
            st = state
            # the attention window from the dispatched frames (a talker
            # step advances one position per fps frames)
            A = attn_bucket(Lb + (dispatched + chunk) // fps, cfg.max_seq_len)
            if feedback:
                (st["cache_k"], st["cache_v"], st["cstate"], st["pos"],
                 st["tok"], st["n_frames"], st["res_sum"], st["g"], n_valid,
                 codes, wav) = make_decode_chunk_fn_feedback(
                    cfg, chunk, self.sampling, A, mesh=self.mesh)(
                    self.params, self.cp_params, self.codec_params,
                    st["cache_k"], st["cache_v"], st["cstate"], trailing,
                    st["pos"], pad, st["n_frames"], st["tok"], st["res_sum"],
                    st["g"], gen)
            else:
                (st["cache_k"], st["cache_v"], st["cstate"], st["pos"],
                 st["tok"], st["n_frames"], n_valid, codes,
                 wav) = make_decode_chunk_fn(
                    cfg, chunk, self.sampling, A, mesh=self.mesh)(
                    self.params, self.cp_params, self.codec_params,
                    st["cache_k"], st["cache_v"], st["cstate"], st["pos"],
                    pad, st["n_frames"], st["tok"], gen)
            packed = torch.cat([
                n_valid[:1].to(torch.int32),
                codes[0].reshape(-1).to(torch.int32), wav[0].to(torch.int32),
            ])
            inflight.append((chunk, _HostCopy(packed, start=True)))
            dispatched += chunk

        wav_pieces: list[np.ndarray] = []
        code_pieces: list[np.ndarray] = []
        n_frames = 0
        ttfa = None
        done = False
        # the last chunk stops at the budget: positions past max_seq_len
        # have no cache rows (the JAX package clamps those writes and
        # discards the frames; here they are not computed)
        chunks = chunk_plan(self.chunk_schedule, max_frames, fps)
        pending = next(chunks, None)
        depth = 1                    # until the first chunk is read
        while True:
            while pending is not None and not done and len(inflight) < depth:
                dispatch(pending)
                pending = next(chunks, None)
            if not inflight:
                break
            # ONE host read per chunk: valid count, codes and PCM packed
            chunk, copy = inflight.pop(0)
            packed = copy.numpy()
            depth = max(1, self.pipeline_depth)
            valid = int(packed[0])
            done = valid < chunk
            if valid >= max_frames - n_frames:
                valid = max_frames - n_frames
                done = True
            if valid > 0:
                codes_np = packed[1:1 + Q * chunk].reshape(Q, chunk)
                wav_chunk = packed[1 + Q * chunk:1 + Q * chunk + valid * hop]
                wav_chunk = wav_chunk.astype(np.int16)
                if collect_codes:
                    code_pieces.append(codes_np[:, :valid])
                if startup_skip:
                    cut = min(startup_skip, len(wav_chunk))
                    wav_chunk = wav_chunk[cut:]
                    startup_skip -= cut
                wav_pieces.append(wav_chunk)
                n_frames += valid
                if ttfa is None:
                    ttfa = time.perf_counter() - start
                yield wav_chunk, {"final": False, "frames": n_frames,
                                  "ttfa_s": ttfa}
            if done:
                break

        wav_full = (np.concatenate(wav_pieces) if wav_pieces
                    else np.zeros(0, dtype=np.int16))
        wall = time.perf_counter() - start
        yield wav_full, {
            "final": True,
            "frames": n_frames,
            "ttfa_s": ttfa if ttfa is not None else wall,
            "wall_s": wall,
            "codes": (np.concatenate(code_pieces, axis=1) if code_pieces
                      else None) if collect_codes else None,
        }

    def synthesize(
        self,
        prompt: PromptSpec,
        *,
        max_frames: int,
        seed: int = 0,
        on_chunk: Callable[[np.ndarray], None] | None = None,
        collect_codes: bool = False,
    ) -> GenerationResult:
        """Run the full pipeline; returns the whole waveform and metrics."""
        final_wav = np.zeros(0, dtype=np.int16)
        info: dict = {"frames": 0, "ttfa_s": 0.0, "wall_s": 0.0}
        for wav_chunk, meta in self.stream(
            prompt, max_frames=max_frames, seed=seed,
            collect_codes=collect_codes,
        ):
            if meta["final"]:
                final_wav = wav_chunk
                info = meta
            elif on_chunk is not None:
                on_chunk(wav_chunk)
        sr = self.cfg.codec.sample_rate
        return GenerationResult(
            wav=final_wav,
            frames=info["frames"],
            sample_rate=sr,
            ttfa_s=info["ttfa_s"],
            wall_s=info.get("wall_s", 0.0),
            audio_s=len(final_wav) / sr,
            codes=info.get("codes"),
        )
