"""Continuous batched multi-stream serving: N concurrent voices on one card.

The port of the JAX package's ``runtime/serving.py``. A decode step reads
every weight once whatever the number of rows, so stepping 8 streams costs
about what stepping 1 does; on a host-bound eager path it also issues about
the same kernel launches.

Design (continuous batching, slot model):

- fixed ``max_streams`` decode slots share batched KV caches
  [L, B, S, H_kv, hd], allocated once and written in place;
- per-slot position/pad vectors: ``models.layers.attention`` masks each
  row on its own, so streams join and leave at any time without touching
  other slots (a new prompt overwrites its slot's cache rows);
- CHUNKED prefill, interleaved with decode: a joining prompt is prefilled
  ``prefill_chunk`` tokens at a time into a scratch cache, one slice per
  decode step while other streams are live, then scattered into its slot;
  with no live stream, prompts of one bucket length are prefilled together
  in one batched pass (the cold start);
- one chunk step advances ALL slots with the chunk functions of
  ``runtime.generate`` (the single-stream path runs the same functions:
  the serving == single-stream parity lives in one place); a slot that is
  not decoding holds its position and emits ``codec_pad``;
- multi-token prediction (``frames_per_step`` fps > 1): a slot keeps its
  previous step's fps tokens (and, under residual_sum, their fps feedback
  sums), chunks are whole steps, and a step advances one cache position
  per fps frames;
- per-slot-group attention windows: each group of slots reads only the
  cache prefix its longest stream needs;
- ONE host read per dispatched step: its results packed into one tensor,
  copied ``non_blocking`` into pinned host memory at dispatch and waited
  on (a CUDA event) in :meth:`ServingEngine.collect_step`, so that
  :meth:`ServingEngine.run` can keep two steps in flight.

The decode-layout parameters are ``model.generator``'s (no second copy of
the weights); sampling draws from one ``torch.Generator`` (``rng``).

Over a tp mesh (``parallel.shard_model``) every rank runs this engine on
its shard: the slot caches and prefill scratches hold its kv heads, and
the per-slot state (positions, pads, tokens, trailing buffers, feedback
sums) is replicated, as in the JAX package. Submissions, steps and
retirements follow host values that are equal on every rank (the valid
counts read after the tp sums), so the ranks admit, step and retire in
lockstep when they are given the same calls.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..engine.configs import ModelConfig
from ..engine.weights import _leaves
from ..models.codec import init_codec_stream_state, max_stream_frames
from ..models.layers import (WindowSplit, kv_cache_init, kv_env_format,
                             rope_tables)
from ..models.talker import talker_forward
from ..profiling import trace
from . import generate
from .generate import (
    _HostCopy,
    align_chunk_schedule,
    default_chunk_schedule,
    make_decode_chunk_fn,
    make_decode_chunk_fn_feedback,
    seed_feedback_frames,
    seed_tokens,
)
from .prompts import PromptSpec
from .sampling import SamplingConfig


def _async_fetch() -> bool:
    """Start each step's device->host copy at dispatch
    (QWEN3_TTS_ASYNC_FETCH, default on) rather than at collect."""
    return os.environ.get("QWEN3_TTS_ASYNC_FETCH", "1") != "0"


def _defer_wav() -> bool:
    """Leave waveform and code tensors on the device during serving
    (QWEN3_TTS_DEFER_WAV, default off): each step reads only the [B] valid
    counts; a stream's first audible chunk and on_chunk consumers still get
    host audio per chunk, everything else is read at collect()."""
    return os.environ.get("QWEN3_TTS_DEFER_WAV", "0") != "0"


@dataclass
class Stream:
    """Host-side state of one serving slot."""

    slot: int
    stream_id: int
    active: bool = False      # prefill finished, decoding
    done: bool = False
    frames: int = 0
    max_frames: int = 0
    expected_end: int = 0     # predicted final cache position (grouping)
    codes: list = field(default_factory=list)   # [Q, n] slabs
    # int16 host arrays, or _DeferredWav / _AccumRow views until collect()
    wav_chunks: list = field(default_factory=list)
    submitted_at: float = 0.0
    ttfa_s: float | None = None
    on_chunk: Callable[[np.ndarray], None] | None = None


@dataclass
class _DeferredWav:
    """A wav chunk left on the device (QWEN3_TTS_DEFER_WAV): row ``slot`` of
    one step's [B, chunk*hop] PCM, ``n`` samples from ``start``."""

    copy: _HostCopy
    slot: int
    start: int
    n: int


@dataclass
class _DeferredCodes:
    """A code slab left on the device: row ``slot`` of one step's
    [B, Q, chunk] codes, ``n`` frames."""

    copy: _HostCopy
    slot: int
    n: int


@dataclass
class _AccumRow:
    """A finished stream's accumulated audio (accumulate_wav): its row of
    the device buffer, copied out at finish, read at collect()."""

    copy: _HostCopy
    startup: int              # code2wav run-in samples to drop
    n: int                    # frames * hop valid samples


@dataclass
class _PendingPrefill:
    """A submitted stream whose prompt is still being prefilled."""

    stream: Stream
    # [1, Lb, D] left-padded prompt embeddings; None while the assembly is
    # deferred (``plan``)
    emb: torch.Tensor | None
    pad: int
    Lb: int
    trailing: Any = None      # [1, Tb, D] trailing-text buffer (residual_sum)
    plan: Any = None          # generate.AssemblyPlan of a deferred assembly
    # scratch caches [L, 1, Lb, H_kv, hd], allocated by the slice path
    sk: Any = None
    sv: Any = None
    pos: int = 0              # tokens prefilled so far
    last_logits: Any = None   # [1, V] logits at the final prompt position
    last_hidden: Any = None   # [1, D] hidden at the final prompt position


class ServingEngine:
    """Continuous batched decoding over ``max_streams`` slots."""

    # Whole-prompt cold-batch bound, in scratch-cache rows (nb x Lb): ~114 KB
    # a row at the flagship's width in bf16, so 8192 rows ~0.9 GB of
    # transient scratch; larger groups take the slice path.
    # QWEN3_TTS_COLD_BATCH_ROWS overrides.
    _COLD_BATCH_MAX_ROWS = 8192

    def __init__(
        self,
        model,
        *,
        max_streams: int = 8,
        chunk: int | None = None,
        chunk_schedule: tuple[int, ...] | None = None,
        prefill_chunk: int = 128,
        sampling: SamplingConfig | None = None,
        n_groups: int | None = None,
        accumulate_wav: bool = False,
        accum_cap_frames: int = 600,
    ):
        self.model = model
        self.cfg: ModelConfig = model.cfg
        # the generator's decode-layout trees (fused, grouped, per-layer):
        # shared, not copied
        gen = model.generator
        self.params, self.cp_params = gen.params, gen.cp_params
        self.codec_params = gen.codec_params
        self.mesh = gen.mesh
        self._kv_shape = gen.kv_shape
        self.device = gen.device
        self.dtype = dtype = gen.dtype
        self.B = max_streams
        t = self.cfg.talker
        self.fps = t.frames_per_step
        if chunk_schedule is not None:
            self.chunk_schedule = tuple(chunk_schedule)
        elif chunk is not None:
            self.chunk_schedule = (chunk,)
        else:
            self.chunk_schedule = default_chunk_schedule(t)
        # chunks are whole MTP steps (as the Generator's)
        self.chunk_schedule = align_chunk_schedule(self.chunk_schedule,
                                                   self.fps)
        self.sampling = sampling or SamplingConfig()
        dev, B = self.device, self.B
        shape = self._kv_shape(B, self.cfg.max_seq_len)
        # dense by default; QWEN3_TTS_KV=int8 stores the talker caches as
        # KVQuant pairs. The format is read once: the prefill scratch caches
        # must match the slot caches even if the variable changes mid-run
        self.kv_format = kv_env_format()
        self.cache_k = self._kv_zeros(shape)
        self.cache_v = self._kv_zeros(shape)
        self.cstate = init_codec_stream_state(self.cfg, B, dtype=dtype,
                                              device=dev)
        self.pos = torch.zeros(B, dtype=torch.long, device=dev)
        self.pad = torch.zeros(B, dtype=torch.long, device=dev)
        self.frames_dev = torch.zeros(B, dtype=torch.long, device=dev)
        self.tok = torch.full((B, self.fps), t.codec_pad, dtype=torch.long,
                              device=dev)
        self.active_mask = torch.zeros(B, dtype=torch.bool, device=dev)
        # wav accumulation (batch jobs): each step's PCM is written into a
        # per-slot device buffer, each step reads only the [B] valid
        # counts, and a stream's audio crosses to the host once, when it
        # finishes (no on_chunk consumers, TTFA = first audio on the card)
        self.accum = bool(accumulate_wav)
        if self.accum:
            self.accum_cap_frames = int(accum_cap_frames)
            self.wav_accum = torch.zeros(
                (B, self.accum_cap_frames * self.cfg.codec.hop),
                dtype=torch.int16, device=dev)
        # the published residual_sum protocol: per-slot feedback sums,
        # trailing-text buffers and consumed-row counters
        self.feedback = t.feedback == "residual_sum"
        if self.feedback:
            self.res_sum = torch.zeros((B, self.fps, t.hidden), dtype=dtype,
                                       device=dev)
            self.trail = torch.zeros((B, t.trailing_bucket, t.hidden),
                                     dtype=dtype, device=dev)
            self.trail_g = torch.zeros(B, dtype=torch.long, device=dev)
        self.rng = torch.Generator(device=dev).manual_seed(0)
        self.streams: dict[int, Stream] = {}
        self._slots: list[Stream | None] = [None] * B
        self._next_id = 0
        self.prefill_chunk = prefill_chunk
        # per-slot-group attention windows: contiguous slot groups, each
        # reading only its own longest stream's cache prefix
        if n_groups is not None:
            if max_streams % n_groups:
                raise ValueError(f"n_groups {n_groups} does not divide "
                                 f"max_streams {max_streams}")
            self.n_groups = n_groups
        else:
            self.n_groups = 2 if (max_streams >= 4 and max_streams % 2 == 0) \
                else 1
        self._pending: list[_PendingPrefill] = []
        self._decode_fns: dict[tuple[int, tuple[int, ...]], Callable] = {}
        self._host_pos = [0] * B      # host mirror for attention windows
        self._host_frames = [0] * B   # dispatched frames (chunk picking)

    def _kv_zeros(self, shape: tuple):
        """A zeroed talker cache buffer in the engine's format."""
        return kv_cache_init(shape, self.dtype, kv_format=self.kv_format,
                             device=self.device)

    @property
    def chunk(self) -> int:
        """First-chunk size (TTFA granularity). Assigning pins a fixed
        single-size schedule."""
        return self.chunk_schedule[0]

    @chunk.setter
    def chunk(self, value: int) -> None:
        if value <= 0 or value % self.fps:
            raise ValueError(f"chunk must be a positive multiple of "
                             f"frames_per_step {self.fps}: {value}")
        self.chunk_schedule = (value,)

    def _pick_chunk(self, active) -> int:
        """Schedule position from the YOUNGEST active stream: while some
        stream has not reached the end of a ramp entry, dispatches stay at
        that entry's size (its first audio is one small chunk away); then
        the last entry repeats."""
        sched = self.chunk_schedule
        if len(sched) == 1:
            return sched[0]
        youngest = min(self._host_frames[slot] for slot, _ in active)
        edge = 0
        for c in sched[:-1]:
            edge += c
            if youngest < edge:
                return c
        return sched[-1]

    def _decode_fn(self, chunk: int, wins: tuple[int, ...]) -> Callable:
        """The chunk step for one (chunk, per-group attention windows)
        pair: one window per slot group, a single entry = no split (a
        ``WindowSplit``: its per-row table is made once, on the card)."""
        key = (chunk, wins)
        if key not in self._decode_fns:
            split = (WindowSplit((self.B // len(wins), w) for w in wins)
                     if len(wins) > 1 else None)
            make = (make_decode_chunk_fn_feedback if self.feedback
                    else make_decode_chunk_fn)
            self._decode_fns[key] = make(self.cfg, chunk, self.sampling,
                                         attn_len=max(wins),
                                         window_split=split, mesh=self.mesh)
        return self._decode_fns[key]

    # -- stream lifecycle ---------------------------------------------------

    def free_slots(self) -> int:
        return sum(1 for s in self._slots if s is None)

    def submit(
        self,
        prompt: PromptSpec,
        *,
        max_frames: int,
        on_chunk: Callable[[np.ndarray], None] | None = None,
    ) -> int:
        """Reserve a free slot for ``prompt`` and queue its prefill
        (advanced by later steps); returns the stream id."""
        if all(s is not None for s in self._slots):
            raise RuntimeError("no free slots; call step() until one frees")
        if self.accum:
            if on_chunk is not None:
                raise ValueError(
                    "accumulate_wav keeps audio on the card until a stream "
                    "finishes; per-chunk on_chunk consumers need the "
                    "default streaming engine"
                )
            # steps dispatched past EOS overshoot by up to a few chunks;
            # the buffer covers the budget plus that margin
            margin = 4 * max(self.chunk_schedule)
            if max_frames + margin > self.accum_cap_frames:
                raise ValueError(
                    f"max_frames={max_frames} exceeds the accumulation "
                    f"buffer ({self.accum_cap_frames} frames incl. a "
                    f"{margin}-frame speculative margin); raise "
                    "accum_cap_frames or lower the budget"
                )
        gen = self.model.generator
        # a prompt with a plan defers its assembly (its bucket and pad are
        # known on the host): the cold start's prompts then assemble in one
        # batched call per group (_batch_cold_prefills); the plan raises a
        # tokenizer mismatch here, as the eager chain does
        plan = gen.fast_assembly_plan(prompt)
        if plan is not None:
            emb, pad, trailing, Lb = None, plan.pad, None, plan.Lb
        else:
            emb, pad, trailing = gen.assemble_prompt_full(prompt)
            Lb = emb.shape[1]
        # cap against BOTH the talker cache (positions, fps frames each)
        # and the codec's position tables (frames); the 2-chunk margin
        # covers whole chunks dispatched past the budget
        budget = min((self.cfg.max_seq_len - Lb) * self.fps,
                     max_stream_frames(self.cfg) - 2 * max(self.chunk_schedule))
        max_frames = max(1, min(max_frames, budget))
        # the prompt bucket is left-padded: it fills positions 0..Lb
        expected_end = Lb + -(-max_frames // self.fps)
        slot = self._pick_slot(expected_end)
        stream = Stream(slot=slot, stream_id=self._next_id,
                        max_frames=max_frames, expected_end=expected_end,
                        submitted_at=time.perf_counter(), on_chunk=on_chunk)
        self._next_id += 1
        self._slots[slot] = stream
        self.streams[stream.stream_id] = stream
        self._pending.append(_PendingPrefill(
            stream=stream, emb=emb, pad=pad, Lb=Lb, trailing=trailing,
            plan=plan))
        return stream.stream_id

    def _pick_slot(self, expected_end: int) -> int:
        """A free slot: with slot groups, in the group whose attention
        window this stream widens least (short streams gather away from
        long ones and keep reading a small cache prefix)."""
        attn_bucket = generate.attn_bucket
        free = [i for i, s in enumerate(self._slots) if s is None]
        if self.n_groups == 1:
            return free[0]
        S = self.cfg.max_seq_len
        size = self.B // self.n_groups
        mine = attn_bucket(expected_end, S)
        best, best_cost = None, None
        for g in range(self.n_groups):
            gfree = [i for i in free if i // size == g]
            if not gfree:
                continue
            cur = attn_bucket(max(
                (s.expected_end for s in self._slots[g * size:(g + 1) * size]
                 if s is not None), default=0), S)
            joined = max(cur, mine)
            # my window if I join here, then how much I widen the others'
            cost = (joined, joined - cur)
            if best_cost is None or cost < best_cost:
                best, best_cost = gfree[0], cost
        return best

    # -- prefill and activation ----------------------------------------------

    def _live(self) -> bool:
        return any(s is not None and s.active and not s.done
                   for s in self._slots)

    def _advance_prefills(self) -> None:
        """With no live stream, prefill pending prompts of one bucket
        length together; then slice: ONE slice per step while streams are
        decoding (bounding their stall), otherwise slices until the first
        stream activates."""
        if not self._live() and len(self._pending) > 1:
            self._batch_cold_prefills()
        sliced = False
        while self._pending and not (self._live() and sliced):
            pp = self._pending[0]
            if pp.emb is None:   # the deferred assembly (submit)
                pp.emb, _, pp.trailing = \
                    self.model.generator.assemble_from_plan(pp.plan)
            if pp.sk is None:
                shape = self._kv_shape(1, pp.Lb)
                pp.sk, pp.sv = self._kv_zeros(shape), self._kv_zeros(shape)
            C = min(self.prefill_chunk, pp.Lb - pp.pos)
            self._prefill_slice(pp, C)
            pp.pos += C
            sliced = True
            if pp.pos >= pp.Lb:
                self._pending.pop(0)
                stream = pp.stream
                if self._slots[stream.slot] is stream and not stream.done:
                    self._activate([pp], pp.sk, pp.sv, pp.last_hidden,
                                   pp.last_logits, pp.trailing)

    def _prefill_slice(self, pp: _PendingPrefill, C: int) -> None:
        """Prefill the next ``C`` prompt tokens of ``pp`` into its scratch
        cache."""
        t = self.cfg.talker
        cos_t, sin_t = rope_tables(self.cfg.max_seq_len, t.head_dim,
                                   t.rope_theta, self.device)
        hidden, logits, _, _ = talker_forward(
            self.params, t, pp.emb[:, pp.pos:pp.pos + C], pp.sk, pp.sv,
            pp.pos, cos_t, sin_t, pad_len=pp.pad, head_last_only=True,
            mesh=self.mesh)
        pp.last_logits, pp.last_hidden = logits[:, -1], hidden[:, -1]

    def _batch_cold_prefills(self) -> None:
        """Cold start (no live stream): prefill all pending prompts of one
        bucket length in one whole-prompt pass and activate them together,
        so N simultaneous submissions reach their first decode step after
        about one prefill. Exactly the group's rows are prefilled (eager
        PyTorch has no compile variants to bound). A group whose scratch
        would exceed the row cap takes the slice path. The group's deferred
        prompts assemble with one ``assemble_plans_batched`` call per
        (proto, spk_kind); prompts assembled at submit (clone prompts) keep
        their embedding."""
        t = self.cfg.talker
        max_rows = int(os.environ.get("QWEN3_TTS_COLD_BATCH_ROWS",
                                      self._COLD_BATCH_MAX_ROWS))
        by_len: dict[int, list[_PendingPrefill]] = {}
        for pp in self._pending:
            if pp.pos == 0:  # a join that already started slicing stays
                by_len.setdefault(pp.Lb, []).append(pp)
        for Lb, group in by_len.items():
            nb = len(group)
            if nb < 2 or nb * Lb > max_rows:
                continue
            self._assemble_deferred(group)
            shape = self._kv_shape(nb, Lb)
            sk, sv = self._kv_zeros(shape), self._kv_zeros(shape)
            pads = torch.tensor([pp.pad for pp in group], device=self.device)
            cos_t, sin_t = rope_tables(self.cfg.max_seq_len, t.head_dim,
                                       t.rope_theta, self.device)
            hidden, logits, _, _ = talker_forward(
                self.params, t, torch.cat([pp.emb for pp in group]), sk, sv,
                0, cos_t, sin_t, pad_len=pads, head_last_only=True,
                mesh=self.mesh)
            trailing = (torch.cat([pp.trailing for pp in group])
                        if self.feedback else None)
            for pp in group:
                self._pending.remove(pp)
            self._activate(group, sk, sv, hidden[:, -1], logits[:, -1],
                           trailing)

    def _assemble_deferred(self, group: list[_PendingPrefill]) -> None:
        """Assemble the deferred prompts of ``group`` (one bucket length):
        one ``assemble_plans_batched`` call per (proto, spk_kind), each
        prompt's rows views of its call's output."""
        subgroups: dict[tuple, list[_PendingPrefill]] = {}
        for pp in group:
            if pp.emb is None:
                subgroups.setdefault((pp.plan.proto, pp.plan.spk_kind),
                                     []).append(pp)
        gen = self.model.generator
        for sub in subgroups.values():
            emb, trailing = gen.assemble_plans_batched([pp.plan for pp in sub])
            for i, pp in enumerate(sub):
                pp.emb = emb[i:i + 1]
                pp.trailing = None if trailing is None else trailing[i:i + 1]

    def _activate(self, group: list[_PendingPrefill], sk, sv, hidden, logits,
                  trailing) -> None:
        """Start decoding the prefilled prompts of ``group`` (one bucket
        length): sample their seed tokens (under residual_sum, with the
        seed predictor pass), scatter the scratch caches into their slots
        and set every per-slot state row, the codec's conv contexts zeroed
        (its attention state is rewritten from frame 0 before it is read)."""
        Lb = group[0].Lb
        slots = torch.tensor([pp.stream.slot for pp in group],
                             device=self.device)
        if self.feedback:
            first, rs, _ = seed_feedback_frames(
                self.params, self.cp_params, self.cfg, self.sampling, hidden,
                logits, self.rng, self.mesh)
        else:
            first = seed_tokens(self.params, self.cfg, self.sampling, hidden,
                                logits, self.rng)           # [nb, fps]
        self.cache_k[:, slots, :Lb] = sk
        self.cache_v[:, slots, :Lb] = sv
        self.pos[slots] = Lb
        self.pad[slots] = torch.tensor([pp.pad for pp in group],
                                       device=self.device)
        self.tok[slots] = first
        self.frames_dev[slots] = 0
        self.active_mask[slots] = True
        for _, leaf in _leaves(self.cstate["conv"]):
            leaf[slots] = 0
        if self.feedback:
            self.res_sum[slots] = rs.to(self.res_sum.dtype)
            self.trail[slots] = trailing.to(self.trail.dtype)
            self.trail_g[slots] = 0
        for pp in group:
            self._host_pos[pp.stream.slot] = Lb
            self._host_frames[pp.stream.slot] = 0
            pp.stream.active = True

    # -- decode steps ---------------------------------------------------------

    def dispatch_step(self):
        """Enqueue one decode step for all slots and start its host copy;
        returns a payload for :meth:`collect_step`, or None when nothing is
        decodable yet (only pending prefills advanced). Does not wait for
        the card: the caller may dispatch step k+1 before collecting step
        k. The payload snapshots slot->stream identity, so a step
        dispatched past a stream's end never credits frames to the slot's
        next occupant. No step is dispatched once every stream has its
        whole budget dispatched."""
        with trace("qwen3_tts.engine.dispatch"):
            self._advance_prefills()
            active = [(slot, s) for slot, s in enumerate(self._slots)
                      if s is not None and s.active and not s.done]
            # nothing to decode, or a step that would be thrown away whole
            # (every stream has its budget dispatched): the caller collects
            if all(self._host_frames[slot] >= s.max_frames
                   for slot, s in active):
                return None
            chunk = self._pick_chunk(active)
            steps = chunk // self.fps  # cache positions a dispatch advances
            S = self.cfg.max_seq_len
            size = self.B // self.n_groups
            wins = tuple(
                generate.attn_bucket(
                    max((self._host_pos[slot] for slot, _ in active
                         if slot // size == g), default=0) + steps, S)
                for g in range(self.n_groups))
            fn = self._decode_fn(chunk, wins)
            frames_before = self.frames_dev
            if self.feedback:
                (_, _, self.cstate, self.pos, self.tok, self.frames_dev,
                 self.res_sum, self.trail_g, n_valid, codes, wav) = fn(
                    self.params, self.cp_params, self.codec_params,
                    self.cache_k, self.cache_v, self.cstate, self.trail,
                    self.pos, self.pad,
                    self.frames_dev, self.tok, self.res_sum, self.trail_g,
                    self.rng, active=self.active_mask)
            else:
                (_, _, self.cstate, self.pos, self.tok, self.frames_dev,
                 n_valid, codes, wav) = fn(
                    self.params, self.cp_params, self.codec_params,
                    self.cache_k, self.cache_v, self.cstate, self.pos,
                    self.pad, self.frames_dev, self.tok, self.rng,
                    active=self.active_mask)
            n_valid = n_valid.to(torch.int32)
            if self.accum:
                self._accum_write(wav, frames_before, chunk)
                fetch, codes, wav = n_valid, None, None
            elif _defer_wav():
                fetch = n_valid
                codes = _HostCopy(codes, start=False)
                wav = _HostCopy(wav, start=False)
            else:  # one packed read: valid counts, codes, PCM
                fetch = torch.cat([n_valid,
                                   codes.reshape(-1).to(torch.int32),
                                   wav.reshape(-1).to(torch.int32)])
                codes = wav = None
            for slot, _ in active:
                self._host_pos[slot] += steps
                self._host_frames[slot] += chunk
            snapshot = [(slot, s.stream_id) for slot, s in active]
            return (snapshot, chunk, _HostCopy(fetch, _async_fetch()), codes,
                    wav)

    def _accum_write(self, wav, frames_before, chunk: int) -> None:
        """Write one step's [B, chunk*hop] PCM into the accumulation buffer
        at each slot's frame offset. A row whose write would pass the
        buffer's end is dropped (steps dispatched past a stream's end keep
        advancing its frame counter; a clamped write would overwrite its
        tail)."""
        n = chunk * self.cfg.codec.hop
        cap = self.wav_accum.shape[1]
        ok = frames_before + chunk <= self.accum_cap_frames
        start = (frames_before * self.cfg.codec.hop).clamp(0, cap - n)
        idx = start[:, None] + torch.arange(n, device=self.device)[None, :]
        cur = self.wav_accum.gather(1, idx)
        self.wav_accum.scatter_(1, idx, torch.where(ok[:, None], wav, cur))

    def collect_step(self, payload) -> list[int]:
        """Wait for one dispatched step's host copy and account it; returns
        the ids of the streams that finished."""
        if payload is None:
            return []
        with trace("qwen3_tts.engine.collect"):
            snapshot, chunk, fetch, codes_copy, wav_copy = payload
            B = self.B
            cfg = self.cfg
            hop = cfg.codec.hop
            with trace("qwen3_tts.engine.host_wait"):
                packed = fetch.numpy()
            valid_host = packed[:B]
            codes_host = wav_host = None
            if codes_copy is None and not self.accum:
                n_codes = B * cfg.codec.num_codebooks * chunk
                codes_host = packed[B:B + n_codes].reshape(B, -1, chunk)
                wav_host = packed[B + n_codes:].reshape(
                    B, chunk * hop).astype(np.int16)
            startup_all = (cfg.code2wav.startup_samples
                           if cfg.codec_arch == "code2wav" else 0)

            for slot, stream_id in snapshot:
                stream = self.streams.get(stream_id)
                if (stream is None or stream.done
                        or self._slots[slot] is not stream):
                    continue  # the slot was freed or recycled since dispatch
                valid = int(valid_host[slot])
                remaining = stream.max_frames - stream.frames
                done = valid < chunk or valid >= remaining
                valid = min(valid, remaining)
                if self.accum:
                    if valid > 0:
                        stream.frames += valid
                        if stream.ttfa_s is None:  # first audio on the card
                            stream.ttfa_s = (time.perf_counter()
                                             - stream.submitted_at)
                    if done:
                        # copy the row out now (a later occupant overwrites
                        # it); read it at collect()
                        stream.wav_chunks = [_AccumRow(
                            _HostCopy(self.wav_accum[slot].clone(), True),
                            startup_all, stream.frames * hop)]
                        stream.done = True
                        stream.active = False
                    continue
                if valid > 0:
                    # code2wav: a stream's first chunk leads with the
                    # decoder's run-in (< one frame of samples), dropped
                    startup = startup_all if stream.frames == 0 else 0
                    stream.codes.append(
                        codes_host[slot][:, :valid] if codes_host is not None
                        else _DeferredCodes(codes_copy, slot, valid))
                    chunk_wav = None
                    if wav_host is not None:
                        chunk_wav = stream_wav = wav_host[
                            slot, startup:valid * hop]
                    elif stream.ttfa_s is None or stream.on_chunk is not None:
                        # first audible chunk (TTFA is audio on the host)
                        # or a streaming consumer: this step's PCM read now
                        chunk_wav = stream_wav = (
                            wav_copy.numpy()[slot, startup:valid * hop])
                    else:
                        stream_wav = _DeferredWav(wav_copy, slot, startup,
                                                  valid * hop - startup)
                    stream.wav_chunks.append(stream_wav)
                    stream.frames += valid
                    if stream.ttfa_s is None:
                        stream.ttfa_s = (time.perf_counter()
                                         - stream.submitted_at)
                    if stream.on_chunk is not None:
                        stream.on_chunk(chunk_wav)
                if done:
                    stream.done = True
                    stream.active = False

            finished = []
            for slot, stream in enumerate(self._slots):
                if stream is not None and stream.done:
                    finished.append(stream.stream_id)
                    self._slots[slot] = None
                    self.active_mask[slot] = False
            return finished

    def cancel(self, stream_id: int) -> None:
        """Abort a stream: free its slot, stop its decode row and drop any
        queued prefill. Steps already in flight are safe: their payload
        snapshots fail the slot-identity check in :meth:`collect_step`.
        The stream's record is dropped (it has no result to collect)."""
        stream = self.streams.pop(stream_id, None)
        if stream is None:
            return
        stream.done = True
        stream.active = False
        self._pending = [p for p in self._pending if p.stream is not stream]
        if self._slots[stream.slot] is stream:
            self._slots[stream.slot] = None
            self.active_mask[stream.slot] = False

    def step(self) -> list[int]:
        """Advance every active slot one chunk (and pending prefills one
        slice), synchronously; returns the ids of the streams that
        finished."""
        if not any(s is not None for s in self._slots):
            return []
        return self.collect_step(self.dispatch_step())

    def _resolve_deferred(self) -> None:
        """Read every stream's device-resident chunks, each step's tensor
        once (streams decoded in the same steps share them)."""
        copies: dict[int, _HostCopy] = {}
        for st in self.streams.values():
            for c in st.wav_chunks + st.codes:
                if isinstance(c, (_DeferredWav, _DeferredCodes, _AccumRow)):
                    copies.setdefault(id(c.copy), c.copy)
        for c in copies.values():  # start every copy, then wait
            c.start()

        def resolve_wav(c):
            if isinstance(c, _DeferredWav):
                return c.copy.numpy()[c.slot, c.start:c.start + c.n]
            if isinstance(c, _AccumRow):
                return c.copy.numpy()[c.startup:c.n]
            return c

        for st in self.streams.values():
            st.wav_chunks = [resolve_wav(c) for c in st.wav_chunks]
            st.codes = [c.copy.numpy()[c.slot][:, :c.n]
                        if isinstance(c, _DeferredCodes) else c
                        for c in st.codes]

    def collect(self, stream_id: int) -> tuple[np.ndarray, Stream]:
        """The concatenated waveform and state of a finished stream."""
        stream = self.streams[stream_id]
        self._resolve_deferred()
        wav = (np.concatenate(stream.wav_chunks) if stream.wav_chunks
               else np.zeros(0, np.int16))
        return wav, stream

    # -- run to completion ---------------------------------------------------

    def run(
        self,
        prompts: list[PromptSpec],
        *,
        max_frames: int | list[int],
        pipeline_depth: int = 2,
    ) -> list[tuple[np.ndarray, Stream]]:
        """Serve all prompts to completion (new prompts enter as slots
        free); returns [(wav, stream), ...] in order. ``max_frames`` is one
        budget or one per prompt.

        Up to ``pipeline_depth`` steps are kept in flight, so the host's
        read of step k overlaps the card's work on step k+1; steps
        dispatched past a stream's end cost compute, never correctness
        (the snapshot accounting in :meth:`collect_step`)."""
        budgets = (list(max_frames) if isinstance(max_frames, (list, tuple))
                   else [max_frames] * len(prompts))
        # drop the records of streams finished in earlier runs (the engine
        # is long-lived and reused across generate_audio calls)
        for sid in [s for s, st in self.streams.items() if st.done]:
            del self.streams[sid]
        pending = list(enumerate(prompts))
        ids: dict[int, int] = {}

        def fill_slots():
            while pending and self.free_slots():
                i, p = pending.pop(0)
                ids[i] = self.submit(p, max_frames=budgets[i])

        def unfinished() -> bool:
            return len(ids) < len(prompts) or any(
                not self.streams[sid].done for sid in ids.values())

        def depth_now() -> int:
            # cold-start ramp: one step in flight until some live stream
            # has its first audio (a second step queued ahead of the first
            # chunk's read would land in every stream's TTFA); then deeper
            live = [st for st in self.streams.values() if not st.done]
            if live and all(st.ttfa_s is None for st in live):
                return 1
            return max(1, pipeline_depth)

        fill_slots()
        inflight: list = []
        while unfinished() or inflight:
            while unfinished() and len(inflight) < depth_now():
                payload = self.dispatch_step()
                if payload is None:
                    break
                inflight.append(payload)
            if self.collect_step(inflight.pop(0) if inflight else None):
                fill_slots()
        return [self.collect(ids[i]) for i in range(len(prompts))]
