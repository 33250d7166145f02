#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/qwen3_tts_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port builds, is right, and runs.

    python3 chip_smoke.py            # all phases, one GPU
    python3 chip_smoke.py --profile  # all phases, then traced runs of the
                                     # cb0 and the feedback flagship paths

Phases (any failure exits non-zero; nothing is caught and carried on):

1. build every CUDA kernel from ``src/qwen3_tts_tpu_torch/csrc`` with nvcc
   for sm_90a (one nvcc per source, started together) into build/kernels/,
   printing ptxas' registers and spills; no kernel may spill;
2. hold each kernel against its plain PyTorch version on the card at every
   flagship (N, K) at the row counts the main paths plan for it (M=1, the
   decode chunks, the prefill rows, the feedback predictor's 2-row first
   pass) plus one tiny shape, in bf16, with
   max|kernel - plain| <= 1e-2 * max|plain|; each kernel twice, its two
   outputs bit-identical (split-K reduced in a fixed order), with its
   launch plan's path, rows per block, splits and blocks; time the
   kernel, and, at a talker frame's shapes at M=1, the plain version and
   a library yardstick (plain dequantization plus one torch.matmul), and
   compute the bound (bytes over 3.35 TB/s vs
   operations over 989 TFLOP/s, whichever is larger); then one
   ``frame_sum`` line: each kernel's time, bound and library time summed
   over a talker frame at M=1 (28 layers x 7 linears, plus the head);
   then each kernel's float32 instance the same way (f32_cases: every
   flagship (N, K) at the rows its ring covers, B at a tp = 2 shard at 512
   rows, the tiny shape, one shape of the simple kernels), with
   max|kernel - plain| <= 1e-5 * max|plain|, repeats bit-identical, its
   bound at the float32 CUDA-core rate (67 TFLOP/s); timed only at
   6144x2048 (A at 1/8/32/64 rows, B at 1/32/128) and at the 512-row
   shard, the plain version and the library at M=1 and at B's 128 and
   512 rows; then kernel C (decode attention, ``layers._attend_kernel``)
   against attention's plain code (``layers._attend_plain``) at ATTN_CASES
   (the talker's decode at 64 rows over 512, 1024 and 2048 keys, 1024
   also in two window groups, and the code predictor's two passes): the
   path choice must take it, the context within 1e-2 of the plain code's
   range, the written cache rows within one bf16 ulp of the plain code's,
   every other row untouched, two launches bit-identical; kernel and plain
   code timed beside the bytes bound (the keys each row reads, q/k/v, the
   rows written and the context, over 3.35 TB/s);
3. a tiny model on the card (kernels) against the same model on the CPU
   (plain versions), under both int8 layouts: in bf16, prefill logits
   within tolerance and the greedy codes' agreement printed; in float32,
   the greedy codes must equal the CPU's frame for frame (the float32
   instances' launches over the whole phase are counted from 0); step
   ``assembly``: tiny float32 cb0 and residual_sum models on the card,
   the AssemblyPlan's embedding (and trailing buffer) bit-equal to the
   eager chain's for each speaker kind, a batched assembly of three
   prompts equal to the single ones, and the greedy codes and PCM at
   pipeline_depth 1, 2 and 3 equal;
4. the main path at the flagship's full width, grouped int8 layout:
   load_model("synthetic:flagship") -> generate_audio -> audio_000.wav,
   checked (mono 16-bit 24 kHz, frames x hop samples, finite, not
   silent) with kernel A's and kernel C's launches counted (a bf16 path
   must launch kernel C, and the calls of its kind it declined are held
   to 0 at the end of the script); every main path's prompt
   must assemble from its plan (``assembly``, with the host's
   milliseconds for it, and the stream's ``pipeline_depth`` printed
   beside TTFA and RTF);
5. the same under QWEN3_TTS_INT8_LAYOUT=rowmajor, kernel B's launches
   counted;
6. two more flagship-width paths under the grouped layout:
   load_model("synthetic:flagship-code2wav") (the code2wav decoder) and
   Qwen3TTSModel.synthetic(configs.flagship_feedback_code2wav()) (the
   published residual_sum protocol driving it, the shape of a real
   checkpoint), each WAV frames x hop - the decoder's startup samples
   long;
7. checkpoint import: a snapshot in the published layout at the geometry
   of configs.flagship_feedback_code2wav() (~3 GB; the temp directory
   needs ~11 GB free, with phase 15's recovery export) is fabricated
   (in a thread while phase 1's nvcc processes run), imported with
   load_model(dir) (nothing
   unmapped or synthetic, residual_sum + code2wav at that config's
   widths), reloaded from its _tpu_native cache (every leaf bit-equal to
   the first load's), and driven as one more main path, grouped layout,
   IMPORT_FRAMES frames;
   phase 3 also imports a tiny published-layout snapshot on the card and
   on the CPU, whose float32 greedy codes must be equal. The snapshot
   ships a fabricated Qwen2-style text tokenizer (tokenizer.json and the
   vocab.json + merges.txt layout): the model must load the port's own
   BPE encoder (QwenBPETokenizer) without a warning, its vocabulary must
   hold >= 512 ids, validate_special_tokens must pass on a ChatML render,
   whose ids must not be its UTF-8 bytes, and the ids of every text of
   tests/qwen_bpe_golden.json (transformers' ids on the same files) must
   equal the golden ones;
8. serving (runtime/serving.py::ServingEngine): tiny float32 models with
   int8 weights under the grouped layout (cb0 + rvq, residual_sum +
   code2wav), four streams of different budgets, one joining mid-flight:
   each stream's greedy codes on the card must equal that model's
   single-stream codes on the card and the same engine's codes on the CPU
   (a bf16 run prints its agreement only); then
   configs.flagship_feedback_code2wav() at full width, eight streams (eight
   sentences and voices) of 36 frames after one warm run: aggregate RTF,
   TTFA p50/max, kernel A's launches per step and per frame, kernel C's
   launches (it must run) and declined calls, the shapes they ran, peak memory, every WAV checked, and the cold batch's
   assemble_plans_batched and assemble_from_plan calls (every prompt must
   assemble in a batched call); then a generate_audio call of at
   least three segments, which goes through the same engine;
9. every shape a kernel ran on the main paths, in serving, in the server
   and in cloning that phase 2 did not cover ((M, N, K, gs) for A and B;
   kernel C's ``dims``) is held against its plain version the same way
   (the wrappers record the shapes of their launches);
10. the int8 KV cache (QWEN3_TTS_KV=int8): in phase 3, a tiny float32
   model's greedy codes on the card must equal the CPU's, and the int8
   serving engine's (four streams, one joining mid-flight) must equal int8
   single-stream synthesis on the card; in phase 8, step ``kv_int8``
   serves the same eight full-width streams as step ``flagship`` from
   KVQuant caches (aggregate RTF, TTFA, peak memory, which must be below
   the dense step's, and the share of frames whose codes equal the dense
   run's, information only);
11. cloning: in phase 3, synthetic:tiny:base (the codec encoder, RVQ and the
   speaker vector) and a tiny published-layout snapshot with a Mimi speech
   tokenizer clone a fixed 1 s reference, float32, with reference codes
   and greedy codes on the card equal to the CPU's; phase ``clone`` loads
   phase 7's snapshot, which carries a Mimi speech tokenizer at the
   published widths, with load_model(dir, mode="base"), encodes a 5 s
   reference (time, frames, bucket) and runs generate_audio(ref_audio=...,
   ref_text=...) for 64 frames (RTF, TTFA, peak memory, kernel A launches
   a frame);
12. phase ``asr`` (models/whisper.py): a tiny float32 Whisper from one
   fabricated directory on the card and on the CPU, whose greedy tokens
   and n_valid must be equal; then a snapshot at the published widths of
   openai/whisper-large-v3-turbo (1280 wide, 32 + 4 layers, 128 mels,
   51,866 ids, F16 on disk, ~1.62 GB; the temp directory needs 3 GB
   free) fabricated and loaded with WhisperASR on the card, a 5 s clip
   transcribed cold and warm (load, encode and decode seconds, decode
   steps, tokens, n_valid, peak memory, kernel launches), and the same
   text through transcription.transcribe_wav; step ``quality`` (after
   phase ``server``, on its model): one compare_decode_configs step of
   the int8 KV cache against the dense one, QUALITY_FRAMES frames, the
   turbo Whisper transcribing (mel distance and WER printed, not gated);
13. phase ``server`` (server.py, client side over loopback): a tiny
   float32 greedy model behind TTSService and make_server on the card and
   on the CPU, whose two-segment /v1/synthesize WAV must equal
   generate_audio's on the same device and the card's the CPU's within 2
   LSB; then flagship_feedback_code2wav behind TTSService(max_streams=8):
   eight concurrent clients of 64 frames (four complete, three streaming,
   one of them at speed 1.25, one OpenAI /v1/audio/speech), client-side
   TTFA p50/max (first body byte of a stream), aggregate RTF over the
   responses' audio beside the serving phase's ServingEngine.run, kernel
   A launches a frame, kernel C's launches (it must run), peak memory; a streaming client dropped after its
   first chunk, whose slot must free; /healthz, /v1/models and /metrics
   with the request and error counters checked; step ``batch``: run_batch
   over BATCH_ITEMS items through the same service;
14. phase ``mtp`` (multi-token prediction, batched-cp MTP and speculative
   depth decode): tiny float32 models with int8 weights, grouped layout,
   on the card and on the CPU -- fps 2 and 3 under the cb0 protocol
   (rvq), fps 2 under residual_sum with mtp_cp_batch off and on,
   depth_group 5 with spec_decode at fps 1 (16 codebooks), and a
   ServingEngine of three streams at fps 2 -- whose greedy codes must be
   equal and PCM within 2 LSB; then flagship_feedback_code2wav at two
   frames a step drawn on the card (its MTP heads int8, so they run on
   kernel A), 64 frames through generate_audio with mtp_cp_batch off and
   on: RTF, TTFA, peak memory and kernel A launches a frame beside the
   fps=1 main path's from phase 6;
15. phase ``train`` (training/, finetune.py; dense, so neither int8
   kernel runs: their launch counts are printed, 0 required; kernel C
   runs in the exports' bf16 decodes). Step
   ``reference``: tiny float32 trees from the numpy initialisers, three
   default_optimizer steps on one synthetic batch on the card and on the
   CPU (cb0 with speakers and left padding, residual_sum, fps 2 with
   mtp_cp_batch, depth_group 3 training a grafted draft alone, LoRA r=4):
   the first step's losses and grad norm within 1e-4 relative, the later
   steps' within 1e-3, every parameter element within 0.1 lr after every
   step; then a save after two steps, a restore into fresh trees and a
   third step on the card, equal to the uninterrupted run within the same
   bounds. Steps ``full`` and ``lora``: finetune.main on the dense
   flagship (``--model synthetic``, ~1.8 B parameters) over eight
   seeded 2-4 s clips, 6 steps at batch 4 (``--lora 8`` for lora), with
   s/step (median of steps 2-6), trained frames/s, peak memory and the
   first and final loss, which must be finite; each export loaded and
   decoded for 16 frames, its WAV checked. Step ``recovery`` runs inside
   phase 7 on its snapshot, loaded with QWEN3_TTS_COMPUTE=bf16:
   ``--mtp-fps 2 --mtp-cp-batch --freeze-base``, 4 steps; every leaf
   outside ``mtp`` of the export bit-equal to the loaded tree's, the
   grafted MTP linears moved, 16 frames decoded at fps 2;
16. phase ``app`` (the terminal app: sessions/, io.py, voices.py, ui.py,
   and native/, the C++ audio library), after phase ``clone`` and train's
   ``recovery`` step. Step
   ``native``: the library built with the host's C++ compiler into
   build/native/ (no compiler or a failed compile fails), f32 <-> i16,
   downmix and peak bit-equal to their numpy versions, the resampler's
   identity, lengths, a 1 kHz tone's energy (> 0.99) and 20 kHz down
   > 34 dB, and a 10 s 44.1 kHz stereo -> 24 kHz conversion timed native
   vs numpy + scipy on the host. Steps ``custom``, ``design`` and
   ``clone``: the real run_custom_session (speaker 1, Sad, x1.3),
   run_design_session and run_clone_manager (enroll a voice from a
   44.1 kHz stereo WAV, then clone from the saved voice) on scripted
   input, each model synthetic:flagship-code2wav:<mode> drawn on the
   card, the sleep and screen clear stubbed, AUTO_PLAY off, the output,
   voice and model directories in a temp directory and a recording
   console in each module; each fails unless exactly one mono 16-bit
   24 kHz WAV, finite and not silent, is saved, the console holds no
   error line and kernel A launched (load, session and generate seconds,
   frames, RTF from the WAV's length, peak memory, kernel A launches a
   frame);
17. phase ``parallel`` (parallel/: tensor-parallel decode over
   torch.distributed): two ranks on cuda:0 over gloo (NCCL needs a
   card a rank), started by parallel.comm.launch after phase 1 built the
   kernels. Step ``tiny_f32``: the tiny residual_sum + code2wav model
   (int8 weights, float32) at tp 2, a 16-frame synthesis and four serving
   streams of different budgets, greedy codes equal to the same tree's
   one-rank run on the CPU; ``flagship_f32``: flagship_feedback_code2wav
   in float32 with int8 weights, the talker logits of the prefill and 8
   teacher-forced steps within PARALLEL_F32_TOL of rank 0's unsharded run
   (the largest difference printed beside it); ``flagship_bf16``: the
   same in bf16, a 64-frame synthesis and eight serving streams of 32
   frames, every WAV checked, the ranks' codes equal, kernel A never
   launched and kernel B at the shard shapes (each shape the plan missed
   held against its plain version first); per rank kernel B launches a
   frame and shapes, all_reduce calls a frame, their host seconds and the
   seconds spent first waiting for the card, peak memory, RTF and
   aggregate RTF (no speed claimed: the host-staged gloo
   sum sets the pace);
18. phase ``train_parallel`` (parallel training: pipeline.py, the
   autograd collectives of comm.py, training/ over a mesh), last: eight
   ranks on cuda:0 over gloo, the dry run's pp2 dp2 tp2 mesh with
   sequence parallelism and 4 microbatches. Step ``tiny_f32``: the tiny
   config at float32 from numpy trees, one step held against the same
   trees' one-rank step on the CPU (loss, grad norm, every gathered
   updated leaf within TRAIN_PAR_*_TOL), then a checkpoint round trip
   (saved gathered on rank 0, restored into other trees on the mesh, the
   next step's loss equal to the uninterrupted one's). Step
   ``tiny_f32_anchor``: one step with the anchor and distillation terms
   (frozen trees of other seeds, each rank's slices; TRAIN_PAR_TINY_TERMS)
   held the same way, anchor_pen and distill_kl included. Step
   ``flagship_bf16``: the dense flagship at full width (each rank draws
   the tree leaf by leaf and keeps its slice), batch 8, two steps: the
   first's loss and grad norm against a one-rank step of the same tree on
   the card (TRAIN_PAR_BF16_*_RTOL, the differences printed), finite
   losses, kernels A and B never launched; per rank s/step, tp sums, SP
   gathers and pp shifts a step with their host seconds, peak memory.
   Step ``flagship_bf16_anchor``: one step of a fresh state with both
   terms (TRAIN_PAR_FLAGSHIP_TERMS, one frozen tree of other seeds as
   anchor and teacher), its loss and grad norm against the same step on
   one card rank (TRAIN_PAR_BF16_*_RTOL), s/step and peak memory.
   Step ``finetune``: finetune.main on two ranks (tp 2) on the dense
   flagship, two steps, its export decoded in this process.

Float rules: TF32 off for matmuls and cuDNN convolutions, and no reduced
precision reductions in bf16 matmuls.

Output: one line per shape and phase (each with ``t_s``, the script's
seconds so far), then a ``{"kernels": [...]}`` line (the script fails
after it if kernel C declined a call of its kind on a bf16 path),
the card's name and power limit from nvidia-smi, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
import wave
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "src" / "qwen3_tts_tpu_torch"

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
PEAK_F32_OPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
TOL = 1e-2                    # max|kernel - plain| <= TOL * max|plain| (bf16)
# float32 instances: the same f32 products summed in another order than the
# plain version's; 1e-5 of the output's range is ~100 f32 ulps of it
TOL_F32 = 1e-5

SERVING_STREAMS = 8  # the serving phase's streams at full width
# the feedback code predictor at talker width (hidden_token layout, no
# in_proj): qkv, o, gate_up, down; it runs one frame at a time, 2 rows a
# stream in its first pass (hidden, cb0 token) and 1 after
FEEDBACK_CP_NK = ((3072, 2048), (2048, 1024), (6144, 2048), (2048, 3072))
FEEDBACK_CP_ROWS = (1, 2, SERVING_STREAMS, 2 * SERVING_STREAMS)
# (N, K) of every int8 linear on the flagship main paths
# talker: q, k/v, o, gate/up, down, codec head; code predictor (fused
# decode layout): in_proj, qkv, o, gate_up, down; then the feedback code
# predictor's shapes that the talker does not have
FLAGSHIP_NK = (
    (2048, 2048), (1024, 2048), (6144, 2048), (2048, 6144), (2051, 2048),
    (3072, 1024), (1024, 1024), (6144, 1024), (1024, 3072),
    (3072, 2048), (2048, 1024), (2048, 3072),
)
GS = 64
TINY = (67, 64, 16)  # (N, K, gs)
SIMPLE = (33, 36, 12)  # (N, K, gs) that only the simple kernels take
REPRESENTATIVE = (1, 6144, 2048)  # (M, N, K) reported in the kernels line
F32_TP_SHARD = (512, 3072, 2048)  # (M, N, K): a tp = 2 gate/up shard, 512 rows
# the float32 cases that are timed (the rest are checked only): each
# instance at 6144 x 2048 and the tp shard; plain and library times at M=1
# and at kernel B's operation-bound rows
F32_TIMED_ROWS = {"grouped_qmv": (1, 8, 32, 64),
                  "dequant_matmul": (1, 32, 128, 512)}
F32_YARDSTICK_ROWS = {"grouped_qmv": (1,), "dequant_matmul": (1, 128, 512)}
# one talker frame at M=1: (N, K) -> calls (28 layers of q, k, v, o, gate,
# up, down, then the codec head)
TALKER_FRAME = {(2048, 2048): 56, (1024, 2048): 56, (6144, 2048): 56,
                (2048, 6144): 28, (2051, 2048): 1}
MAIN_FRAMES = 64  # frames of the measured main-path run
INT8_KERNELS = ("grouped_qmv", "dequant_matmul")  # kernels A and B
ATTN = "decode_attention"  # kernel C; its shapes name (B, T, heads,
# kv_heads, window, qk_norm, row_pos, split): the talker's decode at the
# serving engine's 64 rows over windows of 512, 1024 and 2048 keys (1024
# also in two window groups), and the code predictor's seed and later
# passes over its 17-row cache
ATTN_ROWS = 64
ATTN_CASES = tuple((ATTN, ATTN_ROWS, 1, 16, 8, w, 1, 1, 0)
                   for w in (512, 1024, 2048)) + (
    (ATTN, ATTN_ROWS, 1, 16, 8, 1024, 1, 1, 1),
    (ATTN, ATTN_ROWS, 2, 8, 8, 17, 0, 0, 0),
    (ATTN, ATTN_ROWS, 1, 8, 8, 17, 0, 0, 0))
ATTN_REPRESENTATIVE = ATTN_CASES[1]  # reported in the kernels line
# the calls of kernel C's kind that it declined, by bf16 main path and
# measured run; held to 0 at the end of the script
ATTN_DECLINED: dict[str, int] = {}
# cuts for the script's budget (400 s until phase train_parallel, 600 s
# since; phase train added ~40 s): the imported
# snapshot's main path repeats flagship_feedback_code2wav's geometry, the
# asr quality step is not gated, and run_batch needs no eight items to show
# its framing
IMPORT_FRAMES = 32
QUALITY_FRAMES = 24
BATCH_ITEMS = 4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


START = time.perf_counter()


def log(obj) -> None:
    """One output line; a dict gets ``t_s``, the script's seconds so far
    (where the 600 s budget goes)."""
    if isinstance(obj, dict):
        obj = {**obj, "t_s": round(time.perf_counter() - START, 1)}
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def device_time_ms(torch, fn, arg_sets, batches: int = 5, per_batch: int = 10):
    """Median per-call device time: each batch of calls is enqueued behind a
    spin kernel, so the card runs them back to back and the host's launch
    cost is hidden; arguments rotate over copies larger than the L2."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    pairs = []
    for b in range(batches):
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(per_batch):
            fn(*arg_sets[(b * per_batch + i) % len(arg_sets)])
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / per_batch for s, e in pairs)


def bound_ms(m: int, n: int, k: int, gs: int,
             f32: bool = False) -> tuple[float, str]:
    """x and out in bf16 (or f32), int8 codes, f32 scales and biases read
    once; operations at the dense bf16 rate (or the float32 one): the
    products, and the scale and bias applied the cheaper way, to each
    weight once (2nk) or to each row's group sums (2mgn)."""
    g = k // gs
    act = 4 if f32 else 2
    nbytes = m * k * act + n * k + 2 * g * n * 4 + m * n * act
    ops = 2 * m * n * k + 2 * n * min(k, m * g)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / (PEAK_F32_OPS_PER_S if f32 else PEAK_BF16_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build():
    from qwen3_tts_tpu_torch.ops import cuda_kernels

    t0 = time.perf_counter()
    cuda_kernels.build_all()
    build_s = time.perf_counter() - t0
    for k in cuda_kernels.KERNELS:
        ptxas = [ln.strip() for ln in k.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        log({"phase": "build", "kernel": k.name, "library": str(
            k.library_path().relative_to(ROOT)), "ptxas": ptxas})
        spills = [ln for ln in ptxas if "spill" in ln]
        if not spills:
            fail(f"{k.name}: no ptxas spill lines in its build log")
        if any(re.search(r"[1-9]\d* bytes spill", ln) for ln in spills):
            fail(f"{k.name}: ptxas reports spills: {spills}")
    log({"phase": "build", "build_s": round(build_s, 3)})


def _weights(torch, n, k, gs, gen, dev):
    q = torch.randint(0, 256, (n, k), dtype=torch.uint8, generator=gen,
                      device=dev)
    g = k // gs
    scale = (torch.rand((n, g), generator=gen, device=dev) + 0.5) * (0.04 / 255)
    bias = -0.01 - 0.02 * torch.rand((n, g), generator=gen, device=dev)
    return q, scale, bias


def planned_cases() -> list[tuple]:
    """(kernel, M, N, K, gs) for the kernel phase: every flagship (N, K) at
    the rows the main paths give each kernel -- M=1 (talker decode), the
    cb0 code predictor's decode chunks of a MAIN_FRAMES-frame utterance,
    and the prefill rows (A up to its 64-row limit, B the 128-row prompt
    bucket) -- the feedback predictor's 2-row first pass on kernel A, and
    one tiny shape with a ragged N and gs=16; then kernel C's ATTN_CASES."""
    from qwen3_tts_tpu_torch.engine import configs
    from qwen3_tts_tpu_torch.runtime.generate import (
        chunk_plan, default_chunk_schedule,
    )

    chunks = set(chunk_plan(default_chunk_schedule(configs.flagship().talker),
                            MAIN_FRAMES))
    rows = {"grouped_qmv": {1, 8, 24, 32, 64} | chunks,
            "dequant_matmul": {1, 32, 128} | chunks}
    cases = [(name, m, n, k, GS) for n, k in FLAGSHIP_NK
             for name, ms in rows.items() for m in sorted(ms)]
    cases += [("grouped_qmv", m, n, k, GS) for n, k in FEEDBACK_CP_NK
              for m in FEEDBACK_CP_ROWS if m not in rows["grouped_qmv"]]
    n, k, gs = TINY
    return cases + [("grouped_qmv", 3, n, k, gs),
                    ("dequant_matmul", 3, n, k, gs), *ATTN_CASES]


def f32_cases() -> list[tuple]:
    """(kernel, M, N, K, gs) of each kernel's float32 instance: every
    flagship (N, K) at the rows of its ring's instances (A at 1, 8, 24 (8-row
    bands x 3), 32 and 64 rows; B at 1, 16, 32 and the 128-row prefill
    bucket), B at a tp = 2 shard at 512 rows, the tiny ragged shape (the
    rings at N = 67) and one that only the simple kernels take."""
    rows = {"grouped_qmv": (1, 8, 24, 32, 64),
            "dequant_matmul": (1, 16, 32, 128)}
    cases = [(name, m, nn, kk, GS) for nn, kk in FLAGSHIP_NK
             for name, ms in rows.items() for m in ms]
    cases.append(("dequant_matmul", *F32_TP_SHARD, GS))
    return cases + [(name, m, *shape) for name in rows
                    for m, shape in ((3, TINY), (5, SIMPLE))]


def f32_timed(case: tuple) -> bool:
    name, m, n, k, _ = case
    return m in F32_TIMED_ROWS[name] and (
        (n, k) == REPRESENTATIVE[1:] or (m, n, k) == F32_TP_SHARD)


def phase_kernels(torch, cases, checked: dict, source: str,
                  f32: bool = False, timed: bool = True) -> None:
    """Hold each case's kernel against its plain version on the card and
    time kernel, plain version and library yardstick; rows go into
    ``checked`` keyed by case. ``source`` says where the shapes came from;
    ``f32``: float32 x and out (the kernels' float32 instances);
    ``timed=False``: the check alone (one weight copy, no times). The
    plain version and the library are timed only where the kernels line
    and frame_sum read them, a talker frame's shapes at M=1 (float32:
    F32_YARDSTICK_ROWS), for the script's budget. Kernel C's cases (bf16
    only) go to phase_attention."""
    from qwen3_tts_tpu_torch.ops.dequant_matmul import (
        dequant_matmul_cuda, dense_matmul, plan_kernel_b, plan_kernel_b_f32,
        quantized_matmul_ref,
    )
    from qwen3_tts_tpu_torch.ops.grouped_qmv import (
        _dense_route, grouped_qmv_cuda, pack_grouped, plan_kernel_a,
        quantized_matmul_grouped_ref,
    )
    from qwen3_tts_tpu_torch.ops.quant import dequantize

    attn = [c for c in cases if c[0] == ATTN]
    if attn:
        phase_attention(torch, attn, checked, source)
    cases = [c for c in cases if c[0] != ATTN]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(len(checked))
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count

    def lib_rowmajor(x, q, s, b):
        return dense_matmul(x, dequantize({"q": q, "scale": s, "bias": b},
                                          dtype=x.dtype))

    fns = {
        "grouped_qmv": (grouped_qmv_cuda, quantized_matmul_grouped_ref,
                        _dense_route),
        "dequant_matmul": (dequant_matmul_cuda, quantized_matmul_ref,
                           lib_rowmajor),
    }
    dtype, tol = (torch.float32, TOL_F32) if f32 else (torch.bfloat16, TOL)
    for case in cases:
        name, m, n, k, gs = case
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        per_copy = n * k + 2 * (k // gs) * n * 4
        copies = max(1, min(32, math.ceil(128e6 / per_copy))) if timed else 1
        sets = []
        for _ in range(copies):
            q, s, b = _weights(torch, n, k, gs, gen, dev)
            if name == "grouped_qmv":
                gp = pack_grouped({"q": q, "scale": s, "bias": b})
                sets.append((x, gp["qg"], gp["sg"], gp["bg"]))
            else:
                sets.append((x, q, s, b))
        kern, plain, lib = fns[name]
        got = kern(*sets[0])
        want = plain(*sets[0])
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f"{name} M={m} N={n} K={k}: shape {tuple(got.shape)} != "
                 f"{tuple(want.shape)}")
        err = (got.float() - want.float()).abs().max().item()
        scale_ref = want.float().abs().max().item()
        if got.dtype != dtype or not math.isfinite(err) \
                or err > tol * scale_ref:
            fail(f"{name} {dtype} M={m} N={n} K={k} gs={gs}: max|kernel-plain| "
                 f"{err} > {tol} * {scale_ref} (or out dtype {got.dtype})")
        again = kern(*sets[0])
        if not torch.equal(got, again):
            fail(f"{name} {dtype} M={m} N={n} K={k} gs={gs}: two launches on "
                 "the same inputs differ")
        if name == "dequant_matmul":
            plan = (plan_kernel_b_f32 if f32 else plan_kernel_b)(
                m, n, k, gs, sm_count)
            extra = {"ring": plan.ring, "m_frags": plan.m_frags,
                     "rows": plan.tile_m}
        else:
            plan = plan_kernel_a(m, n, k, gs, sm_count)
            extra = {"ring": plan.ring, "ragged": plan.ragged,
                     "rows": plan.rows}
        extra.update(k_splits=plan.k_splits, blocks=plan.blocks)
        t_bound, bound_by = bound_ms(m, n, k, gs, f32)
        times = {"kernel_ms": None, "plain_ms": None, "library_ms": None}
        if timed:
            times["kernel_ms"] = device_time_ms(torch, kern, sets)
        yardstick = (m in F32_YARDSTICK_ROWS[name] if f32
                     else m == 1 and (n, k) in TALKER_FRAME)
        if timed and yardstick:
            times["plain_ms"] = device_time_ms(torch, plain, sets)
            times["library_ms"] = device_time_ms(torch, lib, sets)
        row = {"phase": "kernels", "shapes_from": source, "kernel": name,
               "dtype": str(dtype).replace("torch.", ""),
               "M": m, "N": n, "K": k, "gs": gs, "max_abs_err": err,
               "max_abs_plain": scale_ref, **times, "bound_ms": t_bound,
               "bound_by": bound_by,
               "bound_share": t_bound / times["kernel_ms"] if timed else None,
               **extra}
        log(row)
        checked[case] = row
        del sets
    torch.cuda.empty_cache()


def attention_case(torch, case: tuple, gen, dev, copies: int = 1):
    """Kernel C's inputs for one (ATTN, B, T, heads, kv_heads, window,
    qk_norm, row_pos, split) case: random bf16 q/k/v and caches of
    ``window`` rows (``copies`` sets of them), norm weights near 1, and the
    positions: with row_pos, even rows at the window's end (they read all
    its keys) and odd rows anywhere in it, some of them padded; else one
    int pos at the end; with split, the first half of the rows in a window
    half as wide (their queries past it, as a stale slot's). Returns
    (p, sets of (q, k, v, cache_k, cache_v), attention's keyword arguments,
    the bytes a call must move)."""
    from qwen3_tts_tpu_torch.models.layers import (
        WindowSplit, rope_slice, rope_tables,
    )

    _, B, T, H, Hkv, W, qk_norm, row_pos, split = case
    hd, bf = 128, torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    p = {"q_norm": rnd(hd, scale=0.2) + 1, "k_norm": rnd(hd, scale=0.2) + 1}
    sets = [(rnd(B, T, H * hd), rnd(B, T, Hkv * hd, scale=2.0),
             rnd(B, T, Hkv * hd), rnd(B, W, Hkv, hd), rnd(B, W, Hkv, hd))
            for _ in range(copies)]
    if row_pos:
        pos = [W - T if b % 2 == 0 else (b * 37) % (W - T + 1)
               for b in range(B)]
        pad = [0 if b % 2 == 0 else min(b % 5, pos[b]) for b in range(B)]
        pos_arg, pad_arg = (torch.tensor(x, dtype=torch.int64, device=dev)
                            for x in (pos, pad))
    else:
        pos, pad = [W - T] * B, [0] * B
        pos_arg, pad_arg = W - T, 0
    # a WindowSplit, as the serving engine's: its row table made once
    split_arg = (WindowSplit(((B // 2, W // 2), (B - B // 2, W))) if split
                 else None)
    wins = [w for n, w in split_arg for _ in range(n)] if split else [W] * B
    cos_t, sin_t = rope_tables(W, hd, 1e6, dev)
    cos, sin = rope_slice(cos_t, sin_t, pos_arg, T)
    kw = dict(cos=cos, sin=sin, pos=pos_arg, n_heads=H, n_kv_heads=Hkv,
              head_dim=hd, rms_eps=1e-6, qk_norm=bool(qk_norm),
              pad_len=pad_arg, window_split=split_arg, out_dtype=bf)
    # the keys each row reads (the kernel's range): from min(pos, pad) to
    # the last query's position or the row's window, k and v rows of each
    keys = sum(max(0, min(q + T, w) - min(q, d))
               for q, d, w in zip(pos, pad, wins))
    nbytes = 2 * (2 * keys * Hkv * hd                  # k, v rows read
                  + B * T * (H + 2 * Hkv) * hd         # q, k, v read
                  + 2 * B * T * Hkv * hd               # rows written
                  + B * T * H * hd) \
        + 4 * cos.numel() * 2                          # cos, sin (f32)
    return p, sets, kw, nbytes


def phase_attention(torch, cases, checked: dict, source: str) -> None:
    """Hold kernel C (``layers._attend_kernel``) against attention's plain
    code (``layers._attend_plain``) on the card for each case: the path
    choice must take the kernel; the context within TOL of the plain
    code's range; the written cache rows within one bf16 ulp of the plain
    code's, every other row untouched; two launches bit-identical. Then
    kernel and plain code timed (device time, inputs rotated over copies
    larger than the L2) beside the bytes bound at 3.35 TB/s; rows go into
    ``checked`` keyed by case."""
    from qwen3_tts_tpu_torch.models.layers import (
        _attend_kernel, _attend_plain, _takes_decode_kernel,
    )
    from qwen3_tts_tpu_torch.ops.cuda_kernels import DECODE_ATTENTION

    dims = DECODE_ATTENTION.dims
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(len(checked))
    for case in cases:
        _, B, T, H, Hkv, W, qk_norm, row_pos, split = case
        where = f"{ATTN} " + ",".join(
            f"{d}={v}" for d, v in zip(dims, case[1:]))
        per_copy = 4 * B * W * Hkv * 128
        copies = max(1, min(32, math.ceil(128e6 / per_copy)))
        p, sets, kw, nbytes = attention_case(torch, case, gen, dev, copies)
        q, k, v, ck, cv = sets[0]
        norms = (p["q_norm"], p["k_norm"]) if qk_norm else ()
        if not _takes_decode_kernel(q, k, v, norms, ck, cv, kw["pos"],
                                    kw["pad_len"], kw["window_split"], H,
                                    Hkv, 128, None):
            fail(f"{where}: the path choice does not take the kernel")
        plain_cache = [ck.clone(), cv.clone()]
        want = _attend_plain(p, q, k, v, cache_k=plain_cache[0],
                             cache_v=plain_cache[1], **kw)
        outs, caches = [], []
        for _ in range(2):
            kc = [ck.clone(), cv.clone()]
            outs.append(_attend_kernel(p, q, k, v, cache_k=kc[0],
                                       cache_v=kc[1], **kw))
            caches.append(kc)
        torch.cuda.synchronize()
        got = outs[0]
        err = (got.float() - want.float()).abs().max().item()
        scale_ref = want.float().abs().max().item()
        if got.shape != want.shape or got.dtype != want.dtype \
                or not math.isfinite(err) or err > TOL * scale_ref:
            fail(f"{where}: max|kernel-plain| {err} > {TOL} * {scale_ref} "
                 f"(or shape/dtype {tuple(got.shape)} {got.dtype})")
        if not (torch.equal(outs[0], outs[1]) and all(
                torch.equal(a, b) for a, b in zip(*caches))):
            fail(f"{where}: two launches on the same inputs differ")
        pos = kw["pos"]
        start = (pos.clamp(0, W - T) if isinstance(pos, torch.Tensor)
                 else torch.full((B,), min(max(pos, 0), W - T), device=dev))
        rows = torch.arange(W, device=dev)[None, :]
        written = (rows >= start[:, None]) & (rows < start[:, None] + T)
        for got_c, want_c, old in zip(caches[0], plain_cache, (ck, cv)):
            a, b = got_c[written].float(), want_c[written].float()
            _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
            if not torch.equal(got_c[~written], old[~written]) or not bool(
                    ((a - b).abs() <= torch.ldexp(torch.ones_like(a), e - 8))
                    .all()):
                fail(f"{where}: the cache rows written differ from the plain "
                     "code's by more than one bf16 ulp, or another row moved")

        def kern(q, k, v, ck, cv):
            return _attend_kernel(p, q, k, v, cache_k=ck, cache_v=cv, **kw)

        def plain(q, k, v, ck, cv):
            return _attend_plain(p, q, k, v, cache_k=ck, cache_v=cv, **kw)

        kernel_ms = device_time_ms(torch, kern, sets)
        plain_ms = device_time_ms(torch, plain, sets)
        t_bound = nbytes / PEAK_BYTES_PER_S * 1e3
        row = {"phase": "kernels", "shapes_from": source, "kernel": ATTN,
               "dtype": "bfloat16", **dict(zip(dims, case[1:])),
               "max_abs_err": err, "max_abs_plain": scale_ref,
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": None, "bound_ms": t_bound, "bound_by": "bytes",
               "bound_share": t_bound / kernel_ms, "bytes": nbytes}
        log(row)
        checked[case] = row
        del sets, caches, plain_cache
    torch.cuda.empty_cache()


def kernel_c_ran(where: str, counts: dict) -> int:
    """Kernel C on a measured bf16 run over dense caches: fails unless it
    launched; keeps the calls of its kind it declined there (ATTN_DECLINED,
    held to 0 once every phase ran) and returns them. Read right after the
    run, before anything else calls attention."""
    from qwen3_tts_tpu_torch.ops.cuda_kernels import DECODE_ATTENTION

    ATTN_DECLINED[where] = DECODE_ATTENTION.declined
    if counts[ATTN] == 0:
        fail(f"{where}: kernel C ({ATTN}) never launched on a bf16 path")
    return ATTN_DECLINED[where]


def phase_frame_sum(checked: dict) -> None:
    """Each kernel's time, bound and library time summed over one talker
    frame at M=1 (TALKER_FRAME), in ms."""
    row = {"phase": "frame_sum", "M": 1, "calls": sum(TALKER_FRAME.values())}
    for name in ("grouped_qmv", "dequant_matmul"):
        rows = [(c, checked[(name, 1, n, k, GS)])
                for (n, k), c in TALKER_FRAME.items()]
        row[name] = {key: sum(c * r[key] for c, r in rows)
                     for key in ("kernel_ms", "bound_ms", "library_ms")}
    log(row)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one main-path run with torch.profiler")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not (PKG / "csrc").is_dir():
        fail(f"the port's package is not beside this script ({PKG})")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    log({"phase": "env", "python": sys.version.split()[0],
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "device": torch.cuda.get_device_name(0)})
    snapshot = start_snapshot()
    phase_build()
    snapshot[1].result()  # no timed phase runs beside the fabrication
    checked: dict = {}
    phase_kernels(torch, planned_cases(), checked, "plan")
    phase_frame_sum(checked)
    checked_f32: dict = {}
    for timed in (True, False):
        phase_kernels(torch, [c for c in f32_cases() if f32_timed(c) == timed],
                      checked_f32, "f32", f32=True, timed=timed)
    ref_f32 = phase_reference(torch)
    launches, shapes, runs = phase_main_paths(torch, snapshot)
    app_counts, app_ran = phase_app(torch)
    mtp_counts, mtp_ran = phase_mtp(torch, runs["flagship_feedback_code2wav"])
    counts, ran, serving_rtf = phase_serving(
        torch, runs["flagship_feedback_code2wav"]["rtf"])
    asr, asr_snapshot = phase_asr(torch)
    server_counts, server_ran = phase_server(torch, serving_rtf, asr)
    del asr
    asr_snapshot.cleanup()
    phase_train(torch)
    par_counts, par_ran, par_f32 = phase_parallel(torch, checked, checked_f32)
    train_par_counts = phase_train_parallel(torch)
    for run_shapes in (app_ran, mtp_ran, ran, server_ran, par_ran):
        for name, run in run_shapes.items():
            shapes.setdefault(name, set()).update(run)
    launches = {name: launches[name] + app_counts[name] + mtp_counts[name]
                + counts[name] + server_counts[name] + par_counts[name]
                + train_par_counts[name] for name in launches}
    # the float32 instances: the reference phase's and phase parallel's
    # float32 steps, each counted from 0
    f32_launches = {name: ref_f32[name] + par_f32[name] for name in ref_f32}
    log({"phase": "f32_launches", "reference": ref_f32, "parallel": par_f32,
         "total": f32_launches})
    # every shape the main paths and serving ran is held against its plain
    # version: a shape the plan missed is checked now
    missing = sorted({(name, *shape) for name, run in shapes.items()
                      for shape in run} - checked.keys())
    log({"phase": "coverage",
         "main_path_shapes": {name: len(run) for name, run in shapes.items()},
         "checked_before_main_path": len(checked),
         "missed_by_plan": [list(c) for c in missing]})
    phase_kernels(torch, missing, checked, "main_path")
    if args.profile:
        for label in ("synthetic:flagship", "flagship_feedback_code2wav"):
            phase_profile(torch, label)
        phase_profile_train(torch)

    replaces = {
        "grouped_qmv": "src/qwen3_tts_tpu/ops/grouped_qmv.py:160",
        "dequant_matmul": "src/qwen3_tts_tpu/ops/pallas_matmul.py:39",
    }
    kernels = []
    for name in ("grouped_qmv", "dequant_matmul"):
        r = checked[(name, *REPRESENTATIVE, GS)]
        r32 = checked_f32[(name, *REPRESENTATIVE, GS)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/qwen3_tts_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": f"M={r['M']},N={r['N']},K={r['K']},gs={r['gs']}",
            "f32": {**{key: r32[key] for key in (
                "kernel_ms", "max_abs_err", "plain_ms", "bound_ms",
                "library_ms", "bound_share")},
                "launches": f32_launches[name]},
        })
    from qwen3_tts_tpu_torch.ops import cuda_kernels

    r = checked[ATTN_REPRESENTATIVE]
    kernels.append({
        "name": ATTN, "route": "cuda",
        "source": f"src/qwen3_tts_tpu_torch/csrc/{ATTN}.cu",
        "replaces": "src/qwen3_tts_tpu/models/layers.py::attention (plain "
                    "code between the projections; no TPU kernel)",
        "launches": launches[ATTN],
        "declined": sum(ATTN_DECLINED.values()),
        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "shape": ",".join(f"{d}={v}" for d, v in zip(
            cuda_kernels.DECODE_ATTENTION.dims, ATTN_REPRESENTATIVE[1:])),
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    if any(ATTN_DECLINED.values()):
        fail(f"kernel C declined calls of its kind on bf16 paths: "
             f"{ATTN_DECLINED}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


TEXT = ("The quick brown fox jumps over the lazy dog. "
        "A short sentence to synthesize on the card.")


def phase_reference(torch) -> dict:
    """A tiny model (numpy-seeded weights) on the card, whose int8 linears
    run on the kernels, against the same weights on the CPU, whose linears
    run on the plain versions, under both int8 layouts. In bf16: prefill
    logits within 5e-2 of their range, the greedy codes' agreement
    printed. In float32 (the kernels' float32 instances): prefill logits
    within 1e-3 of their range, and the greedy codes must equal the CPU's
    frame for frame. Then steps assembly, import, kv_int8 and clone.
    Returns each kernel's float32 launches over the phase (counted from
    0), which must not be 0."""
    import dataclasses

    from qwen3_tts_tpu_torch.engine import configs
    from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
    from qwen3_tts_tpu_torch.engine.weights import tree_to
    from qwen3_tts_tpu_torch.ops import cuda_kernels
    from qwen3_tts_tpu_torch.runtime.generate import Generator
    from qwen3_tts_tpu_torch.runtime.prompts import build_prompt
    from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig

    greedy = SamplingConfig(greedy=True)
    cuda_kernels.reset_launch_counts()
    for dtype, tol in (("bfloat16", 5e-2), ("float32", 1e-3)):
        cfg = dataclasses.replace(configs.tiny(quant=True), dtype=dtype)
        host = Qwen3TTSModel.synthetic(cfg, seed=0, device="cpu")
        trees = (host.params, host.cp_params, host.codec_params)
        prompt = build_prompt(host.tokenizer, cfg.mode, "Hello there.",
                              voice="ryan", speakers=cfg.speakers)
        for layout, kernel in (("grouped", cuda_kernels.GROUPED_QMV),
                               ("rowmajor", cuda_kernels.DEQUANT_MATMUL)):
            os.environ["QWEN3_TTS_INT8_LAYOUT"] = layout
            gens = {}
            for dev in ("cpu", "cuda"):
                p, cp, codec = (tree_to(t, dev) for t in trees)
                gens[dev] = Generator(cfg=cfg, params=p, cp_params=cp,
                                      codec_params=codec, sampling=greedy)
            logits = {}
            for dev, gen in gens.items():
                emb, pad = gen._assemble_cb0(prompt)
                ck, cv = gen._alloc_cache()
                _, lg, _, _ = gen._prefill_fn()(gen.params, emb, pad, ck, cv)
                logits[dev] = lg.float().cpu()
            err = (logits["cuda"] - logits["cpu"]).abs().max().item()
            ref = logits["cpu"].abs().max().item()
            if not math.isfinite(err) or err > tol * ref:
                fail(f"tiny prefill logits, {dtype}, {layout}: card vs CPU "
                     f"max err {err} > {tol} * {ref}")
            before = kernel.by_dtype[dtype]
            codes = {dev: gen.synthesize(prompt, max_frames=16,
                                         collect_codes=True).codes
                     for dev, gen in gens.items()}
            if kernel.by_dtype[dtype] == before:
                fail(f"tiny {dtype}, {layout}: {kernel.name}'s {dtype} "
                     "instance never launched")
            same = codes["cuda"].shape == codes["cpu"].shape
            lead = 0
            if same:
                diff = (codes["cuda"] != codes["cpu"]).any(axis=0)
                lead = int(diff.argmax()) if diff.any() else diff.size
            log({"phase": "reference", "dtype": dtype, "layout": layout,
                 "prefill_logits_max_err": err, "prefill_logits_max": ref,
                 "greedy_frames_equal_before_first_difference": lead,
                 "frames": int(codes["cpu"].shape[1]),
                 "frames_card": int(codes["cuda"].shape[1])})
            if dtype == "float32" and not (
                    same and lead == codes["cpu"].shape[1]):
                fail(f"tiny float32, {layout}: the card's greedy codes differ "
                     f"from the CPU's (equal for {lead} frames)")
    os.environ.pop("QWEN3_TTS_INT8_LAYOUT")
    phase_reference_assembly(torch)
    phase_reference_import(torch)
    phase_reference_kv_int8(torch)
    phase_reference_clone(torch)
    counts = {k.name: k.by_dtype["float32"] for k in cuda_kernels.KERNELS
              if "float32" in k.by_dtype}
    if not all(counts.values()):
        fail(f"reference: a float32 instance never launched: {counts}")
    return counts


def phase_reference_assembly(torch) -> None:
    """Step ``assembly`` of phase 3: tiny float32 models with int8 weights
    on the card, cb0 and residual_sum: the plan's (emb, pad, trailing)
    bit-equal to the eager chain's on the card for each speaker kind and
    made with no host read (torch.cuda.set_sync_debug_mode("error")), one
    batched assembly of three prompts equal to the three single ones, and
    the greedy codes and PCM at pipeline_depth 1, 2 and 3 equal."""
    import dataclasses

    import numpy as np

    from qwen3_tts_tpu_torch.engine import configs
    from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
    from qwen3_tts_tpu_torch.runtime.prompts import PromptSpec
    from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig

    for proto, cfg in (("cb0", configs.tiny("custom", quant=True)),
                       ("residual_sum", configs.tiny_feedback("custom"))):
        cfg = dataclasses.replace(cfg, dtype="float32")
        gen = Qwen3TTSModel.synthetic(cfg, seed=5, device="cuda").generator
        gen.sampling = SamplingConfig(greedy=True)
        kinds = {"table": {"speaker_id": 1}, "codec": {"speaker_token": 3},
                 "none": {}}
        for kind, kw in kinds.items():
            prompt = PromptSpec(text_tokens=np.arange(9, dtype=np.int32) + 2,
                                **kw)
            plan = gen.fast_assembly_plan(prompt)
            # the plan's device work reads nothing back on the host
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = gen.assemble_from_plan(plan)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            gen._fast_assembly = False
            want = gen.assemble_prompt_full(prompt)
            gen._fast_assembly = True
            if got[1] != want[1] or not torch.equal(got[0], want[0]) or (
                    got[2] is not None and not torch.equal(got[2], want[2])):
                fail(f"reference assembly, {proto}, {kind}: the plan's "
                     "embedding differs from the eager chain's on the card")
        plans = [gen.fast_assembly_plan(PromptSpec(
            text_tokens=np.arange(n, dtype=np.int32) + 5, speaker_id=1))
            for n in (5, 12, 27)]
        emb, trailing = gen.assemble_plans_batched(plans)
        for i, plan in enumerate(plans):
            e, _, tr = gen.assemble_from_plan(plan)
            if not torch.equal(emb[i:i + 1], e) or (
                    tr is not None and not torch.equal(trailing[i:i + 1], tr)):
                fail(f"reference assembly, {proto}: batched plan {i} differs "
                     "from its single assembly")
        prompt = PromptSpec(text_tokens=np.arange(9, dtype=np.int32) + 2,
                            speaker_id=1)
        runs = {}
        for depth in (1, 2, 3):
            gen.pipeline_depth = depth
            runs[depth] = gen.synthesize(prompt, max_frames=40,
                                         collect_codes=True)
        for depth, r in runs.items():
            if r.frames != runs[1].frames or not (
                    np.array_equal(r.codes, runs[1].codes)
                    and np.array_equal(r.wav, runs[1].wav)):
                fail(f"reference assembly, {proto}: greedy output at "
                     f"pipeline_depth {depth} differs from depth 1's")
        log({"phase": "reference", "step": "assembly", "protocol": proto,
             "speaker_kinds": sorted(kinds), "plan_equals_eager": True,
             "batched_equals_single": True, "depths": sorted(runs),
             "frames": runs[1].frames, "greedy_equal_across_depths": True,
             "last_assembly": gen.last_assembly})


def _lead(got, want) -> int:
    """Frames of two codes arrays [Q, T] equal before the first difference."""
    n = min(got.shape[1], want.shape[1])
    diff = (got[:, :n] != want[:, :n]).any(axis=0)
    return int(diff.argmax()) if diff.any() else n


def phase_reference_kv_int8(torch) -> None:
    """QWEN3_TTS_KV=int8 on a tiny float32 model with int8 weights, grouped
    layout: single-stream greedy codes on the card must equal the CPU's
    for four prompts, and the int8 serving engine's (budgets as phase 8's
    reference, the fourth stream joining mid-flight) must equal int8
    single-stream synthesis on the card."""
    import dataclasses

    import numpy as np

    from qwen3_tts_tpu_torch.engine import configs, prepare_segments
    from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
    from qwen3_tts_tpu_torch.models.layers import KVQuant
    from qwen3_tts_tpu_torch.ops import cuda_kernels
    from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig
    from qwen3_tts_tpu_torch.runtime.serving import ServingEngine

    os.environ["QWEN3_TTS_INT8_LAYOUT"] = "grouped"
    os.environ["QWEN3_TTS_KV"] = "int8"
    greedy = SamplingConfig(greedy=True)
    budgets = (6, 16, 11, 12)
    cfg = dataclasses.replace(configs.tiny(quant=True), dtype="float32")
    host = Qwen3TTSModel.synthetic(cfg, seed=0, device="cpu")
    prompts = [prepare_segments(host, text, voice=voice)[0][0]
               for text, voice in zip(SERVING_TEXTS[:4], cfg.speakers)]
    single = {}
    before = cuda_kernels.GROUPED_QMV.launches
    for dev in ("cpu", "cuda"):
        model = Qwen3TTSModel.synthetic(cfg, seed=0, device="cpu").to(dev)
        model.sampling = greedy
        if not isinstance(model.generator._alloc_cache()[0], KVQuant):
            fail(f"kv_int8 reference, {dev}: the Generator's cache is dense")
        single[dev] = [model.generator.synthesize(
            p, max_frames=b, collect_codes=True).codes
            for p, b in zip(prompts, budgets)]
    engine = ServingEngine(model, max_streams=4, sampling=greedy)
    if not isinstance(engine.cache_k, KVQuant):
        fail("kv_int8 reference: the serving engine's cache is dense")
    served = [np.concatenate(c, 1)
              for c in _serving_codes(engine, prompts, budgets)]
    if cuda_kernels.GROUPED_QMV.launches == before:
        fail("kv_int8 reference: kernel A never launched on the card")
    same_cpu = all(np.array_equal(a, b)
                   for a, b in zip(single["cuda"], single["cpu"]))
    same_single = all(np.array_equal(a, b)
                      for a, b in zip(served, single["cuda"]))
    log({"phase": "reference_kv_int8", "dtype": "float32", "layout": "grouped",
         "budgets": list(budgets),
         "frames": [int(c.shape[1]) for c in single["cpu"]],
         "card_equals_cpu": same_cpu,
         "serving_equals_single_stream": same_single,
         "card_vs_cpu_frames_equal_before_first_difference":
             [_lead(a, b) for a, b in zip(single["cuda"], single["cpu"])],
         "serving_vs_single_frames_equal_before_first_difference":
             [_lead(a, b) for a, b in zip(served, single["cuda"])]})
    if not (same_cpu and same_single):
        fail(f"kv_int8 reference, float32: the card's greedy codes differ "
             f"from the CPU's ({same_cpu}) or the int8 engine's from int8 "
             f"single-stream synthesis ({same_single})")
    os.environ.pop("QWEN3_TTS_KV")
    os.environ.pop("QWEN3_TTS_INT8_LAYOUT")


def reference_clip(seconds: float, sr: int = 24000, seed: int = 3):
    """A fixed reference voice: a gliding tone with a little noise. Seed 3
    leaves the tiny float32 model's RVQ argmins a relative margin of
    3.5e-3 (the card's and the CPU's summation orders differ by ~1e-6)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f = 110 + 40 * np.sin(2 * np.pi * 0.7 * t)
    return (0.3 * np.sin(2 * np.pi * np.cumsum(f) / sr)
            + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


def phase_reference_clone(torch) -> None:
    """Cloning on tiny float32 models, grouped layout, on the card and on
    the CPU: synthetic:tiny:base (the codec encoder, RVQ and the speaker
    vector) and a tiny published-layout snapshot whose Mimi speech
    tokenizer maps, each cloning a fixed 1 s reference through
    generate_audio(ref_audio=..., ref_text=...). The reference codes and
    the greedy codes on the card must equal the CPU's."""
    import dataclasses

    import numpy as np

    from qwen3_tts_tpu_torch.audio import write_wav
    from qwen3_tts_tpu_torch.engine import (
        configs, generate_audio, load_model, prepare_segments,
    )
    from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
    from qwen3_tts_tpu_torch.engine.fabricate import write_published_snapshot
    from qwen3_tts_tpu_torch.ops import cuda_kernels
    from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig

    os.environ["QWEN3_TTS_INT8_LAYOUT"] = "grouped"
    greedy = SamplingConfig(greedy=True)
    clip = reference_clip(1.0)
    base = dataclasses.replace(configs.tiny("base", quant=True),
                               dtype="float32")
    feedback = configs.with_quant(configs.with_code2wav(
        configs.tiny_feedback("base"), configs.tiny_code2wav().code2wav), True)
    with tempfile.TemporaryDirectory(prefix="q3tts_clone_ref_") as tmp:
        ref = os.path.join(tmp, "ref.wav")
        write_wav(ref, clip, 24000)
        write_published_snapshot(os.path.join(tmp, "snap"), feedback, seed=9,
                                 fast=False, speech_tokenizer=True)

        def build(label, dev):
            if label == "synthetic:tiny:base":
                return Qwen3TTSModel.synthetic(base, seed=0,
                                               device="cpu").to(dev)
            model = load_model(os.path.join(tmp, "snap"), device=dev,
                               mode="base", cache=False)
            rep = model.import_report.speech_tokenizer
            if model.st_params is None or rep["preserved"] or not rep["mapped"]:
                fail(f"clone reference, {label}: the speech tokenizer did "
                     f"not map ({rep})")
            widen_to_f32(torch, model)
            return model

        for label in ("synthetic:tiny:base", "snapshot:mimi"):
            out = {}
            before = cuda_kernels.GROUPED_QMV.launches
            for dev in ("cpu", "cuda"):
                model = build(label, dev)
                model.sampling = greedy
                prompt = prepare_segments(
                    model, "Hello there.", ref_audio=ref,
                    ref_text="A reference transcript.")[0][0]
                codes, spk = prompt.acoustic_codes, prompt.speaker_vector
                res = model.generator.synthesize(prompt, max_frames=12,
                                                 collect_codes=True)
                m = generate_audio(model=model, text="Hello there.",
                                   ref_audio=ref,
                                   ref_text="A reference transcript.",
                                   output_path=os.path.join(tmp, dev),
                                   max_frames=12)
                out[dev] = (codes, spk, res.codes, m["frames"])
            if cuda_kernels.GROUPED_QMV.launches == before:
                fail(f"clone reference, {label}: kernel A never launched")
            (c_cpu, s_cpu, g_cpu, f_cpu), (c_gpu, s_gpu, g_gpu, f_gpu) = (
                out["cpu"], out["cuda"])
            ref_equal = np.array_equal(c_cpu, c_gpu)
            gen_equal = g_cpu.shape == g_gpu.shape and np.array_equal(g_cpu,
                                                                      g_gpu)
            spk_err = (float(np.abs(s_cpu - s_gpu).max())
                       if s_cpu is not None else None)
            log({"phase": "reference_clone", "model": label,
                 "dtype": "float32", "layout": "grouped",
                 "reference_s": 1.0, "reference_codes": list(c_cpu.shape),
                 "reference_codes_equal": ref_equal,
                 "speaker_vector_max_err": spk_err,
                 "frames": int(g_cpu.shape[1]),
                 "frames_card": int(g_gpu.shape[1]),
                 "greedy_codes_equal": gen_equal,
                 "generate_audio_frames": [f_cpu, f_gpu]})
            if not (ref_equal and gen_equal) or (
                    spk_err is not None and spk_err > 1e-4):
                fail(f"clone reference, {label}, float32: the card's "
                     f"reference codes ({ref_equal}), speaker vector "
                     f"(max err {spk_err}) or greedy codes ({gen_equal}) "
                     "differ from the CPU's")
    os.environ.pop("QWEN3_TTS_INT8_LAYOUT")


def widen_to_f32(torch, model) -> None:
    """A loaded model at float32: the config's dtype replaced and every
    bf16 leaf widened (exact)."""
    import dataclasses

    def widen(node):
        if isinstance(node, dict):
            return {k: widen(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(widen(v) for v in node)
        return node.float() if node.dtype == torch.bfloat16 else node

    model.cfg = dataclasses.replace(model.cfg, dtype="float32")
    for comp in ("params", "cp_params", "codec_params"):
        setattr(model, comp, widen(getattr(model, comp)))
    model._generator = None
    model._serving = None


def phase_reference_import(torch) -> None:
    """A tiny snapshot in the published layout imported on the card and
    on the CPU, both widened to float32, grouped layout: the card's greedy
    codes must equal the CPU's frame for frame."""
    import dataclasses

    from qwen3_tts_tpu_torch.engine import configs, load_model, prepare_segments
    from qwen3_tts_tpu_torch.engine.fabricate import write_published_snapshot
    from qwen3_tts_tpu_torch.ops import cuda_kernels
    from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig

    os.environ["QWEN3_TTS_INT8_LAYOUT"] = "grouped"
    cfg = configs.with_quant(configs.with_code2wav(
        configs.tiny_feedback(), configs.tiny_code2wav().code2wav), True)
    with tempfile.TemporaryDirectory(prefix="q3tts_tiny_snapshot_") as snap:
        write_published_snapshot(snap, cfg, seed=9, fast=False)
        codes = {}
        before = cuda_kernels.GROUPED_QMV.launches
        for dev in ("cpu", "cuda"):
            model = load_model(snap, device=dev, cache=False)
            if model.import_report.unmapped or model.cfg.talker.feedback \
                    != "residual_sum":
                fail(f"tiny published snapshot on {dev}: unmapped "
                     f"{model.import_report.unmapped[:5]}, protocol "
                     f"{model.cfg.talker.feedback}")
            widen_to_f32(torch, model)
            model.sampling = SamplingConfig(greedy=True)
            prompts, _ = prepare_segments(model, "Hello there.", voice="ryan")
            codes[dev] = model.generator.synthesize(
                prompts[0], max_frames=16, collect_codes=True).codes
    if cuda_kernels.GROUPED_QMV.launches == before:
        fail("tiny imported snapshot: grouped_qmv never launched on the card")
    same = codes["cuda"].shape == codes["cpu"].shape and bool(
        (codes["cuda"] == codes["cpu"]).all())
    log({"phase": "reference_import", "dtype": "float32", "layout": "grouped",
         "frames": int(codes["cpu"].shape[1]),
         "frames_card": int(codes["cuda"].shape[1]),
         "greedy_codes_equal": same})
    if not same:
        fail("tiny imported snapshot, float32: the card's greedy codes "
             "differ from the CPU's")
    os.environ.pop("QWEN3_TTS_INT8_LAYOUT")


# the main paths: (model, int8 layout, the kernel that layout runs, frames
# of the measured run); a "synthetic:" model comes from load_model, any
# other name is a preset of engine/configs.py given to
# Qwen3TTSModel.synthetic (the feedback presets have no "synthetic:" name)
MAIN_PATHS = (
    ("synthetic:flagship", "grouped", "grouped_qmv", MAIN_FRAMES),
    ("synthetic:flagship", "rowmajor", "dequant_matmul", MAIN_FRAMES),
    ("synthetic:flagship-code2wav", "grouped", "grouped_qmv", MAIN_FRAMES),
    ("flagship_feedback_code2wav", "grouped", "grouped_qmv", MAIN_FRAMES),
)


def _build(label: str):
    from qwen3_tts_tpu_torch.engine import configs, load_model
    from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel

    if label.startswith("synthetic:"):
        return load_model(label, device="cuda", seed=0)
    return Qwen3TTSModel.synthetic(getattr(configs, label)(), seed=0,
                                   device="cuda")


def phase_main_path(torch, label: str, layout: str, kernel: str,
                    frames: int, model=None) -> tuple[dict, dict, dict]:
    """The model ``label`` (or ``model``, already loaded) at full width ->
    generate_audio under one int8 layout; returns every kernel's launches in
    the measured run, the (M, N, K, gs) shapes each ran there, and its
    numbers (RTF, TTFA, peak memory, kernel A launches a frame). A bf16
    model must run kernel C (kernel_c_ran)."""
    import numpy as np

    from qwen3_tts_tpu_torch.engine import generate_audio
    from qwen3_tts_tpu_torch.ops import cuda_kernels

    os.environ["QWEN3_TTS_INT8_LAYOUT"] = layout
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if model is None:
        model = _build(label)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    where = f"{label}, {layout}"
    with tempfile.TemporaryDirectory() as out:
        # first call: library handles, allocator, first launches
        warm = generate_audio(model=model, text=TEXT, voice="ryan",
                              output_path=out, max_frames=16, seed=1)
        torch.cuda.synchronize()
        cuda_kernels.reset_launch_counts()
        m = generate_audio(model=model, text=TEXT, voice="ryan",
                           output_path=out, max_frames=frames, seed=0)
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in cuda_kernels.KERNELS}
        shapes = {k.name: set(k.shapes) for k in cuda_kernels.KERNELS}
        declined = (kernel_c_ran(f"main_path {where}", counts)
                    if model.cfg.dtype == "bfloat16" else None)
        path = os.path.join(out, "audio_000.wav")
        if not os.path.exists(path):
            fail(f"{where}: {path} was not written")
        with wave.open(path, "rb") as w:
            fmt = (w.getnchannels(), w.getsampwidth(), w.getframerate())
            n = w.getnframes()
            pcm = np.frombuffer(w.readframes(n), dtype="<i2")
    cfg = model.cfg
    hop = cfg.codec.hop
    # a code2wav stream's first samples are the decoder's run-in, dropped
    skip = cfg.code2wav.startup_samples if cfg.codec_arch == "code2wav" else 0
    if fmt != (1, 2, 24000):
        fail(f"{where}: wav format {fmt}, expected mono 16-bit 24 kHz")
    if m["frames"] < 1 or n != m["frames"] * hop - skip:
        fail(f"{where}: {n} samples for {m['frames']} frames (hop {hop}, "
             f"startup {skip})")
    if not np.isfinite(pcm.astype(np.float64)).all() or not pcm.any():
        fail(f"{where}: the waveform is silent or not finite")
    if counts[kernel] == 0:
        fail(f"{where}: kernel {kernel} never launched on the main path")
    gen = model.generator
    if gen.last_assembly["assembly"] != "plan":
        fail(f"{where}: the prompt took the eager chain, not the plan")
    summary = {"frames_per_step": cfg.talker.frames_per_step,
               "mtp_cp_batch": cfg.talker.mtp_cp_batch,
               "assembly": gen.last_assembly["assembly"],
               "assembly_ms": gen.last_assembly["assembly_ms"],
               "pipeline_depth": gen.pipeline_depth,
               "frames": m["frames"], "rtf": m["rtf"], "ttfa_s": m["ttfa_s"],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "grouped_qmv_launches_per_frame":
                   counts["grouped_qmv"] / m["frames"]}
    log({"phase": "main_path", "layout": layout, "model": label,
         "protocol": cfg.talker.feedback, "codec": cfg.codec_arch,
         "frames_per_step": cfg.talker.frames_per_step,
         "frames": m["frames"], "audio_s": m["audio_s"], "wall_s": m["wall_s"],
         "rtf": m["rtf"], "ttfa_s": m["ttfa_s"], "load_s": load_s,
         "assembly": summary["assembly"],
         "assembly_ms": summary["assembly_ms"],
         "pipeline_depth": summary["pipeline_depth"],
         "warmup_wall_s": warm["wall_s"], "samples": n,
         "startup_samples_dropped": skip,
         "peak_mem_gb": summary["peak_mem_gb"],
         "launches": counts,
         "launches_per_frame": {name: c / m["frames"]
                                for name, c in counts.items()},
         "decode_attention_declined": declined,
         "shapes": {name: sorted(run) for name, run in shapes.items()}})
    del model
    torch.cuda.empty_cache()
    os.environ.pop("QWEN3_TTS_INT8_LAYOUT")
    return counts, shapes, summary


def phase_profile(torch, label: str) -> None:
    """Where the main path's time goes (the model ``label``, grouped layout,
    64 frames): one unprofiled run, then one under torch.profiler; the
    card's busy share is the profiled kernels' device time over the
    unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    from qwen3_tts_tpu_torch.engine import generate_audio

    os.environ["QWEN3_TTS_INT8_LAYOUT"] = "grouped"
    model = _build(label)
    with tempfile.TemporaryDirectory() as out:
        kw = dict(model=model, text=TEXT, voice="ryan", output_path=out)
        generate_audio(max_frames=16, seed=1, **kw)
        torch.cuda.synchronize()
        plain = generate_audio(max_frames=MAIN_FRAMES, seed=0, **kw)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced = generate_audio(max_frames=MAIN_FRAMES, seed=0, **kw)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    launches = sum(e.count for e in kernels)
    log({"phase": "profile", "model": label, "layout": "grouped",
         "frames": plain["frames"],
         "wall_s": plain["wall_s"], "wall_s_traced": traced["wall_s"],
         "device_kernel_s": device_s if kernels else "not measured",
         "device_busy_share": device_s / plain["wall_s"] if kernels
         else "not measured",
         "kernel_launches": launches,
         "top_kernels": [{"name": e.key[:80], "count": e.count,
                          "device_ms": e.self_device_time_total / 1e3}
                         for e in top[:12]]})
    del model
    torch.cuda.empty_cache()
    os.environ.pop("QWEN3_TTS_INT8_LAYOUT")


GB = 1e9
# the ~3 GB snapshot, its ~3.2 GB native cache and the ~3.8 GB dense
# export of step train/recovery
IMPORT_DISK_NEED = 11 * GB


def _same_tree(torch, a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(torch, a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_tree(torch, x, y)
                                        for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def start_snapshot():
    """Fabricate phase import's snapshot in a thread while phase build's
    nvcc processes run (numpy and disk beside subprocesses; main waits
    for it before any timed phase): the published layout at
    configs.flagship_feedback_code2wav()'s geometry, with a Mimi speech
    tokenizer at the published widths, in a new temporary directory that
    phase_import removes. Returns (the directory, the future of the
    fabrication's log row)."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from qwen3_tts_tpu_torch.engine import configs
    from qwen3_tts_tpu_torch.engine.fabricate import write_published_snapshot
    from qwen3_tts_tpu_torch.models.speech_tokenizer import (
        SpeechTokenizerConfig,
    )

    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    log({"phase": "import", "step": "disk", "tmpdir": tmp,
         "free_gb": free / GB, "needed_gb": IMPORT_DISK_NEED / GB})
    if free < IMPORT_DISK_NEED:
        fail(f"import: {free / GB:.1f} GB free in {tmp}, the phase needs "
             f"{IMPORT_DISK_NEED / GB:.0f} GB")
    directory = tempfile.TemporaryDirectory(prefix="q3tts_snapshot_")

    def fabricate() -> dict:
        t0 = time.perf_counter()
        nbytes = write_published_snapshot(
            directory.name, configs.flagship_feedback_code2wav(), seed=0,
            fast=True, speech_tokenizer=SpeechTokenizerConfig())
        return {"phase": "import", "step": "fabricate", "bytes": nbytes,
                "fabricate_s": time.perf_counter() - t0,
                "beside": "phase build"}

    pool = ThreadPoolExecutor(1)
    fabrication = pool.submit(fabricate)
    pool.shutdown(wait=False)
    return directory, fabrication


def phase_import(torch, feedback_rtf: float,
                 snapshot) -> tuple[dict, dict, float]:
    """Checkpoint import at full width: the snapshot of start_snapshot,
    load_model(dir) onto the card (first import, then the _tpu_native
    cache, which must give the same leaves bit for bit), and driven as a
    main path; then phase ``clone`` on the same snapshot. Returns the
    import run's kernel launches, the shapes both runs ran, and the import
    run's RTF."""
    import dataclasses

    from qwen3_tts_tpu_torch.engine import configs, load_model
    from qwen3_tts_tpu_torch.models.speech_tokenizer import (
        SpeechTokenizerConfig,
    )

    ref = configs.flagship_feedback_code2wav()
    directory, fabrication = snapshot
    with directory as snap:
        log(fabrication.result())

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            model = load_model(snap, device="cuda")
        torch.cuda.synchronize()
        phase_import_tokenizer(model, caught)
        rep = model.import_report
        cfg = model.cfg
        log({"phase": "import", "step": "first_load", **model.load_times,
             "assigned": rep.assigned, "synthetic": list(rep.synthetic),
             "unmapped": len(rep.unmapped), "protocol": cfg.talker.feedback,
             "codec": cfg.codec_arch, "template": rep.prompt_template["source"]})
        widths = {
            "talker": ("vocab_size", "hidden", "n_layers", "n_heads",
                       "n_kv_heads", "head_dim", "ffn", "codec_vocab"),
            "code_predictor": ("hidden", "n_layers", "n_heads", "head_dim",
                               "ffn", "input_layout", "input_proj", "qk_norm"),
        }
        wrong = [f"{sec}.{f}" for sec, fields in widths.items() for f in fields
                 if getattr(getattr(cfg, sec), f) != getattr(getattr(ref, sec), f)]
        if cfg.code2wav != ref.code2wav:
            wrong.append("code2wav")
        st = rep.speech_tokenizer or {}
        if model.st_cfg != SpeechTokenizerConfig():
            wrong.append("speech_tokenizer")
        if rep.unmapped or rep.synthetic or wrong \
                or cfg.talker.feedback != "residual_sum" \
                or cfg.codec_arch != "code2wav" \
                or st.get("family") != "mimi" or st.get("preserved") \
                or not st.get("mapped"):
            fail(f"import: unmapped {rep.unmapped[:5]}, synthetic "
                 f"{rep.synthetic}, protocol {cfg.talker.feedback}, codec "
                 f"{cfg.codec_arch}, fields unlike the preset {wrong}, "
                 f"speech tokenizer {st}")
        if "cache_write_s" not in model.load_times:
            fail("import: the first load wrote no native cache")

        again = load_model(snap, device="cuda")
        torch.cuda.synchronize()
        if "native_load_s" not in again.load_times:
            fail(f"import: the second load did not come from the cache "
                 f"({again.load_times})")
        same = all(_same_tree(torch, getattr(model, c), getattr(again, c))
                   for c in ("params", "cp_params", "codec_params",
                             "st_params"))
        log({"phase": "import", "step": "native_load", **again.load_times,
             "leaves_bit_equal": same,
             "config_equal": dataclasses.asdict(again.cfg)
             == dataclasses.asdict(cfg)})
        if not same or again.cfg != cfg or again.st_cfg != model.st_cfg:
            fail("import: the native cache's model differs from the import's")
        del again
        torch.cuda.empty_cache()
        counts, shapes, run = phase_main_path(
            torch, "import:flagship_feedback_code2wav", "grouped",
            "grouped_qmv", IMPORT_FRAMES, model=model)
        del model
        for name, ran in phase_clone(torch, snap, feedback_rtf).items():
            shapes.setdefault(name, set()).update(ran)
        phase_train_recovery(torch, snap)
        return counts, shapes, run["rtf"]


GOLDEN_IDS = ROOT / "tests" / "qwen_bpe_golden.json"


def phase_import_tokenizer(model, caught) -> None:
    """The imported snapshot's text tokenizer: the port's BPE encoder,
    loaded without a warning, >= 512 ids, a ChatML render that passes
    validate_special_tokens and is not encoded as its bytes, and the
    golden ids (transformers' on the same fabricated files) on every
    golden text."""
    from qwen3_tts_tpu_torch.engine.fabricate import QWEN_CHATML
    from qwen3_tts_tpu_torch.runtime.prompts import (
        PromptTemplate, build_prompt, validate_special_tokens,
    )

    tok = model.tokenizer
    warned = [str(w.message) for w in caught
              if "tokenizer" in str(w.message).lower()]
    if type(tok).__name__ != "QwenBPETokenizer" or warned:
        fail(f"import tokenizer: {type(tok).__name__}, warnings {warned}")
    chat = PromptTemplate(chat_template=QWEN_CHATML, source="chat_template")
    t0 = time.perf_counter()
    prompt = build_prompt(tok, "custom", TEXT, voice="ryan",
                          speakers=model.cfg.speakers, instruct="Speak warmly.",
                          template=chat)
    validate_special_tokens(prompt.rendered, tok)
    with open(GOLDEN_IDS, encoding="utf-8") as fh:
        golden = json.load(fh)
    wrong = [case for case, g in golden["cases"].items()
             if tok.encode(g["text"]) != g["ids"]]
    encode_s = time.perf_counter() - t0
    ids = prompt.text_tokens.tolist()
    as_bytes = ids == list(prompt.rendered.encode("utf-8"))
    log({"phase": "import", "step": "tokenizer", "class": type(tok).__name__,
         "vocab_size": tok.vocab_size, "golden_cases": len(golden["cases"]),
         "golden_wrong": wrong, "prompt_ids": len(ids),
         "prompt_utf8_bytes": len(prompt.rendered.encode("utf-8")),
         "ids_are_bytes": as_bytes, "encode_s": encode_s})
    if tok.vocab_size < 512 or tok.vocab_size != golden["vocab_size"] \
            or wrong or as_bytes or max(ids) >= model.cfg.talker.vocab_size:
        fail(f"import tokenizer: vocab {tok.vocab_size} (golden "
             f"{golden['vocab_size']}), golden cases wrong {wrong}, ids are "
             f"the prompt's bytes: {as_bytes}")


CLONE_REF_S = 5.0
CLONE_REF_TEXT = "A warm cup of tea waits for you in the kitchen."


def phase_clone(torch, snap: str, feedback_rtf: float) -> dict:
    """Cloning at full width: the import phase's snapshot (its Mimi speech
    tokenizer at the published widths) loaded with load_model(dir,
    mode="base"), a 5 s reference encoded (time, code frames, bucket), then
    one generate_audio(ref_audio=..., ref_text=...) of MAIN_FRAMES frames
    after one warm call (RTF, TTFA, peak memory, kernel A launches a
    frame; the WAV checked). Returns the shapes each kernel ran."""
    import numpy as np

    from qwen3_tts_tpu_torch.audio import write_wav
    from qwen3_tts_tpu_torch.engine import generate_audio, load_model
    from qwen3_tts_tpu_torch.engine.api import _ref_bucket
    from qwen3_tts_tpu_torch.models.speech_tokenizer import st_frames
    from qwen3_tts_tpu_torch.ops import cuda_kernels

    os.environ["QWEN3_TTS_INT8_LAYOUT"] = "grouped"
    t0 = time.perf_counter()
    model = load_model(snap, device="cuda", mode="base", cache=False)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg = model.cfg
    rep = model.import_report.speech_tokenizer
    if cfg.mode != "base" or model.st_params is None or rep["preserved"]:
        fail(f"clone: mode {cfg.mode}, speech tokenizer {rep}")
    sr, hop = cfg.codec.sample_rate, cfg.codec.hop
    clip = reference_clip(CLONE_REF_S, sr)
    encode_s = []
    for _ in range(2):  # the first call includes the allocator's first use
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codes, spk = model.encode_reference(clip)
        torch.cuda.synchronize()
        encode_s.append(time.perf_counter() - t0)
    T = st_frames(model.st_cfg, len(clip))
    if codes.shape != (cfg.codec.num_codebooks, T) or spk is not None \
            or codes.min() < 0 or codes.max() >= cfg.codec.codebook_size:
        fail(f"clone: reference codes {codes.shape} in "
             f"[{codes.min()}, {codes.max()}], speaker vector {spk is not None}")
    log({"phase": "clone", "step": "encode", "reference_s": CLONE_REF_S,
         "encode_s": encode_s, "code_frames": T, "bucket": _ref_bucket(T),
         "st_hop": model.st_cfg.hop, "load_s": load_s})
    with tempfile.TemporaryDirectory() as out:
        ref = os.path.join(out, "ref.wav")
        write_wav(ref, clip, sr)
        kw = dict(model=model, text=TEXT, ref_audio=ref,
                  ref_text=CLONE_REF_TEXT, output_path=out)
        warm = generate_audio(max_frames=16, seed=1, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_kernels.reset_launch_counts()
        m = generate_audio(max_frames=MAIN_FRAMES, seed=0, **kw)
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in cuda_kernels.KERNELS}
        shapes = {k.name: set(k.shapes) for k in cuda_kernels.KERNELS}
        with wave.open(os.path.join(out, "audio_000.wav"), "rb") as w:
            fmt = (w.getnchannels(), w.getsampwidth(), w.getframerate())
            n = w.getnframes()
            pcm = np.frombuffer(w.readframes(n), dtype="<i2")
    skip = cfg.code2wav.startup_samples
    if fmt != (1, 2, 24000) or m["frames"] < 1 \
            or n != m["frames"] * hop - skip \
            or not np.isfinite(pcm.astype(np.float64)).all() or not pcm.any():
        fail(f"clone: wav {fmt}, {n} samples for {m['frames']} frames "
             f"(hop {hop}, startup {skip}), or silent")
    if counts["grouped_qmv"] == 0:
        fail("clone: kernel A never launched")
    log({"phase": "clone", "step": "generate", "frames": m["frames"],
         "audio_s": m["audio_s"], "wall_s": m["wall_s"], "rtf": m["rtf"],
         "ttfa_s": m["ttfa_s"], "warmup_wall_s": warm["wall_s"],
         "rtf_flagship_feedback_code2wav": feedback_rtf,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
         "launches": counts,
         "grouped_qmv_launches_per_frame": counts["grouped_qmv"] / m["frames"],
         "shapes": {name: sorted(run) for name, run in shapes.items()}})
    del model
    torch.cuda.empty_cache()
    os.environ.pop("QWEN3_TTS_INT8_LAYOUT")
    return shapes


# phase app: the terminal app's sessions (sessions/*, io, voices, ui) and
# the native audio library (native/) on the card's host

APP_MODEL = "synthetic:flagship-code2wav"  # + :custom, :design or :base
APP_TEXT = "Hello from the app."   # 19 chars: a 48-frame budget at 12 Hz
APP_VOICE = "App Voice!"           # enrolled as App_Voice
APP_REF_RATE = 44_100              # the enrolled reference: stereo 44.1 kHz
APP_ERRORS = ("Generation failed", "Failed to load", "No audio was generated",
              "Could not convert")
NATIVE_CONVERT_S = 10.0            # the timed conversion's length


class _Recorder:
    """A console stand-in (the GPU machine has no rich): every printed
    line, and status() as a no-op."""

    def __init__(self):
        self.lines = []

    def print(self, *objects, **kwargs):
        self.lines.append(" ".join(str(o) for o in objects))

    def status(self, *args, **kwargs):
        import contextlib

        return contextlib.nullcontext()


class _Script:
    """Scripted answers for every line prompt and menu of a session; an
    exhausted script is Ctrl-D."""

    def __init__(self, lines):
        self.lines = list(lines)

    def __call__(self, *args, **kwargs):
        if not self.lines:
            raise EOFError
        return self.lines.pop(0)


def _stereo_reference(path: str, seconds: float, seed: int = 5) -> None:
    """reference_clip at APP_REF_RATE in two channels (the right one
    quieter), 16-bit."""
    import numpy as np

    from qwen3_tts_tpu_torch.audio import write_wav

    left = reference_clip(seconds, APP_REF_RATE, seed)
    write_wav(path, np.stack([left, 0.6 * left], axis=1), APP_REF_RATE)


def phase_app_native() -> dict:
    """Step ``native``: build the native library with the host compiler
    (failing if there is none or the compile fails), hold f32 <-> i16,
    downmix and peak bit-equal to the numpy versions, the resampler to its
    properties (identity, length, a 1 kHz tone's energy > 0.99, 20 kHz
    down > 34 dB at 48 -> 24 kHz), and time a NATIVE_CONVERT_S 44.1 kHz
    stereo -> 24 kHz mono conversion, native vs numpy + scipy (host
    times)."""
    import numpy as np

    from qwen3_tts_tpu_torch import native
    from qwen3_tts_tpu_torch.audio import resample, to_mono
    from qwen3_tts_tpu_torch.native import build

    os.environ.pop("QWEN3_TTS_NATIVE", None)
    t0 = time.perf_counter()
    lib = build.ensure_built()
    build_s = time.perf_counter() - t0
    if lib is None or not native.native_available():
        fail("app native: no C++ compiler on the host, the library is not "
             "built")
    rng = np.random.default_rng(11)
    x = (0.7 * rng.standard_normal(48_000)).astype(np.float32)
    x[:6] = (2.0, -2.0, 1.0, -1.0, 0.5 / 32767, -1.5 / 32767)
    stereo = (0.4 * rng.standard_normal((48_000, 2))).astype(np.float32)
    pcm = rng.integers(-32768, 32768, 48_000, dtype=np.int16)
    cases = {"f32_to_i16": (x,), "i16_to_f32": (pcm,),
             "downmix_mono": (stereo,), "peak": (x,)}
    got = {k: getattr(native, k)(*a) for k, a in cases.items()}
    os.environ["QWEN3_TTS_NATIVE"] = "never"
    try:
        want = {k: getattr(native, k)(*a) for k, a in cases.items()}
    finally:
        os.environ.pop("QWEN3_TTS_NATIVE")
    for k in cases:
        if not np.array_equal(np.asarray(got[k]), np.asarray(want[k])):
            fail(f"app native: {k} differs from its numpy version")

    def sine(freq, rate, seconds=0.5):
        return np.sin(2 * np.pi * freq * np.arange(int(rate * seconds))
                      / rate).astype(np.float32)

    tone_share = {}
    if not np.array_equal(native.resample_native(x, 24_000, 24_000), x):
        fail("app native: resampling 24 -> 24 kHz is not the identity")
    for src in (48_000, 16_000, 44_100):
        s = sine(1000.0, src)
        y = native.resample_native(s, src, 24_000)
        if abs(len(y) - math.ceil(len(s) * 24_000 / src)) > 1:
            fail(f"app native: {src} -> 24 kHz gave {len(y)} samples")
        t = np.arange(len(y)) / 24_000
        body = slice(len(y) // 8, -len(y) // 8)
        c, q = (f(2 * np.pi * 1000.0 * t)[body] for f in (np.sin, np.cos))
        yb = y[body].astype(np.float64)
        share = (np.dot(yb, c) ** 2 / np.dot(c, c)
                 + np.dot(yb, q) ** 2 / np.dot(q, q)) / np.sum(yb * yb)
        tone_share[src] = share
        if share <= 0.99:
            fail(f"app native: a 1 kHz tone at {src} Hz keeps {share} of "
                 "its energy")
    hi = sine(20_000.0, 48_000)
    y = native.resample_native(hi, 48_000, 24_000)
    body = y[len(y) // 8: -len(y) // 8].astype(np.float64)
    atten_db = 20 * math.log10(np.sqrt(np.mean(hi.astype(np.float64) ** 2))
                               / max(np.sqrt(np.mean(body ** 2)), 1e-30))
    if atten_db <= 34:
        fail(f"app native: 20 kHz attenuated {atten_db:.1f} dB")

    long = (0.3 * rng.standard_normal(
        (int(NATIVE_CONVERT_S * APP_REF_RATE), 2))).astype(np.float32)

    def convert():
        return resample(to_mono(long), APP_REF_RATE, 24_000)

    times = {}
    # one untimed call each (scipy's import, first-touch of the buffers),
    # then in turns
    for setting in ("auto", "never", "auto", "never", "never", "auto"):
        os.environ["QWEN3_TTS_NATIVE"] = setting
        try:
            t0 = time.perf_counter()
            out = convert()
            times.setdefault(setting, []).append(
                (time.perf_counter() - t0) * 1e3)
        finally:
            os.environ.pop("QWEN3_TTS_NATIVE")
        if len(out) != int(NATIVE_CONVERT_S * 24_000):
            fail(f"app native: {setting} conversion gave {len(out)} samples")
    row = {"phase": "app", "step": "native",
           "library": str(lib.relative_to(ROOT)),
           "compiler": build.compiler(), "build_s": build_s,
           "bit_equal_to_numpy": sorted(cases),
           "tone_energy_share": tone_share,
           "attenuation_20khz_db": atten_db,
           "convert_s": NATIVE_CONVERT_S,
           "convert_native_ms": times["auto"][1:],
           "convert_scipy_ms": times["never"][1:],
           "clock": "host perf_counter"}
    log(row)
    return row


def _app_session(torch, tmp: str, step: str, lines: list) -> tuple[dict, dict]:
    """One real session of the port's app (run_custom_session,
    run_design_session or run_clone_manager) on scripted ``lines``, its
    model synthetic:flagship-code2wav:<mode> drawn on the card, with the
    sleep and screen clear stubbed, AUTO_PLAY off, the output, voice and
    model directories under ``tmp`` and a recording console in every
    module. Fails unless exactly one valid WAV is saved, the console holds
    no error line and kernel A launched. Returns launches and shapes."""
    import contextlib
    import types

    import numpy as np

    from qwen3_tts_tpu_torch import (
        config, engine, io, transcription, ui, voices,
    )
    from qwen3_tts_tpu_torch.ops import cuda_kernels
    from qwen3_tts_tpu_torch.sessions import clone, custom, design

    mode, session, run = {
        "custom": ("custom", custom, custom.run_custom_session),
        "design": ("design", design, design.run_design_session),
        "clone": ("base", clone, clone.run_clone_manager),
    }[step]
    out = os.path.join(tmp, "outputs", step)
    rec, script = _Recorder(), _Script(lines)
    timings, metrics = {}, []
    load_model_with_progress = session.load_model_with_progress
    generate_audio = engine.generate_audio

    def timed_load(path, name):
        t0 = time.perf_counter()
        model = load_model_with_progress(path, name)
        torch.cuda.synchronize()
        timings["load_s"] = time.perf_counter() - t0
        return model

    def timed_generate(**kw):
        t0 = time.perf_counter()
        m = generate_audio(**kw)
        torch.cuda.synchronize()
        timings["generate_wall_s"] = time.perf_counter() - t0
        metrics.append(m)
        return m

    patches = [
        (io, "BASE_OUTPUT_DIR", out), (config, "BASE_OUTPUT_DIR", out),
        (io, "MODELS_DIR", os.path.join(tmp, "models")),
        (config, "MODELS_DIR", os.path.join(tmp, "models")),
        (voices, "VOICES_DIR", os.path.join(tmp, "voices")),
        (io, "AUTO_PLAY", False),
        (io, "time", types.SimpleNamespace(sleep=lambda s: None)),
        (transcription, "_providers", {}),
        (session, "ensure_model",
         lambda spec: f"{APP_MODEL}:{mode}"),
        (session, "load_model_with_progress", timed_load),
        (engine, "generate_audio", timed_generate),
    ]
    if step == "clone":
        patches.append((session, "instant_menu_choice", script))
    for mod in (io, session):
        patches.append((mod, "clear_screen", lambda: None))
    for mod in (ui, io, voices, session):
        patches.append((mod, "console", rec))
    for mod in (ui, voices, session):
        patches.append((mod, "safe_line_input", script))
    os.environ["QWEN3_TTS_INT8_LAYOUT"] = "grouped"
    with contextlib.ExitStack() as undo:
        for mod, name, value in patches:
            undo.callback(setattr, mod, name, getattr(mod, name))
            setattr(mod, name, value)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k.name: k.launches for k in cuda_kernels.KERNELS}
        shapes = {k.name: set(k.shapes) for k in cuda_kernels.KERNELS}
        peak = torch.cuda.max_memory_allocated() / 1e9
    os.environ.pop("QWEN3_TTS_INT8_LAYOUT")
    errors = [ln for ln in rec.lines if any(e in ln for e in APP_ERRORS)]
    if errors:
        fail(f"app {step}: the console reports {errors}")
    saved = [os.path.join(d, f) for d, _, fs in os.walk(out) for f in fs]
    if len(saved) != 1 or not saved[0].endswith(".wav") or len(metrics) != 1:
        fail(f"app {step}: saved {saved} after {len(metrics)} generations")
    with wave.open(saved[0], "rb") as w:
        fmt = (w.getnchannels(), w.getsampwidth(), w.getframerate())
        n = w.getnframes()
        pcm = np.frombuffer(w.readframes(n), dtype="<i2")
    if fmt != (1, 2, 24000) or n < 1 or not pcm.any() \
            or not np.isfinite(pcm.astype(np.float64)).all():
        fail(f"app {step}: wav {fmt}, {n} samples, or silent")
    frames = metrics[0]["frames"]
    if counts["grouped_qmv"] == 0 or frames < 1:
        fail(f"app {step}: kernel A launched {counts['grouped_qmv']} times "
             f"over {frames} frames")
    audio_s = n / 24000
    log({"phase": "app", "step": step,
         "model": f"{APP_MODEL}:{mode}", "layout": "grouped",
         "saved": os.path.relpath(saved[0], out), "samples": n,
         "frames": frames, "audio_s": audio_s, "load_s": timings["load_s"],
         "session_wall_s": wall,
         "generate_wall_s": timings["generate_wall_s"],
         "rtf": audio_s / timings["generate_wall_s"],
         "peak_mem_gb": peak, "launches": counts,
         "grouped_qmv_launches_per_frame": counts["grouped_qmv"] / frames,
         "console_lines": len(rec.lines)})
    return counts, shapes


def phase_app(torch) -> tuple[dict, dict]:
    """Phase ``app``: step ``native``, then the three sessions of the
    port's terminal app at the flagship's full width: ``custom`` (speaker
    1, emotion Sad, speed x1.3, the host stretch), ``design`` (a voice
    description) and ``clone`` (enroll a voice from a 44.1 kHz stereo WAV:
    converted by the native downmix and resampler, then clone from the
    saved voice). Returns kernel launches and shapes summed over them."""
    from qwen3_tts_tpu_torch.audio import wav_info

    phase_app_native()
    counts: dict = {}
    shapes: dict = {}
    with tempfile.TemporaryDirectory(prefix="q3tts_app_") as tmp:
        ref = os.path.join(tmp, "reference 44k stereo.wav")
        _stereo_reference(ref, CLONE_REF_S)
        scripts = {
            "custom": ["1", "2", "2", APP_TEXT, ""],
            "design": ["A warm, deep narrator, slow and calm", APP_TEXT, ""],
            "clone": ["2", APP_VOICE, f"'{ref}'", CLONE_REF_TEXT, "1", "1",
                      APP_TEXT, "", "b"],
        }
        for step, lines in scripts.items():
            c, s = _app_session(torch, tmp, step, lines)
            for name in c:
                counts[name] = counts.get(name, 0) + c[name]
                shapes.setdefault(name, set()).update(s[name])
        enrolled = os.path.join(tmp, "voices", "App_Voice.wav")
        info = wav_info(enrolled)
        if (info.sample_rate, info.channels, info.sampwidth) != (24000, 1, 2) \
                or abs(info.duration_s - CLONE_REF_S) > 0.01:
            fail(f"app clone: the enrolled voice is {info}")
    torch.cuda.empty_cache()
    return counts, shapes


def phase_main_paths(torch, snapshot) -> tuple[dict, dict, dict]:
    """Every main path and the imported checkpoint's; returns each
    kernel's launches on the flagship's main path under its layout (the
    first path that runs it; kernel C's on the first path), the shapes each kernel ran on any path, and
    each path's numbers (phase_main_path)."""
    launches: dict = {}
    shapes: dict = {}
    runs: dict = {}
    for label, layout, kernel, frames in MAIN_PATHS:
        counts, ran, runs[label] = phase_main_path(torch, label, layout,
                                                   kernel, frames)
        launches.setdefault(kernel, counts[kernel])
        launches.setdefault(ATTN, counts[ATTN])
        for name, run in ran.items():
            shapes.setdefault(name, set()).update(run)
    # the imported checkpoint's path: its shapes join the coverage check
    _, ran, _ = phase_import(torch, runs["flagship_feedback_code2wav"]["rtf"],
                             snapshot)
    for name, run in ran.items():
        shapes.setdefault(name, set()).update(run)
    return launches, shapes, runs


# phase mtp: the tiny reference configs, from the port's configs module
MTP_BUDGETS = (13, 9, 11)  # frames of the reference prompts / streams


def _mtp_reference_configs(configs) -> dict:
    import dataclasses

    def f32_int8(cfg):
        return dataclasses.replace(configs.with_quant(cfg, True),
                                   dtype="float32")

    spec = configs.tiny_feedback()
    spec = dataclasses.replace(
        spec, codec=dataclasses.replace(spec.codec, num_codebooks=16),
        code_predictor=dataclasses.replace(spec.code_predictor, depth_group=5,
                                           spec_decode=True))
    return {
        "cb0_rvq_fps2": f32_int8(configs.with_frames_per_step(configs.tiny(), 2)),
        "cb0_rvq_fps3": f32_int8(configs.with_frames_per_step(configs.tiny(), 3)),
        "residual_sum_fps2": f32_int8(configs.tiny_feedback(frames_per_step=2)),
        "residual_sum_fps2_cpb": f32_int8(configs.tiny_feedback(
            frames_per_step=2, mtp_cp_batch=True)),
        "residual_sum_dg5_spec": f32_int8(spec),
    }


def tame_rvq_codec(model) -> None:
    """Scale the tiny rvq decoder's conv weights by 0.6, in place (as the
    port's CPU tests do, tests/torch_port_helpers.py): its initialiser's
    gain drives activations to ~1e2 before the final tanh, where float32
    summation order alone moves the clipped waveform by 3 LSB; at 0.6 the
    waveform is unclipped and the 2 LSB bound tests the arithmetic."""
    if model.cfg.codec_arch != "rvq":
        return
    dec = model.codec_params["dec"]
    convs = [dec["in_proj"], dec["out_conv"]] + [
        c for st in dec["stages"] for c in (st["up"], st["res"]["c1"],
                                            st["res"]["c2"])]
    for conv in convs:
        conv["w"].mul_(0.6)


def phase_mtp_reference(torch) -> None:
    """Tiny float32 models with int8 weights, grouped layout, on the card
    and on the CPU: each MTP / spec config's greedy single-stream codes
    must be equal for three prompts and PCM within 2 LSB; then a
    ServingEngine of three streams at fps 2 (cb0 and residual_sum),
    likewise. The rvq decoder is tamed (tame_rvq_codec) on both sides."""
    import numpy as np

    from qwen3_tts_tpu_torch.engine import configs, prepare_segments
    from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
    from qwen3_tts_tpu_torch.ops import cuda_kernels
    from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig
    from qwen3_tts_tpu_torch.runtime.serving import ServingEngine

    os.environ["QWEN3_TTS_INT8_LAYOUT"] = "grouped"
    greedy = SamplingConfig(greedy=True)
    cases = [(label, cfg, False) for label, cfg in
             _mtp_reference_configs(configs).items()]
    cases += [(label + "_serving3", cfg, True) for label, cfg, _ in cases
              if label in ("cb0_rvq_fps2", "residual_sum_fps2")]
    for label, cfg, serve in cases:
        host = Qwen3TTSModel.synthetic(cfg, seed=0, device="cpu")
        prompts = [prepare_segments(host, text, voice=voice)[0][0]
                   for text, voice in zip(SERVING_TEXTS[:3], cfg.speakers)]
        out = {}
        before = cuda_kernels.GROUPED_QMV.launches
        for dev in ("cpu", "cuda"):
            model = Qwen3TTSModel.synthetic(cfg, seed=0, device="cpu")
            tame_rvq_codec(model)
            model = model.to(dev)
            model.sampling = greedy
            if serve:
                engine = ServingEngine(model, max_streams=4, sampling=greedy)
                out[dev] = [(np.concatenate(st.codes, 1), wav) for wav, st in
                            engine.run(prompts, max_frames=list(MTP_BUDGETS))]
            else:
                out[dev] = []
                for p, b in zip(prompts, MTP_BUDGETS):
                    r = model.generator.synthesize(p, max_frames=b,
                                                   collect_codes=True)
                    out[dev].append((r.codes, r.wav))
        if cuda_kernels.GROUPED_QMV.launches == before:
            fail(f"mtp reference {label}: kernel A never launched")
        codes_equal = all(a.shape == b.shape and np.array_equal(a, b)
                          for (a, _), (b, _) in zip(out["cuda"], out["cpu"]))
        pcm_err = max(
            (int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())
             if a.shape == b.shape and a.size else 1 << 16)
            for (_, a), (_, b) in zip(out["cuda"], out["cpu"]))
        log({"phase": "mtp", "step": "reference", "model": label,
             "dtype": "float32", "layout": "grouped",
             "frames_per_step": cfg.talker.frames_per_step,
             "mtp_cp_batch": cfg.talker.mtp_cp_batch,
             "depth_group": cfg.code_predictor.depth_group,
             "spec_decode": cfg.code_predictor.spec_decode,
             "serving_streams": 3 if serve else None,
             "frames": [int(c.shape[1]) for c, _ in out["cpu"]],
             "greedy_codes_equal": codes_equal, "pcm_max_lsb": pcm_err,
             "frames_equal_before_first_difference":
                 [_lead(a, b) for (a, _), (b, _) in zip(out["cuda"],
                                                        out["cpu"])]})
        if not codes_equal or pcm_err > 2:
            fail(f"mtp reference {label}, float32: the card's greedy codes "
                 f"differ from the CPU's ({codes_equal}) or PCM by "
                 f"{pcm_err} > 2 LSB")
    os.environ.pop("QWEN3_TTS_INT8_LAYOUT")


def phase_mtp(torch, fps1: dict) -> tuple[dict, dict]:
    """phase_mtp_reference, then flagship_feedback_code2wav at two frames
    a step, drawn on the card (int8 MTP heads), as a main path of
    MAIN_FRAMES frames with mtp_cp_batch off and then on (a view of the
    same weights); prints each run's RTF, TTFA, peak memory and kernel A
    launches a frame beside ``fps1``, the fps=1 main path's. Returns each
    kernel's launches over both measured runs and the shapes they ran."""
    from qwen3_tts_tpu_torch import quality
    from qwen3_tts_tpu_torch.engine import configs
    from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel

    phase_mtp_reference(torch)
    label = "flagship_feedback_code2wav"
    t0 = time.perf_counter()
    model = Qwen3TTSModel.synthetic(
        configs.flagship_feedback_code2wav(frames_per_step=2), seed=0,
        device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    merge = model.params["mtp"]["merge"]
    if set(merge) != {"q", "scale", "bias"}:
        fail(f"mtp: the synthetic MTP heads are not int8 ({sorted(merge)})")
    counts: dict = {}
    shapes: dict = {}
    runs = {}
    for cpb in (False, True):
        view = quality.variant_model(model, {"cpb": cpb})
        ran_counts, ran, runs[cpb] = phase_main_path(
            torch, f"{label}@fps=2+cpb={int(cpb)}", "grouped", "grouped_qmv",
            MAIN_FRAMES, model=view)
        del view
        for name, run in ran.items():
            shapes.setdefault(name, set()).update(run)
            counts[name] = counts.get(name, 0) + ran_counts[name]
    keys = ("rtf", "ttfa_s", "peak_mem_gb", "grouped_qmv_launches_per_frame")
    log({"phase": "mtp", "step": "flagship", "model": label,
         "layout": "grouped", "frames": MAIN_FRAMES, "draw_s": draw_s,
         "fps2": {k: runs[False][k] for k in keys},
         "fps2_cpb": {k: runs[True][k] for k in keys},
         "fps1": {k: fps1[k] for k in keys}})
    del model
    torch.cuda.empty_cache()
    return counts, shapes


SERVING_TEXTS = (
    "The quick brown fox jumps over the lazy dog.",
    "Please leave the parcel at the side door before noon.",
    "Rain is expected over the hills by the evening.",
    "Our next train to the coast departs from platform four.",
    "She counted the stars until the sky turned grey.",
    "Turn left at the bakery and walk two more blocks.",
    "The meeting moved to Thursday at half past nine.",
    "A warm cup of tea waits for you in the kitchen.",
)
# phase serving's flagship and kv_int8 streams: 36 frames, the (4, 32) ramp's
# two dispatches (cut from 64 for the 400 s budget when phase parallel came;
# both steps at one depth, so their peaks still compare)
SERVING_FRAMES = 36
SERVER_FRAMES = 64   # phase server's clients


def _serving_codes(engine, prompts, budgets) -> list:
    """Serve ``prompts`` with one joining mid-flight (after two steps);
    returns each stream's codes [Q, frames]."""
    ids = [engine.submit(p, max_frames=b)
           for p, b in zip(prompts[:-1], budgets[:-1])]
    engine.step()
    engine.step()
    ids.append(engine.submit(prompts[-1], max_frames=budgets[-1]))
    for _ in range(500):
        if all(engine.streams[i].done for i in ids):
            break
        engine.step()
    else:
        fail("serving: the tiny streams did not finish in 500 steps")
    return [engine.collect(i)[1].codes for i in ids]


def phase_serving_reference(torch) -> None:
    """Tiny models with int8 weights, grouped layout, four streams with
    different budgets, the fourth joining mid-flight. In float32 (cb0 +
    rvq, residual_sum + code2wav) each stream's greedy codes on the card
    must equal the single-stream Generator's on the card and the same
    engine's on the CPU; in bf16 the agreement is printed only."""
    import dataclasses

    import numpy as np

    from qwen3_tts_tpu_torch.engine import configs, prepare_segments
    from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
    from qwen3_tts_tpu_torch.ops import cuda_kernels
    from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig
    from qwen3_tts_tpu_torch.runtime.serving import ServingEngine

    os.environ["QWEN3_TTS_INT8_LAYOUT"] = "grouped"
    greedy = SamplingConfig(greedy=True)
    budgets = (6, 16, 11, 12)
    feedback = configs.with_quant(configs.with_code2wav(
        configs.tiny_feedback(), configs.tiny_code2wav().code2wav), True)
    for label, base, dtype in (("cb0_rvq", configs.tiny(quant=True), "float32"),
                               ("residual_sum_code2wav", feedback, "float32"),
                               ("cb0_rvq", configs.tiny(quant=True),
                                "bfloat16")):
        cfg = dataclasses.replace(base, dtype=dtype)
        host = Qwen3TTSModel.synthetic(cfg, seed=0, device="cpu")
        prompts = [prepare_segments(host, text, voice=voice)[0][0]
                   for text, voice in zip(SERVING_TEXTS[:4], cfg.speakers)]
        codes = {}
        for dev in ("cpu", "cuda"):
            model = Qwen3TTSModel.synthetic(cfg, seed=0, device="cpu").to(dev)
            model.sampling = greedy
            before = cuda_kernels.GROUPED_QMV.launches
            codes[dev] = _serving_codes(
                ServingEngine(model, max_streams=4, sampling=greedy), prompts,
                budgets)
            if dev == "cuda":
                if cuda_kernels.GROUPED_QMV.launches == before:
                    fail(f"serving {label} {dtype}: kernel A never launched")
                single = [model.generator.synthesize(
                    p, max_frames=b, collect_codes=True).codes
                    for p, b in zip(prompts, budgets)]
        lead = []
        for got, want in zip(codes["cuda"], codes["cpu"]):
            got, want = np.concatenate(got, 1), np.concatenate(want, 1)
            n = min(got.shape[1], want.shape[1])
            diff = (got[:, :n] != want[:, :n]).any(axis=0)
            lead.append(int(diff.argmax()) if diff.any() else n)
        same_cpu = all(np.array_equal(np.concatenate(a, 1), np.concatenate(b, 1))
                       for a, b in zip(codes["cuda"], codes["cpu"]))
        same_single = all(np.array_equal(np.concatenate(a, 1), b)
                          for a, b in zip(codes["cuda"], single))
        log({"phase": "serving", "step": "reference", "model": label,
             "dtype": dtype, "streams": 4, "budgets": list(budgets),
             "frames": [int(sum(c.shape[1] for c in cs))
                        for cs in codes["cpu"]],
             "card_equals_cpu": same_cpu,
             "card_equals_single_stream": same_single,
             "frames_equal_before_first_difference": lead})
        if dtype == "float32" and not (same_cpu and same_single):
            fail(f"serving {label} float32: the card's greedy codes differ "
                 f"from the CPU's ({same_cpu}) or from single-stream "
                 f"synthesis on the card ({same_single})")
    os.environ.pop("QWEN3_TTS_INT8_LAYOUT")


def phase_serving(torch, single_rtf: float) -> tuple[dict, dict]:
    """The serving engine at full width: phase_serving_reference, then
    configs.flagship_feedback_code2wav() (grouped layout) serving eight
    streams of SERVING_FRAMES frames after one warm run, every WAV checked;
    then a generate_audio call of at least three segments. Returns each
    kernel's launches over both measured runs, the shapes they ran, and
    the dense step's aggregate RTF."""
    import numpy as np

    from qwen3_tts_tpu_torch.engine import generate_audio, prepare_segments
    from qwen3_tts_tpu_torch.models.layers import KVQuant
    from qwen3_tts_tpu_torch.ops import cuda_kernels

    phase_serving_reference(torch)
    os.environ["QWEN3_TTS_INT8_LAYOUT"] = "grouped"
    label = "flagship_feedback_code2wav"
    model = _build(label)
    cfg = model.cfg
    hop, sr = cfg.codec.hop, cfg.codec.sample_rate
    skip = cfg.code2wav.startup_samples
    voices = [cfg.speakers[i % len(cfg.speakers)]
              for i in range(SERVING_STREAMS)]
    prompts = [prepare_segments(model, text, voice=voice)[0][0]
               for text, voice in zip(SERVING_TEXTS, voices)]
    def measured(engine, step):
        """One warm run of the eight prompts, then the measured one, its
        sampling seeded alike in every step; returns the results, the
        step's numbers (every WAV checked), kernel launches and shapes.
        Over dense caches kernel C must run (kernel_c_ran)."""
        engine.run(prompts, max_frames=16)  # warm: allocator, first launches
        dispatch = engine.dispatch_step
        steps = []

        def counted():
            payload = dispatch()
            steps.append(payload is not None)
            return payload

        engine.dispatch_step = counted
        gen = engine.model.generator
        assembled = {"batched_calls": 0, "batched_prompts": 0,
                     "single_calls": 0}

        def batched(plans):
            assembled["batched_calls"] += 1
            assembled["batched_prompts"] += len(plans)
            return type(gen).assemble_plans_batched(gen, plans)

        def single(plan):
            assembled["single_calls"] += 1
            return type(gen).assemble_from_plan(gen, plan)

        gen.assemble_plans_batched, gen.assemble_from_plan = batched, single
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_kernels.reset_launch_counts()
        engine.rng.manual_seed(0)
        t0 = time.perf_counter()
        results = engine.run(prompts, max_frames=SERVING_FRAMES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k.name: k.launches for k in cuda_kernels.KERNELS}
        shapes = {k.name: set(k.shapes) for k in cuda_kernels.KERNELS}
        declined = (cuda_kernels.DECODE_ATTENTION.declined
                    if isinstance(engine.cache_k, KVQuant)
                    else kernel_c_ran(f"serving {step}", counts))
        peak = torch.cuda.max_memory_allocated() / 1e9
        del engine.dispatch_step  # the class's method again
        del gen.assemble_plans_batched, gen.assemble_from_plan
        if assembled["batched_prompts"] != len(prompts):
            fail(f"serving: {assembled} assembled, not the {len(prompts)} "
                 "cold prompts in batched calls")
        row = _serving_step_row(results, wall, peak, counts, sum(steps), cfg)
        return results, {**row, "assembly": assembled,
                         "decode_attention_declined": declined}, counts, shapes

    engine = model.serving_engine(SERVING_STREAMS)
    results, dense, counts, shapes = measured(engine, "flagship")
    log({"phase": "serving", "step": "flagship", "model": label,
         "layout": "grouped", "streams": SERVING_STREAMS,
         "frames_budget": SERVING_FRAMES, **dense,
         "single_stream_rtf_main_path": single_rtf,
         "shapes": {name: sorted(run) for name, run in shapes.items()}})
    dense_codes = [np.concatenate(st.codes, 1) for _, st in results]

    # long-form generate_audio: three segments or more, through the engine
    text = " ".join(SERVING_TEXTS * 4)  # ~1,570 characters
    with tempfile.TemporaryDirectory() as out:
        cuda_kernels.reset_launch_counts()
        m = generate_audio(model=model, text=text, voice="ryan",
                           output_path=out, max_frames=24, seed=0)
        torch.cuda.synchronize()
        for k in cuda_kernels.KERNELS:
            counts[k.name] += k.launches
            shapes[k.name].update(k.shapes)
        with wave.open(os.path.join(out, "audio_000.wav"), "rb") as w:
            n = w.getnframes()
    gap = int(0.15 * sr)
    want = m["frames"] * hop - m["segments"] * skip + (m["segments"] - 1) * gap
    log({"phase": "serving", "step": "longform", "chars": len(text),
         "segments": m["segments"], "frames": m["frames"], "samples": n,
         "expected_samples": want, "wall_s": m["wall_s"], "rtf": m["rtf"],
         "ttfa_s": m["ttfa_s"]})
    if m["segments"] < 3 or n != want or engine is not model.serving_engine():
        fail(f"serving longform: {m['segments']} segments, {n} samples "
             f"(expected {want}), or not through the serving engine")

    # the same eight streams from int8 KV caches (QWEN3_TTS_KV=int8): the
    # dense engine and its caches are freed first, so the peaks compare
    del engine
    model._serving = None
    torch.cuda.empty_cache()
    os.environ["QWEN3_TTS_KV"] = "int8"
    engine = model.serving_engine(SERVING_STREAMS)
    if not isinstance(engine.cache_k, KVQuant):
        fail("serving kv_int8: the engine's cache is not a KVQuant")
    results, row, kv_counts, kv_shapes = measured(engine, "kv_int8")
    for name in counts:
        counts[name] += kv_counts[name]
        shapes[name].update(kv_shapes[name])
    same = total = 0
    for (_, st), want_codes in zip(results, dense_codes):
        got = np.concatenate(st.codes, 1)
        n_common = min(got.shape[1], want_codes.shape[1])
        same += int((got[:, :n_common] == want_codes[:, :n_common])
                    .all(axis=0).sum())
        total += max(got.shape[1], want_codes.shape[1])
    log({"phase": "serving", "step": "kv_int8", "model": label,
         "layout": "grouped", "kv_cache": "int8", "streams": SERVING_STREAMS,
         "frames_budget": SERVING_FRAMES, **row,
         "dense": {key: dense[key] for key in (
             "aggregate_rtf", "ttfa_p50_s", "ttfa_max_s", "peak_mem_gb")},
         "frames_with_codes_equal_to_dense": same / max(total, 1),
         "cache_gb": 2 * sum(t.numel() * t.element_size()
                             for t in (engine.cache_k.q, engine.cache_k.s))
         / 1e9})
    if row["peak_mem_gb"] >= dense["peak_mem_gb"]:
        fail(f"serving kv_int8: peak memory {row['peak_mem_gb']} GB is not "
             f"below the dense step's {dense['peak_mem_gb']} GB")
    del model, engine
    torch.cuda.empty_cache()
    os.environ.pop("QWEN3_TTS_KV")
    os.environ.pop("QWEN3_TTS_INT8_LAYOUT")
    return counts, shapes, dense["aggregate_rtf"]


def _serving_step_row(results, wall: float, peak: float, counts: dict,
                      n_steps: int, cfg) -> dict:
    """Check every stream's WAV of one measured ServingEngine.run and
    return its numbers: frames, aggregate RTF, TTFA p50/max, dispatches,
    kernel launches (a dispatch, a frame), peak memory."""
    import numpy as np

    from qwen3_tts_tpu_torch.audio import write_wav

    hop, sr = cfg.codec.hop, cfg.codec.sample_rate
    skip = cfg.code2wav.startup_samples
    frames = [st.frames for _, st in results]
    with tempfile.TemporaryDirectory() as out:
        for i, (wav, st) in enumerate(results):
            path = os.path.join(out, f"stream_{i}.wav")
            write_wav(path, wav, sr)
            with wave.open(path, "rb") as w:
                fmt = (w.getnchannels(), w.getsampwidth(), w.getframerate())
                n = w.getnframes()
                pcm = np.frombuffer(w.readframes(n), dtype="<i2")
            if fmt != (1, 2, 24000) or st.frames < 1 \
                    or n != st.frames * hop - skip:
                fail(f"serving stream {i}: wav {fmt}, {n} samples for "
                     f"{st.frames} frames (hop {hop}, startup {skip})")
            if not np.isfinite(pcm.astype(np.float64)).all() or not pcm.any():
                fail(f"serving stream {i}: the waveform is silent or not "
                     "finite")
    if counts["grouped_qmv"] == 0:
        fail("serving: kernel A never launched")
    ttfa = sorted(st.ttfa_s for _, st in results)
    audio_s = sum(len(w) for w, _ in results) / sr
    return {"frames": frames, "audio_s": audio_s, "wall_s": wall,
            "aggregate_rtf": audio_s / wall,
            "ttfa_p50_s": statistics.median(ttfa), "ttfa_max_s": ttfa[-1],
            "dispatches": n_steps, "launches": counts,
            "grouped_qmv_launches_per_dispatch": counts["grouped_qmv"] / n_steps,
            "grouped_qmv_launches_per_frame":
                counts["grouped_qmv"] / sum(frames),
            "peak_mem_gb": peak}


# --------------------------------------------------------------------------
# phase asr: Whisper on the card
# --------------------------------------------------------------------------

TINY_WHISPER = (32, (2, 2), 4, 64, 8, 51_000)  # tests/test_whisper.py widths
ASR_CLIP_S = 5.0
ASR_DISK_NEED = 3 * GB  # the F16 snapshot (~1.62 GB) and slack


def phase_asr_reference(torch) -> None:
    """A tiny float32 Whisper from one fabricated directory on the card and
    on the CPU: the greedy tokens and n_valid of a fixed window must be
    equal."""
    import numpy as np

    from qwen3_tts_tpu_torch.engine.fabricate import (
        whisper_config_dict, write_whisper_snapshot)
    from qwen3_tts_tpu_torch.models.whisper import WhisperASR, pad_or_trim

    rng = np.random.default_rng(5)
    window = pad_or_trim((0.2 * rng.standard_normal(3 * 16_000)).astype(
        np.float32))
    with tempfile.TemporaryDirectory(prefix="q3tts_whisper_tiny_") as d:
        write_whisper_snapshot(d, whisper_config_dict(*TINY_WHISPER), seed=0)
        out = {dev: WhisperASR(d, device=dev).decode_window(window, max_new=32)
               for dev in ("cpu", "cuda")}
    (tc, nc), (tg, ng) = out["cpu"], out["cuda"]
    lead = int(np.argmax(tc != tg)) if (tc != tg).any() else len(tc)
    log({"phase": "asr", "step": "reference", "dtype": "float32",
         "n_valid_cpu": nc, "n_valid_card": ng,
         "tokens_equal_before_first_difference": lead,
         "distinct_tokens": len(set(tc.tolist()))})
    if nc != ng or not np.array_equal(tc, tg):
        fail(f"asr reference: the card's greedy tokens or n_valid ({ng}) "
             f"differ from the CPU's ({nc}); equal for {lead} tokens")


def phase_asr(torch):
    """phase_asr_reference, then a Whisper snapshot at
    openai/whisper-large-v3-turbo's published widths (F16 on disk,
    fabricated) loaded with WhisperASR on the card and called directly: a
    5 s clip transcribed cold and warm (load, encode and decode seconds,
    decode steps, tokens, n_valid, peak memory, kernel launches), then the
    same text through transcription.transcribe_wav with
    QWEN3_TTS_ASR_MODEL pointed at the directory. Returns (the loaded
    WhisperASR, the snapshot's TemporaryDirectory), kept for the quality
    step."""
    import shutil

    import numpy as np

    from qwen3_tts_tpu_torch import transcription
    from qwen3_tts_tpu_torch.audio import write_wav
    from qwen3_tts_tpu_torch.engine.fabricate import (
        WHISPER_LARGE_V3_TURBO, write_whisper_snapshot)
    from qwen3_tts_tpu_torch.models import whisper
    from qwen3_tts_tpu_torch.ops import cuda_kernels

    phase_asr_reference(torch)
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    if free < ASR_DISK_NEED:
        fail(f"asr: {free / GB:.1f} GB free in {tmp}, the phase needs "
             f"{ASR_DISK_NEED / GB:.0f} GB")
    holder = tempfile.TemporaryDirectory(prefix="q3tts_whisper_turbo_")
    snap = holder.name
    t0 = time.perf_counter()
    write_whisper_snapshot(snap, WHISPER_LARGE_V3_TURBO, seed=0,
                           dtype=np.float16)
    fab_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(snap, "model.safetensors"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    asr = whisper.WhisperASR(snap, device="cuda")
    def n_leaves(t):
        return (sum(n_leaves(v) for v in t.values()) if isinstance(t, dict)
                else t.numel())

    n_params = n_leaves(asr.params)
    clip = os.path.join(snap, "clip.wav")
    write_wav(clip, reference_clip(ASR_CLIP_S), 24000)
    cuda_kernels.reset_launch_counts()
    runs = []
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        text = asr.transcribe_wav(clip)
        torch.cuda.synchronize()
        runs.append({"run": label, "wall_s": time.perf_counter() - t0,
                     "chars": len(text)})
    # the warm window's pieces, timed apart
    from qwen3_tts_tpu_torch.audio import read_wav, resample, to_mono

    data, rate = read_wav(clip)
    window = whisper.pad_or_trim(resample(to_mono(data), rate, 16_000))
    with torch.no_grad():
        audio = torch.from_numpy(window).to(asr.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = whisper.log_mel_spectrogram(audio, asr.cfg.n_mels, asr.filters)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        whisper.encode(asr.params, asr.cfg, feats)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tokens, n_valid = whisper.greedy_decode(asr.params, asr.cfg, feats,
                                                asr.prefix, max_new=224)
        t3 = time.perf_counter()
    counts = {k.name: k.launches for k in cuda_kernels.KERNELS}
    P = len(asr.prefix)
    steps = P - 1 + min(n_valid + 1, 224)
    encode_s = t2 - t1
    log({"phase": "asr", "step": "turbo", "config": "openai/whisper-large-v3-turbo",
         "d_model": asr.cfg.d_model, "layers": [asr.cfg.encoder_layers,
                                                asr.cfg.decoder_layers],
         "heads": asr.cfg.n_heads, "ffn": asr.cfg.ffn, "n_mels": asr.cfg.n_mels,
         "vocab": asr.cfg.vocab_size, "params": n_params,
         "snapshot_bytes": nbytes, "fabricate_s": fab_s, **asr.load_times,
         "clip_s": ASR_CLIP_S, "runs": runs, "mel_s": t1 - t0,
         "encode_s": encode_s, "decode_s": (t3 - t2) - encode_s,
         "decode_steps": steps,
         "decode_ms_per_step": 1e3 * ((t3 - t2) - encode_s) / steps,
         "prefix": asr.prefix.tolist(), "n_valid": n_valid,
         "tokens": tokens[:min(n_valid, 16)].tolist(), "text_chars": len(text),
         "peak_mem_gb": (torch.cuda.max_memory_allocated() - base_mem) / 1e9,
         "launches": counts})
    if not text or not np.isfinite(feats.float().cpu().numpy()).all():
        fail("asr turbo: an empty transcript or non-finite features")
    os.environ["QWEN3_TTS_ASR_MODEL"] = snap
    transcription._asr_cache.clear()
    t0 = time.perf_counter()
    via = transcription.transcribe_wav(clip)
    provider_s = time.perf_counter() - t0
    transcription._asr_cache.clear()
    os.environ.pop("QWEN3_TTS_ASR_MODEL")
    log({"phase": "asr", "step": "provider", "wall_s": provider_s,
         "equal_to_direct": via == text})
    if via != text:
        fail("asr provider: transcription.transcribe_wav's text differs from "
             "WhisperASR's")
    torch.cuda.empty_cache()
    return asr, holder


def phase_quality(torch, model, asr) -> None:
    """One compare_decode_configs step: the int8 KV cache against the
    dense one on ``model`` (the feedback flagship), one text of
    QUALITY_FRAMES frames, the turbo Whisper transcribing (not gated: the
    weights are random)."""
    from qwen3_tts_tpu_torch import quality

    t0 = time.perf_counter()
    rep = quality.compare_decode_configs(
        model, {"kv8": {"kv": "int8"}}, [SERVING_TEXTS[0]], asr.transcribe_wav,
        voice="ryan", max_frames=QUALITY_FRAMES)
    v = rep["variants"]["kv8"]
    row = v["rows"][0]
    log({"phase": "asr", "step": "quality", "variant": "kv=int8",
         "frames_budget": QUALITY_FRAMES, "wall_s": time.perf_counter() - t0,
         "median_mel_dist": v["median_mel_dist"],
         "median_identical_frac": v["median_identical_frac"],
         "median_wer_delta": v["median_wer_delta"],
         "wer_baseline": row["wer_baseline"], "wer_variant": row["wer_variant"]})
    if not math.isfinite(v["median_mel_dist"]) or v["median_wer_delta"] is None:
        fail("asr quality: no mel distance or no WER delta")


# --------------------------------------------------------------------------
# phase server: the HTTP daemon on the card
# --------------------------------------------------------------------------

SERVER_TEXT = ("First sentence of the request. " * 22
               + "The second segment starts here.")  # two segments


def _http(base: str, path: str, body: dict | None = None,
          read_first: int | None = None) -> dict:
    """One request over http.client: status, headers, the body (or its
    first ``read_first`` bytes, then the connection is dropped), the
    seconds to the first body byte and to the end."""
    import http.client

    host, port = base.removeprefix("http://").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    t0 = time.perf_counter()
    if body is None:
        conn.request("GET", path)
    else:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
    resp = conn.getresponse()
    first = resp.read(1)
    t_first = time.perf_counter() - t0
    if read_first is not None:
        data = first + resp.read(read_first - 1)
        conn.sock.shutdown(2)
        conn.close()
    else:
        data = first + resp.read()
        conn.close()
    return {"status": resp.status, "headers": dict(resp.getheaders()),
            "body": data, "first_byte_s": t_first,
            "end_s": time.perf_counter() - t0}


def _pcm(resp: dict) -> "np.ndarray":
    import io

    import numpy as np

    body = resp["body"]
    if resp["headers"].get("Content-Type") == "audio/pcm":
        return np.frombuffer(body, np.int16)
    if resp["headers"].get("Transfer-Encoding") == "chunked":
        return np.frombuffer(body[44:], np.int16)
    with wave.open(io.BytesIO(body)) as w:
        if (w.getnchannels(), w.getsampwidth(), w.getframerate()) != (1, 2, 24000):
            fail("server: a response is not mono 16-bit 24 kHz")
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def _serve(service):
    """make_server on 127.0.0.1, an ephemeral port, in a thread; returns
    (base url, stop)."""
    import threading

    from qwen3_tts_tpu_torch.server import make_server

    srv = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def stop():
        srv.shutdown()
        srv.server_close()
        service.stop(timeout=60)
        thread.join(60)
        if thread.is_alive() or service._thread.is_alive():
            fail("server: the HTTP or the engine thread did not stop")

    return f"http://127.0.0.1:{srv.server_address[1]}", stop


def phase_server_reference(torch) -> None:
    """A tiny float32 greedy model (int8 weights, grouped layout) behind
    TTSService and make_server, on the card and on the CPU: a two-segment
    /v1/synthesize must return the WAV of generate_audio on the same
    device, and the card's must equal the CPU's within 2 LSB."""
    import dataclasses

    import numpy as np

    from qwen3_tts_tpu_torch.engine import configs, generate_audio
    from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
    from qwen3_tts_tpu_torch.ops import cuda_kernels
    from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig
    from qwen3_tts_tpu_torch.server import TTSService

    os.environ["QWEN3_TTS_INT8_LAYOUT"] = "grouped"
    cfg = dataclasses.replace(configs.tiny(quant=True), dtype="float32")
    pcm = {}
    for dev in ("cpu", "cuda"):
        model = Qwen3TTSModel.synthetic(cfg, seed=0, device="cpu").to(dev)
        model.sampling = SamplingConfig(greedy=True)
        with tempfile.TemporaryDirectory() as out:
            m = generate_audio(model=model, text=SERVER_TEXT, voice="ryan",
                               output_path=out, max_frames=6)
            with wave.open(os.path.join(out, "audio_000.wav"), "rb") as w:
                direct = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        before = cuda_kernels.GROUPED_QMV.launches
        service = TTSService(model, max_streams=8).start()
        base, stop = _serve(service)
        try:
            resp = _http(base, "/v1/synthesize", {
                "text": SERVER_TEXT, "voice": "ryan", "max_frames": 6})
        finally:
            stop()
        if resp["status"] != 200:
            fail(f"server reference {dev}: HTTP {resp['status']}")
        pcm[dev] = _pcm(resp)
        if dev == "cuda" and cuda_kernels.GROUPED_QMV.launches == before:
            fail("server reference: kernel A never launched")
        if m["segments"] != 2 or not np.array_equal(pcm[dev], direct):
            fail(f"server reference {dev}: the daemon's WAV differs from "
                 f"generate_audio's ({m['segments']} segments)")
    a, b = pcm["cuda"].astype(np.int32), pcm["cpu"].astype(np.int32)
    diff = int(np.abs(a - b).max()) if a.shape == b.shape else None
    log({"phase": "server", "step": "reference", "dtype": "float32",
         "segments": 2, "samples": int(b.size), "max_lsb_card_vs_cpu": diff,
         "equal_to_generate_audio": True})
    if diff is None or diff > 2 or not np.abs(b).max():
        fail(f"server reference: the card's WAV differs from the CPU's "
             f"(max {diff} LSB) or is silent")
    os.environ.pop("QWEN3_TTS_INT8_LAYOUT")


def phase_server(torch, serving_rtf: float, asr) -> tuple[dict, dict]:
    """The HTTP daemon at full width: phase_server_reference, then
    flagship_feedback_code2wav behind TTSService(max_streams=8): eight
    concurrent clients of 64 frames (four complete /v1/synthesize, three
    streaming, one at speed 1.25, one OpenAI /v1/audio/speech), then a
    streaming client that drops after its first chunk, whose slot must
    free; /healthz, /v1/models and /metrics with the counters checked;
    step ``batch`` (run_batch over 8 items through the same service) and
    the quality step with ``asr``. Returns kernel launches and shapes of
    the eight-client run."""
    import threading

    import numpy as np

    from qwen3_tts_tpu_torch import batch
    from qwen3_tts_tpu_torch.engine.api import _estimate_frames
    from qwen3_tts_tpu_torch.ops import cuda_kernels
    from qwen3_tts_tpu_torch.server import TTSService

    phase_server_reference(torch)
    os.environ["QWEN3_TTS_INT8_LAYOUT"] = "grouped"
    label = "flagship_feedback_code2wav"
    model = _build(label)
    cfg = model.cfg
    hop, sr = cfg.codec.hop, cfg.codec.sample_rate
    skip = cfg.code2wav.startup_samples
    # the OpenAI surface takes no frame budget: a text whose estimate is 64
    oa_text = next((SERVING_TEXTS[7][:n] for n in range(1, 60)
                    if _estimate_frames(SERVING_TEXTS[7][:n],
                                        cfg.codec.frame_rate) >= SERVER_FRAMES),
                   SERVING_TEXTS[7])
    oa_frames = _estimate_frames(oa_text, cfg.codec.frame_rate)
    service = TTSService(model, max_streams=SERVING_STREAMS).start()
    base, stop = _serve(service)
    try:
        warm = _http(base, "/v1/synthesize", {"text": SERVING_TEXTS[0],
                                              "voice": "ryan", "max_frames": 8})
        if warm["status"] != 200:
            fail(f"server warm request: HTTP {warm['status']}")
        voices = [cfg.speakers[i % len(cfg.speakers)]
                  for i in range(SERVING_STREAMS)]
        reqs = []
        for i, (text, voice) in enumerate(zip(SERVING_TEXTS, voices)):
            body = {"text": text, "voice": voice, "max_frames": SERVER_FRAMES}
            if i < 4:
                reqs.append(("complete", "/v1/synthesize", body, 1.0))
            elif i < 7:
                speed = 1.25 if i == 6 else 1.0
                reqs.append(("stream", "/v1/synthesize",
                             dict(body, stream=True, speed=speed), speed))
            else:
                reqs.append(("openai", "/v1/audio/speech",
                             {"input": oa_text, "voice": voice}, 1.0))
        stats_before = service.stats()
        frames_before = service.frames_total
        results: list = [None] * len(reqs)
        gate = threading.Barrier(len(reqs) + 1)

        def client(i):
            gate.wait()
            results[i] = _http(base, reqs[i][1], reqs[i][2])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_kernels.reset_launch_counts()
        gate.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join(300)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in cuda_kernels.KERNELS}
        shapes = {k.name: set(k.shapes) for k in cuda_kernels.KERNELS}
        declined = kernel_c_ran("server flagship", counts)
        peak = torch.cuda.max_memory_allocated() / 1e9
        frames = service.frames_total - frames_before
        audio_s = 0.0
        for (kind, path, body, speed), r in zip(reqs, results):
            if r is None or r["status"] != 200:
                fail(f"server {kind}: {r and (r['status'], r['body'][:300])}")
            pcm = _pcm(r)
            frames_asked = oa_frames if kind == "openai" else SERVER_FRAMES
            budget = (frames_asked * hop - skip) / speed
            # WSOLA's output is whole 30 ms frames
            if not pcm.any() or len(pcm) > budget * 1.1 + 0.03 * sr:
                fail(f"server {kind}: {len(pcm)} samples (budget {budget}) "
                     "or silent")
            audio_s += len(pcm) / sr
        ttfa = sorted(r["first_byte_s"] for (kind, *_), r
                      in zip(reqs, results) if kind == "stream")
        # a streaming client that goes away after its first chunk: its job
        # is cancelled (it never finishes, so frames_total does not move)
        frames_before_drop = service.frames_total
        drop = _http(base, "/v1/synthesize", {
            "text": SERVING_TEXTS[1], "voice": "ryan", "max_frames": 400,
            "stream": True}, read_first=2048)
        dropped_at = time.perf_counter()
        deadline = dropped_at + 60
        while service.engine.free_slots() != SERVING_STREAMS:
            if time.perf_counter() > deadline:
                fail("server: the dropped stream's slot was not freed")
            time.sleep(0.05)
        freed_s = time.perf_counter() - dropped_at
        if service.frames_total != frames_before_drop:
            fail("server: the dropped stream ran to its end, not cancelled")
        health = json.loads(_http(base, "/healthz")["body"])
        models = json.loads(_http(base, "/v1/models")["body"])
        metrics = {ln.split()[0]: float(ln.split()[1]) for ln in
                   _http(base, "/metrics")["body"].decode().splitlines()
                   if ln and not ln.startswith("#") and "{" not in ln}
        sent = len(reqs) + 1
        if (health["requests_total"] - stats_before["requests_total"] != sent
                or health["errors_total"] != stats_before["errors_total"]
                or metrics["qwen3_tts_requests_total"]
                != health["requests_total"]
                or metrics["qwen3_tts_errors_total"] != health["errors_total"]
                or health["free_slots"] != SERVING_STREAMS
                or models["sample_rate"] != sr):
            fail(f"server counters: {health}, {metrics}")
        log({"phase": "server", "step": "flagship", "model": label,
             "layout": "grouped", "clients": [k for k, *_ in reqs],
             "frames_budget": SERVER_FRAMES, "openai_chars": len(oa_text),
             "openai_frames_budget": oa_frames,
             "frames": frames, "audio_s": audio_s, "wall_s": wall,
             "aggregate_rtf": audio_s / wall,
             "serving_engine_run_aggregate_rtf": serving_rtf,
             "ttfa_client_p50_s": statistics.median(ttfa),
             "ttfa_client_max_s": ttfa[-1],
             "ttfa_server_ms_complete": [r["headers"].get("X-TTFA-Ms")
                                         for (k, *_), r in zip(reqs, results)
                                         if k == "complete"],
             "launches": counts,
             "grouped_qmv_launches_per_frame": counts["grouped_qmv"] / frames,
             "decode_attention_declined": declined,
             "peak_mem_gb": peak,
             "dropped_stream_slot_freed_s": freed_s,
             "requests_total": health["requests_total"],
             "errors_total": health["errors_total"]})
        if counts["grouped_qmv"] == 0:
            fail("server: kernel A never launched")
        items = [{"id": f"item{i}", "text": t, "voice": v,
                  "max_seconds": 24 / cfg.codec.frame_rate}
                 for i, (t, v) in enumerate(zip(SERVING_TEXTS[:BATCH_ITEMS],
                                                voices))]
        with tempfile.TemporaryDirectory() as out:
            summary = batch.run_batch(service, items, out)
        log({"phase": "server", "step": "batch", **{
            k: v for k, v in summary.items() if k != "manifest"}})
        if summary["ok"] != len(items):
            fail(f"server batch: {summary}")
    finally:
        stop()
    phase_quality(torch, model, asr)
    del model, service
    torch.cuda.empty_cache()
    os.environ.pop("QWEN3_TTS_INT8_LAYOUT")
    return counts, shapes



# phase train: fine-tuning on the card (training/, finetune.py). Training is
# dense (torch.matmul), so neither kernel runs in it.

TRAIN_LR = 1e-2           # step reference: the optimizer's learning rate
# card vs CPU at float32, step reference: the first step starts from equal
# trees (losses and grad norm within TRAIN_RTOL); Adam divides each
# component by its own RMS, so a component whose gradient is near zero can
# turn an ulp-level gradient difference into a visible share of one
# lr-sized step: every parameter element within TRAIN_STEP_TOL * lr, and
# the later steps' metrics, computed on those trees, within 1e-3
TRAIN_RTOL = 1e-4
TRAIN_LATER_RTOL = 1e-3
TRAIN_STEP_TOL = 0.1
TRAIN_STEPS = 6           # steps full and lora (recovery: 4)
TRAIN_PAIRS = 8


def _train_reference_cases(configs) -> dict:
    import dataclasses

    def f32(c):
        return dataclasses.replace(c, dtype="float32")

    return {
        "cb0": (f32(configs.tiny()), {}),
        "residual_sum": (f32(configs.tiny_feedback()), {}),
        "fps2_cpb": (f32(configs.tiny_feedback(frames_per_step=2,
                                               mtp_cp_batch=True)), {}),
        "dg3_draft": (f32(configs.tiny_feedback(depth_group=3)),
                      {"draft": True}),
        "lora_r4": (f32(configs.tiny()), {"lora": 4}),
    }


def _train_run(cfg, opts: dict, device: str, resume_dir=None):
    """Three default_optimizer steps on one synthetic batch (ragged text,
    speakers on alternate rows) from the numpy initialisers' trees on
    ``device``; with ``resume_dir``, saved after two steps and restored
    into fresh trees for the third. Returns each step's metrics and the
    trained leaves after each step (on the host)."""
    import dataclasses

    from qwen3_tts_tpu_torch.engine.weights import tree_to
    from qwen3_tts_tpu_torch.models.code_predictor import init_code_predictor
    from qwen3_tts_tpu_torch.models.talker import init_talker
    from qwen3_tts_tpu_torch.training import (
        add_lora,
        default_optimizer,
        init_lora_train_state,
        init_train_state,
        make_lora_train_step,
        make_train_step,
        split_lora,
    )
    from qwen3_tts_tpu_torch.training.checkpoint import (
        restore_train_state,
        save_train_state,
    )
    from qwen3_tts_tpu_torch.training.train import synthetic_batch, tree_leaves

    batch = synthetic_batch(cfg, 4, 8, 6, seed=0)
    batch["text_mask"][1, 5:] = False
    batch["text_mask"][3, 4:] = False
    opt = default_optimizer(lr=TRAIN_LR)
    if opts.get("draft"):
        opt = dataclasses.replace(opt, trainable=(("mtp",), ("draft",)))

    def fresh(seed):
        """The trees drawn from ``seed``; a LoRA run keeps its base (seed 0:
        a checkpoint holds the adapters only) and draws its adapters from
        ``seed``."""
        base_seed = 0 if opts.get("lora") else seed
        p = tree_to(init_talker(cfg, base_seed), device)
        cp = tree_to(init_code_predictor(cfg, base_seed + 1), device)
        if opts.get("draft"):
            cp = {**cp, "draft": tree_to(init_code_predictor(cfg, seed + 7),
                                         device)}
        if opts.get("lora"):
            lora, base = split_lora(add_lora(p, rank=opts["lora"], seed=seed))
            state = init_lora_train_state(lora, opt)
            step = make_lora_train_step(cfg, opt)
            return state, (lambda s: step(s, base, cp, batch)), \
                (lambda s: s.lora)
        state = init_train_state(p, cp, opt)
        step = make_train_step(cfg, opt)
        return state, (lambda s: step(s, batch)), \
            (lambda s: [s.params, s.cp_params])

    state, run, trees = fresh(0)
    metrics, leaves = [], []
    for i in range(3):
        if resume_dir is not None and i == 2:
            path = save_train_state(state, resume_dir)
            state, run, trees = fresh(5)
            state = restore_train_state(path, state)
        state, m = run(state)
        metrics.append({k: float(v) for k, v in m.items()})
        leaves.append({k: v.detach().cpu().clone()
                       for k, v in tree_leaves(trees(state))})
    return metrics, leaves


def _train_compare(label: str, got, want) -> dict:
    """Card run ``got`` against ``want``: per-step metrics and leaves."""
    (gm, gl), (wm, wl) = got, want
    worst = {}
    for i in range(3):
        rtol = TRAIN_RTOL if i == 0 else TRAIN_LATER_RTOL
        for k, v in wm[i].items():
            if abs(gm[i][k] - v) > rtol * abs(v):
                fail(f"train {label}: step {i + 1} {k} {gm[i][k]} vs {v}")
        if gl[i].keys() != wl[i].keys():
            fail(f"train {label}: the trees differ in structure")
        for k, v in wl[i].items():
            worst[k] = max(worst.get(k, 0.0),
                           float((gl[i][k] - v).abs().max()))
    name, err = max(worst.items(), key=lambda kv: kv[1])
    if err > TRAIN_STEP_TOL * TRAIN_LR:
        fail(f"train {label}: leaf {name} off by {err} "
             f"(bound {TRAIN_STEP_TOL * TRAIN_LR})")
    bit_equal = all(_equal(gs[k], ws[k]) for gs, ws in zip(gl, wl)
                    for k in ws)
    return {"max_leaf_err": err, "worst_leaf": name,
            "leaf_bound": TRAIN_STEP_TOL * TRAIN_LR, "bit_equal": bit_equal,
            "losses": [m["loss"] for m in gm],
            "grad_norms": [m["grad_norm"] for m in gm]}


def _equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool((a == b).all())


def phase_train_reference(torch) -> None:
    """Step ``reference``: each tiny float32 case on the card against the
    CPU, then save/resume on the card against the uninterrupted card run."""
    from qwen3_tts_tpu_torch.engine import configs

    cases = _train_reference_cases(configs)
    card_runs = {}
    threads = torch.get_num_threads()
    for label, (cfg, opts) in cases.items():
        t0 = time.perf_counter()
        card_runs[label] = _train_run(cfg, opts, "cuda")
        # tiny CPU runs are op-overhead bound: one thread is ~70x faster
        # than a pool that spins between the small ops
        torch.set_num_threads(1)
        try:
            cpu_run = _train_run(cfg, opts, "cpu")
        finally:
            torch.set_num_threads(threads)
        row = _train_compare(label, card_runs[label], cpu_run)
        log({"phase": "train", "step": "reference", "case": label,
             "dtype": "float32", "steps": 3, "lr": TRAIN_LR,
             "loss_rtol": TRAIN_RTOL, **row,
             "wall_s": time.perf_counter() - t0})
    for label in ("cb0", "lora_r4"):
        cfg, opts = cases[label]
        with tempfile.TemporaryDirectory(prefix="q3tts_ckpt_") as ckpt:
            resumed = _train_run(cfg, opts, "cuda", resume_dir=ckpt)
        row = _train_compare(f"{label} resume", resumed, card_runs[label])
        log({"phase": "train", "step": "resume", "case": label,
             "saved_after": 2, "steps": 3, **row})


def write_train_pairs(d: str, n: int = TRAIN_PAIRS, seed: int = 0) -> None:
    """``n`` <name>.wav + <name>.txt pairs: seeded 2-4 s voiced clips at
    24 kHz (a harmonic tone at a random pitch, a slow vibrato, a little
    noise), each with a SERVING_TEXTS sentence."""
    import numpy as np

    from qwen3_tts_tpu_torch.audio import write_wav

    rng = np.random.default_rng(seed)
    sr = 24000
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        t = np.arange(int(rng.uniform(2.0, 4.0) * sr)) / sr
        f0 = rng.uniform(100.0, 240.0) * (1 + 0.03 * np.sin(2 * np.pi * 4 * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        wav = sum(np.sin(h * phase) / h for h in range(1, 6)) * 0.12
        wav += 0.01 * rng.standard_normal(len(t))
        write_wav(os.path.join(d, f"pair{i}.wav"), wav.astype(np.float32), sr)
        with open(os.path.join(d, f"pair{i}.txt"), "w") as f:
            f.write(SERVING_TEXTS[i % len(SERVING_TEXTS)] + "\n")


def _finetune(torch, argv: list) -> dict:
    """finetune.main(argv) on the card with QWEN3_TTS_METRICS on: its
    summary, s/step (median of the steps after the first), trained
    frames/s over those steps, peak memory (from a reset just before)."""
    import contextlib
    import gc
    import io

    from qwen3_tts_tpu_torch import finetune

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, err = io.StringIO(), io.StringIO()
    os.environ["QWEN3_TTS_METRICS"] = "1"
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = finetune.main(argv)
    finally:
        os.environ.pop("QWEN3_TTS_METRICS")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    if rc != 0:
        fail(f"finetune {argv}: exit {rc}: {err.getvalue()[-3000:]}")
    steps = [json.loads(ln) for ln in err.getvalue().splitlines()
             if '"finetune_step"' in ln]
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    later = steps[1:]
    losses = (summary["first_loss"], summary["final_loss"])
    if len(steps) != int(argv[argv.index("--steps") + 1]) or not all(
            math.isfinite(x) for x in losses):
        fail(f"finetune {argv}: {len(steps)} step lines, losses {losses}")
    return {"steps": len(steps), "batch_size": int(
                argv[argv.index("--batch-size") + 1]),
            "s_per_step": statistics.median(s["step_s"] for s in later),
            "first_step_s": steps[0]["step_s"],
            "frames_per_step": [s["frames"] for s in steps],
            "trained_frames_per_s": sum(s["frames"] for s in later)
            / sum(s["step_s"] for s in later),
            "peak_mem_gb": peak / 1e9,
            "resident_gb": steps[-1].get("allocated_gb"),
            "first_loss": losses[0], "final_loss": losses[1],
            "losses": [s["loss"] for s in steps],
            "grad_norms": [s["grad_norm"] for s in steps],
            "finetune_wall_s": wall}


def phase_profile_train(torch) -> None:
    """Where a full fine-tune step's time goes: the dense flagship, one
    synthetic batch of 4 (64 text tokens, 48 frames), two warm steps, three
    timed, three under torch.profiler; the card's busy share is the
    profiled kernels' device time over the timed steps' wall time."""
    from torch.profiler import ProfilerActivity, profile

    from qwen3_tts_tpu_torch.engine import configs
    from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
    from qwen3_tts_tpu_torch.training import (
        default_optimizer,
        init_train_state,
        make_train_step,
    )
    from qwen3_tts_tpu_torch.training.train import synthetic_batch

    cfg = configs.with_quant(configs.flagship(), False)
    model = Qwen3TTSModel.synthetic(cfg, device="cuda")
    opt = default_optimizer()
    state = init_train_state(model.params, model.cp_params, opt)
    step = make_train_step(cfg, opt)
    batch = synthetic_batch(cfg, 4, 64, 48, seed=0)
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    # the optimizer's record_function range is a device-typed event too:
    # counted, it would add its kernels' time a second time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6 / 3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    log({"phase": "profile", "model": "train:synthetic", "batch": [4, 64, 48],
         "s_per_step": wall,
         "device_s_per_step": device_s if kernels else "not measured",
         "device_busy_share": device_s / wall if kernels else "not measured",
         "kernel_launches_per_step": sum(e.count for e in kernels) / 3,
         "top_kernels": [{"name": e.key[:80], "count": e.count / 3,
                          "device_ms": e.self_device_time_total / 3e3}
                         for e in top[:12]]})
    del state, step, model
    torch.cuda.empty_cache()


def _decode_export(torch, path: str, where: str, frames: int = 16) -> dict:
    """load_model(path) on the card and one generate_audio of ``frames``
    frames, its WAV checked as the main paths' are."""
    import numpy as np

    from qwen3_tts_tpu_torch.engine import generate_audio, load_model

    t0 = time.perf_counter()
    model = load_model(path, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg = model.cfg
    with tempfile.TemporaryDirectory() as out:
        m = generate_audio(model=model, text=TEXT, voice=cfg.speakers[0],
                           output_path=out, max_frames=frames, seed=0)
        with wave.open(os.path.join(out, "audio_000.wav"), "rb") as w:
            fmt = (w.getnchannels(), w.getsampwidth(), w.getframerate())
            n = w.getnframes()
            pcm = np.frombuffer(w.readframes(n), dtype="<i2")
    skip = cfg.code2wav.startup_samples if cfg.codec_arch == "code2wav" else 0
    if fmt != (1, 2, 24000) or m["frames"] < 1 \
            or n != m["frames"] * cfg.codec.hop - skip or not pcm.any():
        fail(f"{where}: wav {fmt}, {n} samples for {m['frames']} frames, "
             "or silent")
    del model
    torch.cuda.empty_cache()
    return {"export_load_s": load_s, "decoded_frames": m["frames"],
            "decode_wall_s": m["wall_s"],
            "export_fps": cfg.talker.frames_per_step,
            "export_quant": cfg.quant.enabled}


def _launches() -> dict:
    from qwen3_tts_tpu_torch.ops import cuda_kernels

    return {k.name: k.launches for k in cuda_kernels.KERNELS}


def _check_no_launches(where: str, counts: dict) -> None:
    """Training is dense: kernels A and B never launch (kernel C runs in
    the bf16 decodes of the exports)."""
    if any(counts[name] for name in INT8_KERNELS):
        fail(f"{where}: training is dense, yet int8 kernels launched: "
             f"{counts}")


def phase_train(torch) -> None:
    """Steps ``reference``, then ``full`` and ``lora``: finetune.main on the
    dense flagship over TRAIN_PAIRS seeded clips, each export decoded."""
    import shutil

    from qwen3_tts_tpu_torch.ops import cuda_kernels

    cuda_kernels.reset_launch_counts()
    phase_train_reference(torch)
    with tempfile.TemporaryDirectory(prefix="q3tts_train_") as tmp:
        data = os.path.join(tmp, "data")
        write_train_pairs(data)
        for step, extra in (("full", []), ("lora", ["--lora", "8"])):
            export = os.path.join(tmp, step)
            t0 = time.perf_counter()
            row = _finetune(torch, ["--model", "synthetic", "--data", data,
                                    "--steps", str(TRAIN_STEPS),
                                    "--batch-size", "4", "--export", export]
                            + extra)
            row.update(_decode_export(torch, export, f"train {step}"))
            shutil.rmtree(export)
            log({"phase": "train", "step": step, "model": "synthetic",
                 "config": "flagship, dense bf16", **row,
                 "launches": _launches(),
                 "step_wall_s": time.perf_counter() - t0})
    _check_no_launches("train", _launches())


def phase_train_recovery(torch, snap: str) -> None:
    """Step ``recovery`` (phase 7's snapshot, QWEN3_TTS_COMPUTE=bf16):
    freeze-base MTP recovery at fps 2 with the batched-cp chain, 4 steps;
    the export's leaves outside ``mtp`` bit-equal to the loaded tree's,
    the grafted MTP linears moved, 16 frames decoded at fps 2."""
    from qwen3_tts_tpu_torch.engine import configs, load_model
    from qwen3_tts_tpu_torch.models.talker import add_mtp_params
    from qwen3_tts_tpu_torch.ops import cuda_kernels
    from qwen3_tts_tpu_torch.training.train import tree_leaves

    cuda_kernels.reset_launch_counts()
    os.environ["QWEN3_TTS_COMPUTE"] = "bf16"
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="q3tts_recovery_") as tmp:
            data = os.path.join(tmp, "data")
            write_train_pairs(data)
            export = os.path.join(tmp, "export")
            row = _finetune(torch, [
                "--model", snap, "--data", data, "--mtp-fps", "2",
                "--mtp-cp-batch", "--freeze-base", "--steps", "4",
                "--batch-size", "4", "--export", export])
            base = load_model(snap, device="cuda")
            tuned = load_model(export, device="cuda")
            loaded = dict(tree_leaves(
                [base.params, base.cp_params, base.codec_params]))
            moved = [k for k, v in tree_leaves(
                [tuned.params, tuned.cp_params, tuned.codec_params])
                if "mtp" not in k and not _equal(v, loaded[k])]
            if moved:
                fail(f"train recovery: frozen leaves moved: {moved[:5]}")
            if tuned.cfg.talker.frames_per_step != 2 \
                    or not tuned.cfg.talker.mtp_cp_batch:
                fail(f"train recovery: export talker config {tuned.cfg.talker}")
            grafted = add_mtp_params(
                base.params, configs.with_frames_per_step(base.cfg, 2),
                seed=0)["mtp"]
            trained = dict(tree_leaves(tuned.params["mtp"]))
            still = [k for k, v in tree_leaves(grafted)
                     if k.endswith("/w") and _equal(v, trained[k].cpu())]
            if still:
                fail(f"train recovery: MTP linears never moved: {still}")
            n_frozen = sum(v.numel() for k, v in tree_leaves(
                [tuned.params, tuned.cp_params]) if "mtp" not in k)
            del base, tuned
            torch.cuda.empty_cache()
            row.update(_decode_export(torch, export, "train recovery"))
    finally:
        os.environ.pop("QWEN3_TTS_COMPUTE")
    counts = _launches()
    log({"phase": "train", "step": "recovery",
         "model": "import:flagship_feedback_code2wav", "compute": "bf16",
         "flags": "--mtp-fps 2 --mtp-cp-batch --freeze-base", **row,
         "frozen_params_bit_equal": n_frozen, "launches": counts,
         "step_wall_s": time.perf_counter() - t0})
    _check_no_launches("train recovery", counts)



# --------------------------------------------------------------------------
# phase parallel: tensor-parallel decode over torch.distributed
# --------------------------------------------------------------------------

PARALLEL_TP = 2
# two ranks share the one card, so NCCL (one card a rank) cannot carry them:
# gloo, which sums CUDA tensors through host memory
PARALLEL_BACKEND, PARALLEL_DEVICE = "gloo", "cuda:0"
PARALLEL_TINY_FRAMES = 16
PARALLEL_TINY_BUDGETS = (6, 16, 11, 12)
PARALLEL_TF_STEPS = 8          # teacher-forced decode steps after the prefill
PARALLEL_TF_PROMPT = 32        # prefill rows of the logits check
# float32 talker logits, tp = 2 against one rank on the same weights:
# max|sharded - whole| <= PARALLEL_F32_TOL * max|whole| (the tp sum adds
# two partial f32 products where one rank accumulates them in one)
PARALLEL_F32_TOL = 1e-4
PARALLEL_FRAMES = 64           # flagship_bf16 single stream
PARALLEL_SERVING_FRAMES = 32   # flagship_bf16 serving, 8 streams
PARALLEL_NOTE = ("no speed claimed: the gloo sum stages every tp all_reduce "
                 "through host memory and is expected to set the pace")


def _parallel_feedback_tiny():
    """The tiny residual_sum + code2wav model with int8 weights, float32."""
    import dataclasses

    from qwen3_tts_tpu_torch.engine import configs

    return dataclasses.replace(configs.with_quant(configs.with_code2wav(
        configs.tiny_feedback(), configs.tiny_code2wav().code2wav), True),
        dtype="float32")


def _parallel_decode(model, prompts, single_frames: int, budgets,
                     slots: int) -> dict:
    """One greedy-or-seeded single-stream synthesis of ``prompts[0]`` and
    one ServingEngine.run of ``prompts``: codes, WAVs, frames, walls."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    r = model.generator.synthesize(prompts[0], max_frames=single_frames,
                                   seed=0, collect_codes=True)
    torch.cuda.synchronize()
    single_wall = time.perf_counter() - t0
    engine = model.serving_engine(slots)
    engine.rng.manual_seed(0)
    t0 = time.perf_counter()
    served = engine.run(prompts, max_frames=list(budgets))
    torch.cuda.synchronize()
    return {"single": {"codes": r.codes, "wav": r.wav, "frames": r.frames,
                       "wall_s": single_wall, "ttfa_s": r.ttfa_s},
            "served": {"codes": [np.concatenate(st.codes, 1)
                                 for _, st in served],
                       "wavs": [w for w, _ in served],
                       "frames": [st.frames for _, st in served],
                       "ttfa_s": [st.ttfa_s for _, st in served],
                       "wall_s": time.perf_counter() - t0}}


def _talker_logits(model, mesh) -> "np.ndarray":
    """Float32 talker logits [1 + PARALLEL_TF_STEPS, V]: the prefill's last
    position over PARALLEL_TF_PROMPT text rows, then teacher-forced decode
    steps on fixed codec tokens."""
    import torch

    from qwen3_tts_tpu_torch.models.layers import rope_tables
    from qwen3_tts_tpu_torch.models.talker import talker_forward

    t, p = model.cfg.talker, model.params
    dev = p["codec_emb"].device
    S = PARALLEL_TF_PROMPT + PARALLEL_TF_STEPS
    tp = 1 if mesh is None else mesh.tp
    shape = (t.n_layers, 1, S, t.n_kv_heads // tp, t.head_dim)
    ck = torch.zeros(shape, dtype=p["codec_emb"].dtype, device=dev)
    cv = torch.zeros_like(ck)
    cos, sin = rope_tables(S, t.head_dim, t.rope_theta, dev)
    ids = torch.arange(PARALLEL_TF_PROMPT, device=dev) * 37 % t.vocab_size
    _, lg, _, _ = talker_forward(p, t, p["text_emb"][ids][None], ck, cv, 0,
                                 cos, sin, head_last_only=True, mesh=mesh)
    rows = [lg[0, -1]]
    for i in range(PARALLEL_TF_STEPS):
        tok = torch.tensor([[(97 * i + 11) % t.codec_vocab]], device=dev)
        _, lg, _, _ = talker_forward(p, t, p["codec_emb"][tok], ck, cv,
                                     PARALLEL_TF_PROMPT + i, cos, sin,
                                     mesh=mesh)
        rows.append(lg[0, -1])
    return torch.stack(rows).float().cpu().numpy()


def parallel_rank(device, tiny_prompts) -> dict:
    """One rank of phase ``parallel`` (started by parallel.comm.launch; it
    prints nothing and raises on any fault): steps tiny_f32, flagship_f32
    and flagship_bf16 on this rank's tp shard."""
    import dataclasses

    import torch

    from qwen3_tts_tpu_torch.engine import configs, prepare_segments
    from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
    from qwen3_tts_tpu_torch.ops import cuda_kernels
    from qwen3_tts_tpu_torch.parallel import (
        MeshPlan, build_mesh, comm, shard_model,
    )
    from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    mesh = build_mesh(MeshPlan(dp=1, tp=PARALLEL_TP), device)
    out = {"rank": mesh.rank, "device": str(device)}

    t_step = time.perf_counter()
    cuda_kernels.reset_launch_counts()  # the float32 steps' launches from 0
    model = Qwen3TTSModel.synthetic(_parallel_feedback_tiny(), seed=0,
                                    device="cpu").to(device)
    model.sampling = SamplingConfig(greedy=True)
    shard_model(model, mesh)
    out["tiny_f32"] = _parallel_decode(
        model, tiny_prompts, PARALLEL_TINY_FRAMES, PARALLEL_TINY_BUDGETS, 4)
    out["tiny_f32"]["step_s"] = time.perf_counter() - t_step

    t_step = time.perf_counter()
    cfg = dataclasses.replace(configs.flagship_feedback_code2wav(),
                              dtype="float32")
    model = Qwen3TTSModel.synthetic(cfg, seed=0, device=device)
    t0 = time.perf_counter()
    whole = _talker_logits(model, None) if mesh.rank == 0 else None
    whole_s = time.perf_counter() - t0
    shard_model(model, mesh)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["flagship_f32"] = {"whole": whole, "whole_s": whole_s,
                           "sharded": _talker_logits(model, mesh),
                           "sharded_s": time.perf_counter() - t0}
    del model
    torch.cuda.empty_cache()
    out["flagship_f32"]["step_s"] = time.perf_counter() - t_step
    out["f32_launches"] = {k.name: k.by_dtype["float32"]
                           for k in cuda_kernels.KERNELS
                           if "float32" in k.by_dtype}
    out["f32_shapes"] = {k.name: sorted(k.shapes) for k in cuda_kernels.KERNELS}

    t_step = time.perf_counter()
    model = Qwen3TTSModel.synthetic(configs.flagship_feedback_code2wav(),
                                    seed=0, device=device)
    shard_model(model, mesh)
    cfg = model.cfg
    voices = [cfg.speakers[i % len(cfg.speakers)]
              for i in range(SERVING_STREAMS)]
    prompts = [prepare_segments(model, text, voice=voice)[0][0]
               for text, voice in zip(SERVING_TEXTS, voices)]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launch_counts()
    comm.reset_stats()
    run = _parallel_decode(model, prompts, PARALLEL_FRAMES,
                           [PARALLEL_SERVING_FRAMES] * SERVING_STREAMS,
                           SERVING_STREAMS)
    run["launches"] = {k.name: k.launches for k in cuda_kernels.KERNELS}
    run["shapes"] = {k.name: sorted(k.shapes) for k in cuda_kernels.KERNELS}
    run["all_reduce"] = dict(comm.STATS["tp_sum"])
    run["peak_mem_gb"] = torch.cuda.max_memory_allocated() / GB
    run["step_s"] = time.perf_counter() - t_step
    out["flagship_bf16"] = run
    return out


def _check_wav(where: str, wav, frames: int, cfg) -> None:
    import numpy as np

    skip = cfg.code2wav.startup_samples
    if frames < 1 or len(wav) != frames * cfg.codec.hop - skip \
            or wav.dtype != np.int16 or not wav.any():
        fail(f"{where}: {len(wav)} samples ({wav.dtype}) for {frames} "
             f"frames (hop {cfg.codec.hop}, startup {skip}), or silent")


def _same_codes(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def phase_parallel(torch, checked: dict,
                   checked_f32: dict) -> tuple[dict, dict, dict]:
    """Tensor-parallel decode (parallel/) at tp = 2 on one card: two ranks
    on cuda:0 over gloo (parallel.comm.launch; the kernels were built by
    phase 1, before the ranks start). Steps: ``tiny_f32`` (the tiny
    residual_sum + code2wav model, int8 weights: one 16-frame synthesis
    and 4 serving streams, greedy codes equal to the same tree's one-rank
    run on the CPU, computed here); ``flagship_f32``
    (flagship_feedback_code2wav in float32, int8 weights: the talker
    logits of the prefill and 8 teacher-forced steps against rank 0's
    unsharded run, within PARALLEL_F32_TOL); ``flagship_bf16`` (the same
    model in bf16: a 64-frame synthesis and 8 serving streams of 32
    frames, WAVs checked, the ranks' codes equal, kernel A never launched;
    kernel B's launches a frame and shapes, all_reduce calls a frame,
    their host seconds and the card waits before them, peak memory, RTF
    per rank). Every kernel B shape
    the kernel phase's plan missed is held against its plain version
    before the step's lines (the float32 steps' at float32). Returns the
    bf16 step's launches (both ranks) and shapes, and the float32 steps'
    launches of each kernel's float32 instance (both ranks)."""
    import numpy as np

    from qwen3_tts_tpu_torch.engine import configs, prepare_segments
    from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
    from qwen3_tts_tpu_torch.parallel import launch
    from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig

    t_phase = time.perf_counter()
    where = {"backend": PARALLEL_BACKEND, "device": PARALLEL_DEVICE,
             "tp": PARALLEL_TP}
    cfg = _parallel_feedback_tiny()
    host = Qwen3TTSModel.synthetic(cfg, seed=0, device="cpu")
    host.sampling = SamplingConfig(greedy=True)
    prompts = [prepare_segments(host, text, voice=voice)[0][0]
               for text, voice in zip(SERVING_TEXTS[:4], cfg.speakers)]
    cpu = _parallel_decode(host, prompts, PARALLEL_TINY_FRAMES,
                           PARALLEL_TINY_BUDGETS, 4)

    t0 = time.perf_counter()
    ranks = launch(parallel_rank, PARALLEL_TP, backend=PARALLEL_BACKEND,
                   device=PARALLEL_DEVICE, args=(prompts,))
    launch_s = time.perf_counter() - t0

    for rk in ranks:
        got = rk["tiny_f32"]
        ok = (np.array_equal(got["single"]["codes"], cpu["single"]["codes"])
              and _same_codes(got["served"]["codes"],
                              cpu["served"]["codes"]))
        log({"phase": "parallel", "step": "tiny_f32", **where,
             "rank": rk["rank"], "single_frames": got["single"]["frames"],
             "served_frames": got["served"]["frames"],
             "budgets": list(PARALLEL_TINY_BUDGETS), "card_equals_cpu": ok,
             "step_s": got["step_s"]})
        if not ok:
            fail(f"parallel tiny_f32 rank {rk['rank']}: greedy codes at tp="
                 f"{PARALLEL_TP} differ from the one-rank CPU run")

    f32_shapes = {(name, *shape) for rk in ranks
                  for name, run in rk["f32_shapes"].items() for shape in run}
    phase_kernels(torch, sorted(f32_shapes - checked_f32.keys()), checked_f32,
                  "parallel", f32=True, timed=False)
    f32_counts = {name: sum(rk["f32_launches"][name] for rk in ranks)
                  for name in ranks[0]["f32_launches"]}
    if not f32_counts["dequant_matmul"]:
        fail(f"parallel float32 steps: kernel B's float32 instance never "
             f"launched ({f32_counts})")

    whole = ranks[0]["flagship_f32"]["whole"]
    scale = float(np.abs(whole).max())
    for rk in ranks:
        f32 = rk["flagship_f32"]
        err = float(np.abs(f32["sharded"] - whole).max())
        log({"phase": "parallel", "step": "flagship_f32", **where,
             "rank": rk["rank"], "rows": int(whole.shape[0]),
             "vocab": int(whole.shape[1]), "max_abs_err": err,
             "max_abs_logit": scale, "tol": PARALLEL_F32_TOL * scale,
             "rel_tol": PARALLEL_F32_TOL, "sharded_s": f32["sharded_s"],
             "whole_s": f32["whole_s"] if rk["rank"] == 0 else None,
             "step_s": f32["step_s"]})
        if not np.isfinite(err) or err > PARALLEL_F32_TOL * scale:
            fail(f"parallel flagship_f32 rank {rk['rank']}: max|sharded - "
                 f"whole| {err} > {PARALLEL_F32_TOL} * {scale}")

    ref = configs.flagship_feedback_code2wav()
    runs = [rk["flagship_bf16"] for rk in ranks]
    shapes = {name: set() for name in runs[0]["launches"]}
    for run in runs:
        for name, run_shapes in run["shapes"].items():
            shapes[name].update(tuple(s) for s in run_shapes)
    missing = sorted({(name, *shape) for name, run_shapes in shapes.items()
                      for shape in run_shapes} - checked.keys())
    phase_kernels(torch, missing, checked, "parallel", timed=False)
    for run, rk in zip(runs, ranks):
        single, served = run["single"], run["served"]
        _check_wav(f"parallel flagship_bf16 rank {rk['rank']} single",
                   single["wav"], single["frames"], ref)
        for i, (w, n) in enumerate(zip(served["wavs"], served["frames"])):
            _check_wav(f"parallel flagship_bf16 rank {rk['rank']} stream {i}",
                       w, n, ref)
        frames = single["frames"] + sum(served["frames"])
        sr = ref.codec.sample_rate
        log({"phase": "parallel", "step": "flagship_bf16", **where,
             "rank": rk["rank"], "model": "flagship_feedback_code2wav",
             "single_frames": single["frames"],
             "single_rtf": len(single["wav"]) / sr / single["wall_s"],
             "single_ttfa_s": single["ttfa_s"],
             "streams": len(served["frames"]),
             "served_frames": served["frames"],
             "aggregate_rtf": sum(len(w) for w in served["wavs"]) / sr
             / served["wall_s"],
             "ttfa_p50_s": statistics.median(served["ttfa_s"]),
             "launches": run["launches"],
             "dequant_matmul_launches_per_frame":
                 run["launches"]["dequant_matmul"] / frames,
             "dequant_matmul_shapes": run["shapes"]["dequant_matmul"],
             "all_reduce_per_frame": run["all_reduce"]["calls"] / frames,
             "all_reduce_host_s": run["all_reduce"]["host_s"],
             "all_reduce_sync_s": run["all_reduce"]["sync_s"],
             "peak_mem_gb": run["peak_mem_gb"], "step_s": run["step_s"],
             "single_wall_s": single["wall_s"],
             "serving_wall_s": served["wall_s"], "note": PARALLEL_NOTE})
        if run["launches"]["grouped_qmv"] or not run["launches"]["dequant_matmul"]:
            fail(f"parallel flagship_bf16 rank {rk['rank']}: launches "
                 f"{run['launches']}: kernel B must carry every int8 linear "
                 "under tp (row-major shards), kernel A none")
    a, b = runs[0], runs[-1]
    agree = (np.array_equal(a["single"]["codes"], b["single"]["codes"])
             and _same_codes(a["served"]["codes"], b["served"]["codes"]))
    log({"phase": "parallel", "step": "summary", **where,
         "ranks_agree": agree, "shapes_checked_here": len(missing),
         "launch_s": launch_s, "phase_s": time.perf_counter() - t_phase})
    if not agree:
        fail("parallel flagship_bf16: the ranks' codes differ")
    counts = {name: sum(run["launches"][name] for run in runs)
              for name in runs[0]["launches"]}
    return counts, shapes, f32_counts

# --------------------------------------------------------------------------
# phase train_parallel: parallel training over torch.distributed
# --------------------------------------------------------------------------

# eight ranks share the one card, over gloo (as phase parallel); the mesh
# and microbatches of the dry run (parallel/dryrun.py), sp on
TRAIN_PAR_RANKS = 8
TRAIN_PAR_PLAN = (2, 2, 2)              # (pp, dp, tp)
TRAIN_PAR_MICRO = 4
TRAIN_PAR_TINY_BATCH = (8, 8, 6)        # rows, text tokens, frames
TRAIN_PAR_FLAGSHIP_BATCH = (8, 16, 24)
TRAIN_PAR_STEPS = 2                     # flagship_bf16
# tiny_f32, the card's eight ranks against one CPU rank: the same float32
# arithmetic summed in another order (tp partial sums, microbatches, the
# dp and pp sums of the grads; as tests/test_torch_parallel_training.py)
TRAIN_PAR_LOSS_RTOL = 1e-5
TRAIN_PAR_NORM_RTOL = 1e-4
TRAIN_PAR_LEAF_TOL = 1e-4               # of each leaf's max|.|
# flagship_bf16, eight ranks against one on the card: bf16 activations
# rounded at other points (each tp partial sum, the microbatch shapes), a
# 2^-9 relative rounding compounded over 28 blocks; the loss averages
# 8 x 40 rows, the grad norm weighs the largest grads
# the anchor and distillation terms: tiny_f32_anchor's weights make the
# penalty's grads move the grad norm (as the CPU tests' do); the flagship
# step takes finetune's --anchor 0.1 --distill 0.1
TRAIN_PAR_TINY_TERMS = {"anchor_weight": 1e4, "distill_weight": 10.0}
TRAIN_PAR_FLAGSHIP_TERMS = {"anchor_weight": 0.1, "distill_weight": 0.1}
TRAIN_PAR_BF16_LOSS_RTOL = 1e-2
TRAIN_PAR_BF16_NORM_RTOL = 5e-2
TRAIN_PAR_FT_RANKS = 2


def _train_par_tiny():
    import dataclasses

    from qwen3_tts_tpu_torch.engine import configs

    return dataclasses.replace(configs.tiny("custom"), dtype="float32")


def _train_par_flagship():
    from qwen3_tts_tpu_torch.engine import configs

    return configs.with_quant(configs.flagship(), False)


def _train_par_plan():
    from qwen3_tts_tpu_torch.parallel import MeshPlan

    pp, dp, tp = TRAIN_PAR_PLAN
    return MeshPlan(dp=dp, tp=tp, pp=pp)


def _host_leaves(tree) -> dict:
    from qwen3_tts_tpu_torch.training.train import tree_leaves

    return {k: v.detach().float().cpu().clone() for k, v in tree_leaves(tree)}


def _comm_delta(before: dict, after: dict) -> dict:
    return {kind: {k: after[kind][k] - before[kind][k]
                   for k in ("calls", "host_s", "sync_s")}
            for kind in after}


def train_parallel_rank(device, tiny_trees, frozen_trees, batches,
                        ckpt_dir) -> dict:
    """One rank of phase ``train_parallel`` (started by
    parallel.comm.launch; it prints nothing and raises on any fault)."""
    import copy
    import dataclasses

    import torch

    from qwen3_tts_tpu_torch.models.code_predictor import init_code_predictor
    from qwen3_tts_tpu_torch.models.talker import init_talker
    from qwen3_tts_tpu_torch.ops import cuda_kernels
    from qwen3_tts_tpu_torch.parallel import build_mesh, comm
    from qwen3_tts_tpu_torch.parallel.mesh import validate_tp
    from qwen3_tts_tpu_torch.parallel.sharding import (
        gather_params, layer_keeper, shard_for_training, training_specs)
    from qwen3_tts_tpu_torch.training import (
        default_optimizer, init_train_state, make_train_step)
    from qwen3_tts_tpu_torch.training.checkpoint import (
        restore_train_state, save_train_state)
    from qwen3_tts_tpu_torch.training.train import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    mesh = build_mesh(_train_par_plan(), device)
    out = {"rank": mesh.rank, "coords": list(mesh.coords)}

    def trained(cfg, p, cp, **terms):
        # eight ranks share the card: AdamW updates one leaf at a time,
        # without its multi-tensor temporaries (a rank's whole state again)
        opt = dataclasses.replace(default_optimizer(), foreach=False)
        state = init_train_state(p, cp, opt, mesh=mesh)
        step = make_train_step(cfg, opt, mesh=mesh, sequence_parallel=True,
                               microbatches=TRAIN_PAR_MICRO, **terms)
        return state, step

    def whole(state):
        specs = training_specs(state.params, state.cp_params, mesh)
        trees = [gather_params(state.params, mesh, specs[0]),
                 gather_params(state.cp_params, mesh, specs[1])]
        return None if trees[0] is None else _host_leaves(trees)

    # tiny_f32: one step, then a checkpoint round trip into trees of other
    # values
    t0 = time.perf_counter()
    cfg = _train_par_tiny()
    state, step = trained(cfg, *shard_for_training(
        cfg, *copy.deepcopy(tiny_trees), mesh))
    state, m = step(state, batches["tiny"][0])
    tiny = {"metrics": {k: float(v) for k, v in m.items()},
            "leaves": whole(state)}
    path = save_train_state(state, ckpt_dir)
    _, m_cont = step(state, batches["tiny"][1])
    halves = [tree_map(lambda x: x * 0.5, t) for t in tiny_trees]
    fresh, _ = trained(cfg, *shard_for_training(cfg, *halves, mesh))
    restored = restore_train_state(path, fresh)
    tiny["restored_step"] = restored.step
    _, m_res = step(restored, batches["tiny"][1])
    tiny.update(loss_cont=float(m_cont["loss"]),
                loss_restored=float(m_res["loss"]),
                step_s=time.perf_counter() - t0)
    out["tiny_f32"] = tiny
    del state, restored, fresh

    # tiny_f32_anchor: one step with the anchor and distillation terms, the
    # frozen trees (other seeds) this rank's slices, placed as the state's
    t0 = time.perf_counter()
    frozen = shard_for_training(cfg, *copy.deepcopy(frozen_trees), mesh)
    state, step = trained(cfg, *shard_for_training(
        cfg, *copy.deepcopy(tiny_trees), mesh), anchor=frozen, distill=frozen,
        **TRAIN_PAR_TINY_TERMS)
    state, m = step(state, batches["tiny"][0])
    out["tiny_f32_anchor"] = {"metrics": {k: float(v) for k, v in m.items()},
                              "leaves": whole(state),
                              "step_s": time.perf_counter() - t0}
    del state, frozen

    # flagship_bf16: each rank draws the tree leaf by leaf on the card and
    # keeps its slice (no rank holds the whole talker)
    t0 = time.perf_counter()
    cfg = _train_par_flagship()
    validate_tp(cfg, mesh.tp)
    p = init_talker(cfg, 0, device=device,
                    keep=layer_keeper(mesh, cfg.talker.n_layers))
    cp = init_code_predictor(cfg, 1, device=device)
    state, step = trained(cfg, p, cp)
    del p, cp
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launch_counts()
    comm.reset_stats()
    steps = []
    for batch in batches["flagship"]:
        before = copy.deepcopy(comm.STATS)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        state, m = step(state, batch)
        metrics = {k: float(v) for k, v in m.items()}   # waits for the card
        torch.cuda.synchronize()
        steps.append({**metrics, "step_s": time.perf_counter() - ts,
                      "comm": _comm_delta(before, comm.STATS)})
    out["flagship_bf16"] = {
        "steps": steps, "init_s": init_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / GB,
        "resident_gb": torch.cuda.memory_allocated() / GB,
        "launches": {k.name: k.launches for k in cuda_kernels.KERNELS}}
    del state

    # flagship_bf16_anchor: one step of a fresh state with both terms, the
    # anchor and the teacher one frozen tree of other seeds (as finetune
    # freezes one copy), each rank's slices drawn as the state's
    torch.cuda.empty_cache()
    keep = layer_keeper(mesh, cfg.talker.n_layers)
    p = init_talker(cfg, 0, device=device, keep=keep)
    cp = init_code_predictor(cfg, 1, device=device)
    frozen = (init_talker(cfg, 2, device=device, keep=keep),
              init_code_predictor(cfg, 3, device=device))
    state, step = trained(cfg, p, cp, anchor=frozen, distill=frozen,
                          **TRAIN_PAR_FLAGSHIP_TERMS)
    del p, cp
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    comm.reset_stats()
    ts = time.perf_counter()
    state, m = step(state, batches["flagship"][0])
    metrics = {k: float(v) for k, v in m.items()}   # waits for the card
    torch.cuda.synchronize()
    out["flagship_bf16_anchor"] = {
        **metrics, "step_s": time.perf_counter() - ts,
        "comm": copy.deepcopy(comm.STATS),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / GB}
    return out


def train_parallel_finetune_rank(device, argv) -> dict:
    """One rank of phase ``train_parallel``'s step ``finetune``: its
    stdout (rank 0's holds the summary), finetune_step lines, launches."""
    import contextlib
    import io

    from qwen3_tts_tpu_torch import finetune
    from qwen3_tts_tpu_torch.ops import cuda_kernels

    cuda_kernels.reset_launch_counts()
    stdout, stderr = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
        rc = finetune.main(argv)
    if rc != 0:
        raise RuntimeError(f"finetune {argv}: exit {rc}: "
                           f"{stderr.getvalue()[-3000:]}")
    return {"stdout": stdout.getvalue(), "wall_s": time.perf_counter() - t0,
            "steps": [json.loads(ln) for ln in stderr.getvalue().splitlines()
                      if '"finetune_step"' in ln],
            "launches": {k.name: k.launches for k in cuda_kernels.KERNELS}}


def _one_rank_step(torch, cfg, p, cp, batch, leaves: bool = True,
                   **terms) -> tuple[dict, dict | None]:
    """One default_optimizer step of whole trees on their device (with the
    anchor and distillation ``terms`` of make_train_step): the metrics
    (and step seconds) and, with ``leaves``, the updated leaves on the
    host."""
    from qwen3_tts_tpu_torch.training import (
        default_optimizer, init_train_state, make_train_step)

    opt = default_optimizer()
    state = init_train_state(p, cp, opt)
    t0 = time.perf_counter()
    state, m = make_train_step(cfg, opt, **terms)(state, batch)
    metrics = {k: float(v) for k, v in m.items()}   # waits for the card
    metrics["step_s"] = time.perf_counter() - t0
    return metrics, (_host_leaves([state.params, state.cp_params])
                     if leaves else None)


def _close(got: float, want: float, rtol: float) -> bool:
    return math.isfinite(got) and abs(got - want) <= rtol * abs(want)


def _train_par_tiny_check(rk: dict, cpu: dict, cpu_leaves: dict,
                          step: str = "tiny_f32") -> dict:
    """Rank 0's tiny_f32 (or tiny_f32_anchor) step against the CPU's
    one-rank step."""
    got = rk[step]
    m = got["metrics"]
    keys = [("talker_loss", TRAIN_PAR_LOSS_RTOL),
            ("cp_loss", TRAIN_PAR_LOSS_RTOL), ("loss", TRAIN_PAR_LOSS_RTOL),
            ("grad_norm", TRAIN_PAR_NORM_RTOL)]
    if step == "tiny_f32_anchor":
        keys += [("anchor_pen", TRAIN_PAR_LOSS_RTOL),
                 ("distill_kl", TRAIN_PAR_LOSS_RTOL)]
    for key, rtol in keys:
        if not _close(m[key], cpu[key], rtol):
            fail(f"train_parallel {step}: {key} {m[key]} on 8 ranks vs "
                 f"{cpu[key]} on one CPU rank (rtol {rtol})")
    leaves = got["leaves"]
    if leaves.keys() != cpu_leaves.keys():
        fail(f"train_parallel {step}: the gathered trees differ in "
             "structure from the one-rank trees")
    worst, worst_leaf = 0.0, None
    for k, want in cpu_leaves.items():
        err = float((leaves[k] - want).abs().max())
        rel = err / max(float(want.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_leaf = rel, k
    if worst > TRAIN_PAR_LEAF_TOL:
        fail(f"train_parallel {step}: leaf {worst_leaf} off by {worst} of "
             f"its max (bound {TRAIN_PAR_LEAF_TOL})")
    row = {"loss": m["loss"], "cpu_loss": cpu["loss"],
           "grad_norm": m["grad_norm"], "cpu_grad_norm": cpu["grad_norm"],
           "loss_rtol": TRAIN_PAR_LOSS_RTOL,
           "norm_rtol": TRAIN_PAR_NORM_RTOL, "leaves": len(cpu_leaves),
           "worst_leaf_rel_err": worst, "worst_leaf": worst_leaf,
           "leaf_tol": TRAIN_PAR_LEAF_TOL, "step_s": got["step_s"]}
    if step == "tiny_f32_anchor":
        return {**row, **TRAIN_PAR_TINY_TERMS,
                **{k: m[k] for k in ("anchor_pen", "distill_kl")},
                **{f"cpu_{k}": cpu[k] for k in ("anchor_pen", "distill_kl")}}
    if got["restored_step"] != 1 or not _close(
            got["loss_restored"], got["loss_cont"], TRAIN_PAR_LOSS_RTOL):
        fail(f"train_parallel tiny_f32: restored step {got['restored_step']}"
             f", next loss {got['loss_restored']} vs uninterrupted "
             f"{got['loss_cont']}")
    return {**row,
            "ckpt_next_loss": [got["loss_cont"], got["loss_restored"]]}


def _comm_row(steps: list) -> dict:
    """Each collective kind's calls a step and host seconds (and card-wait
    seconds before them) in each step."""
    kinds = steps[0]["comm"]
    return {kind: {"calls": [s["comm"][kind]["calls"] for s in steps],
                   "host_s": [s["comm"][kind]["host_s"] for s in steps],
                   "sync_s": [s["comm"][kind]["sync_s"] for s in steps]}
            for kind in kinds}


def _bottleneck(step: dict) -> list:
    """[the largest share of a flagship step's seconds, the share]: each
    collective kind's host and card-wait seconds, or the rest (compute
    and its launches)."""
    spent = {kind: c["host_s"] + c["sync_s"] for kind, c in step["comm"].items()}
    spent["rest"] = max(step["step_s"] - sum(spent.values()), 0.0)
    first = max(spent, key=spent.get)
    return [first, spent[first] / step["step_s"]]


def phase_train_parallel(torch) -> dict:
    """Parallel training at pp2 dp2 tp2 + sp on one card (module docstring,
    phase 18). Returns the kernels' launches in the phase (both 0: training
    is dense)."""
    import copy
    import gc
    import shutil

    from qwen3_tts_tpu_torch.models.code_predictor import init_code_predictor
    from qwen3_tts_tpu_torch.models.talker import init_talker
    from qwen3_tts_tpu_torch.ops import cuda_kernels
    from qwen3_tts_tpu_torch.parallel import launch
    from qwen3_tts_tpu_torch.training.train import synthetic_batch

    t_phase = time.perf_counter()
    where = {"backend": PARALLEL_BACKEND, "device": PARALLEL_DEVICE,
             "ranks": TRAIN_PAR_RANKS,
             "mesh": dict(zip(("pp", "dp", "tp"), TRAIN_PAR_PLAN)),
             "sp": True, "microbatches": TRAIN_PAR_MICRO}
    cuda_kernels.reset_launch_counts()
    tiny_cfg, big_cfg = _train_par_tiny(), _train_par_flagship()
    batches = {"tiny": [synthetic_batch(tiny_cfg, *TRAIN_PAR_TINY_BATCH,
                                        seed=s) for s in (0, 1)],
               "flagship": [synthetic_batch(big_cfg,
                                            *TRAIN_PAR_FLAGSHIP_BATCH, seed=s)
                            for s in range(TRAIN_PAR_STEPS)]}
    # numpy draws on the host (the JAX package's values): the ranks and
    # the CPU reference start from copies of these trees
    tiny_trees = (init_talker(tiny_cfg, 0), init_code_predictor(tiny_cfg, 1))
    # the anchor and teacher trees of step tiny_f32_anchor (other seeds)
    frozen_trees = (init_talker(tiny_cfg, 5), init_code_predictor(tiny_cfg, 6))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # tiny CPU steps are op-overhead bound
    try:
        cpu, cpu_leaves = _one_rank_step(
            torch, tiny_cfg, *copy.deepcopy(tiny_trees), batches["tiny"][0])
        frozen = copy.deepcopy(frozen_trees)
        cpu_a, cpu_a_leaves = _one_rank_step(
            torch, tiny_cfg, *copy.deepcopy(tiny_trees), batches["tiny"][0],
            anchor=frozen, distill=frozen, **TRAIN_PAR_TINY_TERMS)
    finally:
        torch.set_num_threads(threads)
    # the flagship's one-rank steps on the card (plain, then with both
    # terms), freed before the ranks start
    torch.cuda.reset_peak_memory_stats()
    one, _ = _one_rank_step(torch, big_cfg,
                            init_talker(big_cfg, 0, device="cuda"),
                            init_code_predictor(big_cfg, 1, device="cuda"),
                            batches["flagship"][0], leaves=False)
    one["peak_mem_gb"] = torch.cuda.max_memory_allocated() / GB
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    frozen = (init_talker(big_cfg, 2, device="cuda"),
              init_code_predictor(big_cfg, 3, device="cuda"))
    one_a, _ = _one_rank_step(torch, big_cfg,
                              init_talker(big_cfg, 0, device="cuda"),
                              init_code_predictor(big_cfg, 1, device="cuda"),
                              batches["flagship"][0], leaves=False,
                              anchor=frozen, distill=frozen,
                              **TRAIN_PAR_FLAGSHIP_TERMS)
    one_a["peak_mem_gb"] = torch.cuda.max_memory_allocated() / GB
    del frozen
    gc.collect()
    torch.cuda.empty_cache()

    ckpt = tempfile.mkdtemp(prefix="q3tts_train_par_")
    # eight allocators share the card: segments that grow in place instead
    # of cached blocks of every size each rank once needed
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        t0 = time.perf_counter()
        ranks = launch(train_parallel_rank, TRAIN_PAR_RANKS,
                       backend=PARALLEL_BACKEND, device=PARALLEL_DEVICE,
                       args=(tiny_trees, frozen_trees, batches, ckpt))
        launch_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc

    row = _train_par_tiny_check(ranks[0], cpu, cpu_leaves)
    log({"phase": "train_parallel", "step": "tiny_f32", **where,
         "config": "tiny, float32", "batch": list(TRAIN_PAR_TINY_BATCH),
         **row})
    row = _train_par_tiny_check(ranks[0], cpu_a, cpu_a_leaves,
                                "tiny_f32_anchor")
    log({"phase": "train_parallel", "step": "tiny_f32_anchor", **where,
         "config": "tiny, float32", "batch": list(TRAIN_PAR_TINY_BATCH),
         **row})
    counts = {k.name: 0 for k in cuda_kernels.KERNELS}
    first = ranks[0]["flagship_bf16"]["steps"][0]
    for rk in ranks:
        run = rk["flagship_bf16"]
        losses = [s["loss"] for s in run["steps"]]
        if not all(math.isfinite(x) for x in losses):
            fail(f"train_parallel flagship_bf16 rank {rk['rank']}: losses "
                 f"{losses}")
        if run["steps"][0]["loss"] != first["loss"] or \
                run["steps"][0]["grad_norm"] != first["grad_norm"]:
            fail(f"train_parallel flagship_bf16 rank {rk['rank']}: metrics "
                 f"{run['steps'][0]} differ from rank 0's {first}")
        for name, n in run["launches"].items():
            counts[name] += n
        log({"phase": "train_parallel", "step": "flagship_bf16", **where,
             "rank": rk["rank"], "coords": rk["coords"],
             "config": "flagship, dense bf16",
             "batch": list(TRAIN_PAR_FLAGSHIP_BATCH),
             "s_per_step": [s["step_s"] for s in run["steps"]],
             "losses": losses,
             "grad_norms": [s["grad_norm"] for s in run["steps"]],
             "comm": _comm_row(run["steps"]),
             "bottleneck": [_bottleneck(s) for s in run["steps"]],
             "peak_mem_gb": run["peak_mem_gb"],
             "resident_gb": run["resident_gb"], "init_s": run["init_s"],
             "launches": run["launches"]})
    diffs = {k: abs(first[k] - one[k]) / abs(one[k])
             for k in ("loss", "grad_norm")}
    log({"phase": "train_parallel", "step": "flagship_bf16_vs_one_rank",
         **where, "loss": first["loss"], "one_rank_loss": one["loss"],
         "loss_rel_diff": diffs["loss"],
         "loss_rtol": TRAIN_PAR_BF16_LOSS_RTOL,
         "grad_norm": first["grad_norm"],
         "one_rank_grad_norm": one["grad_norm"],
         "grad_norm_rel_diff": diffs["grad_norm"],
         "norm_rtol": TRAIN_PAR_BF16_NORM_RTOL,
         "one_rank_step_s": one["step_s"],
         "one_rank_peak_mem_gb": one["peak_mem_gb"]})
    if diffs["loss"] > TRAIN_PAR_BF16_LOSS_RTOL or \
            diffs["grad_norm"] > TRAIN_PAR_BF16_NORM_RTOL:
        fail(f"train_parallel flagship_bf16: first step {first} vs one "
             f"rank {one}")
    anchored = [rk["flagship_bf16_anchor"] for rk in ranks]
    got = anchored[0]
    keys = ("loss", "grad_norm", "anchor_pen", "distill_kl")
    if any(not all(math.isfinite(a[k]) for k in keys) or a["loss"] != got["loss"]
           for a in anchored):
        fail(f"train_parallel flagship_bf16_anchor: {anchored}")
    diffs = {k: abs(got[k] - one_a[k]) / abs(one_a[k]) for k in keys}
    log({"phase": "train_parallel", "step": "flagship_bf16_anchor", **where,
         "config": "flagship, dense bf16", **TRAIN_PAR_FLAGSHIP_TERMS,
         "batch": list(TRAIN_PAR_FLAGSHIP_BATCH),
         **{k: got[k] for k in keys},
         **{f"one_rank_{k}": one_a[k] for k in keys},
         **{f"{k}_rel_diff": diffs[k] for k in keys},
         "loss_rtol": TRAIN_PAR_BF16_LOSS_RTOL,
         "norm_rtol": TRAIN_PAR_BF16_NORM_RTOL,
         "s_per_step": [a["step_s"] for a in anchored],
         "one_rank_step_s": one_a["step_s"],
         "comm": got["comm"], "peak_mem_gb": [a["peak_mem_gb"]
                                              for a in anchored],
         "one_rank_peak_mem_gb": one_a["peak_mem_gb"]})
    if diffs["loss"] > TRAIN_PAR_BF16_LOSS_RTOL or \
            diffs["grad_norm"] > TRAIN_PAR_BF16_NORM_RTOL:
        fail(f"train_parallel flagship_bf16_anchor: {got} vs one rank "
             f"{one_a}")
    _check_no_launches("train_parallel", counts)

    with tempfile.TemporaryDirectory(prefix="q3tts_train_par_ft_") as tmp:
        data = os.path.join(tmp, "data")
        export = os.path.join(tmp, "export")
        write_train_pairs(data)
        os.environ["QWEN3_TTS_METRICS"] = "1"
        t0 = time.perf_counter()
        try:
            ft = launch(train_parallel_finetune_rank, TRAIN_PAR_FT_RANKS,
                        backend=PARALLEL_BACKEND, device=PARALLEL_DEVICE,
                        args=(["--model", "synthetic", "--data", data,
                               "--steps", "2", "--batch-size", "4",
                               "--export", export],))
        finally:
            os.environ.pop("QWEN3_TTS_METRICS")
        ft_s = time.perf_counter() - t0
        summary = json.loads(ft[0]["stdout"].strip().splitlines()[-1])
        mesh_line = next((ln for ln in ft[0]["stdout"].splitlines()
                          if ln.startswith("fine-tune:")), "")
        for rk in ft:
            for name, n in rk["launches"].items():
                counts[name] += n
        if "mesh pp=1 dp=1 tp=2" not in mesh_line or not all(
                math.isfinite(x) for x in (summary["first_loss"],
                                           summary["final_loss"])):
            fail(f"train_parallel finetune: {mesh_line!r}, {summary}")
        row = _decode_export(torch, export, "train_parallel finetune")
    log({"phase": "train_parallel", "step": "finetune", **where,
         "ranks": TRAIN_PAR_FT_RANKS, "mesh": {"pp": 1, "dp": 1, "tp": 2},
         "model": "synthetic", "config": "flagship, dense bf16",
         "steps": len(ft[0]["steps"]),
         "s_per_step": [s["step_s"] for s in ft[0]["steps"]],
         "losses": [s["loss"] for s in ft[0]["steps"]],
         "finetune_wall_s": ft[0]["wall_s"], "launch_s": ft_s, **row,
         "launches": {k: sum(rk["launches"][k] for rk in ft)
                      for k in ft[0]["launches"]}})
    _check_no_launches("train_parallel", counts)
    log({"phase": "train_parallel", "step": "summary", **where,
         "launch_s": launch_s, "phase_s": time.perf_counter() - t_phase,
         "note": "no speed claimed: eight ranks share one card and every "
                 "collective goes through host memory"})
    return counts


if __name__ == "__main__":
    main()
