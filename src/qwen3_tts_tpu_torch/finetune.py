"""Fine-tuning CLI: adapt a model to a directory of (wav, txt) pairs (the
JAX package's finetune.py).

Takes the voice-library layout the app already produces (``<name>.wav`` +
``<name>.txt`` pairs, voices.py) and fine-tunes the talker + code
predictor on it (full fine-tune or LoRA), with checkpoint/resume and a
native-format export that ``load_model`` serves directly (either
package's).

Run as::

    python -m qwen3_tts_tpu_torch.finetune --model <ckpt> --data voices/ \\
        --steps 200 --batch-size 8 --export out_model/
    # LoRA voice adaptation (adapter-sized grads/moments, exact merge):
    python -m qwen3_tts_tpu_torch.finetune --model <ckpt> --data voices/ \\
        --lora 8 --steps 200 --export out_model/

It trains on the CUDA device, or on the CPU with QWEN3_TTS_CPU=1.
Batches bucket by (text, frame) length (training/data.py ladders;
examples are length-sorted before grouping so padding waste stays low),
and a trailing incomplete batch is dropped. QWEN3_TTS_METRICS=1 prints
one ``finetune_step`` JSON line a step on stderr (loss, grad norm,
seconds, real frames; on the card the memory allocated after the step).

Across ranks: under an initialised process group (``parallel.comm.
launch``) every rank runs ``main`` with the same arguments, and the mesh
spans the world as the JAX CLI's spans its devices: ``--pp`` stages, then
``auto_plan`` of the rest (tp up to the kv-head count, dp the remainder).
Each rank trains on ``torch.cuda.current_device()`` (the CPU under
QWEN3_TTS_CPU=1) and takes its dp rows of every batch; rank 0 alone
logs, saves (the gathered checkpoint) and exports. Under ``torchrun``
(``WORLD_SIZE`` > 1) ``main`` initialises the group from the environment
with the backend ``--backend`` names, which is then required (the JAX CLI
has no such flag: XLA picks its transport)::

    torchrun --nproc-per-node 8 -m qwen3_tts_tpu_torch.finetune \\
        --model <ckpt> --data voices/ --pp 2 --sequence-parallel \\
        --backend nccl
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
import warnings
from typing import Any

import numpy as np


def load_pairs(data_dir: str) -> list[tuple[str, np.ndarray, int]]:
    """Collect (text, wav, rate) pairs from ``<name>.wav``+``<name>.txt``
    files (the voice-library layout, voices.py). WAVs without a transcript
    are skipped with a warning: silent inclusion with empty text would
    teach the model to speak unprompted."""
    from .audio import read_wav, to_mono

    pairs = []
    skipped = []
    for f in sorted(os.listdir(data_dir)):
        if not f.lower().endswith(".wav") or f.startswith("."):
            continue
        name = os.path.splitext(f)[0]
        txt = os.path.join(data_dir, name + ".txt")
        if not os.path.exists(txt):
            skipped.append(name)
            continue
        with open(txt, encoding="utf-8", errors="replace") as fh:
            text = fh.read().strip()
        if not text or text == ".":
            skipped.append(name)
            continue
        data, rate = read_wav(os.path.join(data_dir, f))
        mono = to_mono(data)
        if mono.dtype.kind in "iu":
            mono = mono.astype(np.float32) / 32768.0
        pairs.append((text, mono.astype(np.float32), rate))
    if skipped:
        warnings.warn(
            f"skipped {len(skipped)} wav(s) without a usable transcript: "
            f"{skipped[:5]}{'...' if len(skipped) > 5 else ''}"
        )
    return pairs


def apply_decode_extensions(model, *, fps: int = 0, depth_group: int = 0,
                            mtp_cp_batch: bool = False, spec: bool = False,
                            seed: int = 0):
    """Enable the decode fine-tune extensions on a loaded model.

    Real checkpoints decode one frame per talker pass and one residual
    codebook per code-predictor pass; the training stack teacher-forces
    the architectural extensions that speed decode up:

    - ``fps > 1``: multi-token prediction. Grafts fresh MTP heads
      (models.talker.add_mtp_params, drawn on the host as the JAX package
      draws them, then placed on the model's device) when the tree lacks
      them; the heads are random until trained.
    - ``depth_group > 1``: grouped depth prediction. Config-only (the
      published per-depth heads/tables are re-indexed), but the layout
      changes, so fine-tune before serving.
    - ``mtp_cp_batch`` (needs fps > 1): the batched-cp MTP chain, which
      conditions on cb0 embeddings alone so decode predicts all fps
      frames' residuals in one batched cp pass. Config-only.
    - ``spec`` (needs depth_group > 1): lossless speculative depth decode.
      The grouped heads become a draft verified by one teacher-forced
      full-depth pass per round; the exported model's greedy output stays
      the dg=1 chain's exactly.

    Returns a rebuilt model (no cached generator or serving engine);
    raises ValueError for invalid geometry (e.g. depth_group not dividing
    the residual count)."""
    from .engine.configs import with_frames_per_step

    cfg, params = model.cfg, model.params
    if fps > 1:
        cfg = with_frames_per_step(cfg, fps)
        if "mtp" not in params:
            from .engine.weights import tree_to
            from .models.talker import add_mtp_params

            params = add_mtp_params(params, cfg, seed=seed)
            params = {**params, "mtp": tree_to(params["mtp"], model.device)}
    if mtp_cp_batch:
        if fps <= 1 and cfg.talker.frames_per_step <= 1:
            raise ValueError(
                "--mtp-cp-batch needs frames_per_step > 1 (--mtp-fps N): "
                "there is nothing to batch at one frame per pass"
            )
        cfg = dataclasses.replace(
            cfg, talker=dataclasses.replace(cfg.talker, mtp_cp_batch=True)
        )
    if depth_group > 1:
        cfg = dataclasses.replace(
            cfg,
            code_predictor=dataclasses.replace(
                cfg.code_predictor, depth_group=depth_group
            ),
        )
    if spec:
        if cfg.code_predictor.depth_group <= 1:
            raise ValueError(
                "--spec needs a grouped draft (--depth-group K > 1): "
                "speculative depth decode drafts with the grouped heads "
                "and verifies against the full-depth pass"
            )
        cfg = dataclasses.replace(
            cfg,
            code_predictor=dataclasses.replace(
                cfg.code_predictor, spec_decode=True
            ),
        )
    return dataclasses.replace(model, cfg=cfg, params=params,
                               _generator=None, _serving=None)


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="qwen3-tts fine-tuning on PyTorch (full or LoRA)"
    )
    ap.add_argument("--model", default="synthetic-tiny",
                    help="checkpoint path, or 'synthetic'/'synthetic-tiny'/"
                    "'synthetic-tiny-feedback' (the published-protocol "
                    "tiny — the shape real imported checkpoints run)")
    ap.add_argument("--mode", default="custom",
                    choices=["custom", "design", "base"])
    ap.add_argument("--data", required=True,
                    help="directory of <name>.wav + <name>.txt pairs")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--lora", type=int, default=0, metavar="RANK",
                    help="LoRA rank (0 = full fine-tune)")
    ap.add_argument("--pp", type=int, default=1, metavar="STAGES",
                    help="pipeline-parallel stages (full fine-tune only); "
                    "must divide the rank count and n_layers")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="pipeline microbatches (default 4*pp); the batch "
                    "size must divide by it")
    ap.add_argument("--sequence-parallel", action="store_true",
                    help="shard the residual stream along T over tp between "
                    "talker blocks (needs tp > 1; full fine-tune only)")
    ap.add_argument("--mtp-fps", type=int, default=0, metavar="N",
                    help="enable multi-token prediction at N frames per "
                    "talker pass before training (grafts fresh MTP heads "
                    "onto checkpoints that lack them); the exported model "
                    "decodes at fps=N")
    ap.add_argument("--depth-group", type=int, default=0, metavar="K",
                    help="enable grouped depth prediction (K residual "
                    "codebooks per code-predictor pass) before training — "
                    "no new parameters, config + fine-tune only")
    ap.add_argument("--spec", action="store_true",
                    help="with --depth-group K: export with lossless "
                    "speculative depth decode enabled — the grouped heads "
                    "draft, one teacher-forced full-depth pass verifies, "
                    "output stays the dg=1 greedy chain's exactly")
    ap.add_argument("--mtp-cp-batch", action="store_true",
                    help="with --mtp-fps N: condition the MTP chain on cb0 "
                    "embeddings alone so decode batches all N frames' "
                    "code-predictor passes into one; config-only, trained "
                    "by the same fine-tune")
    ap.add_argument("--anchor", type=float, default=0.0, metavar="W",
                    help="L2-SP anchored recovery: add W * mean||theta - "
                    "theta0||^2 to the loss (theta0 = the pre-fine-tune "
                    "weights; freshly-grafted MTP params move freely). "
                    "Holds a second copy of the params; full fine-tune only")
    ap.add_argument("--freeze-base", action="store_true",
                    help="strict recovery: train ONLY the recovery "
                    "parameters — the grafted MTP chain (--mtp-fps) and a "
                    "grafted DRAFT copy of the code predictor that the "
                    "grouped layout reads (--depth-group). The base "
                    "weights never move, so the exported model's "
                    "fps=1/dg=1 decode — and the --spec verifier — stay "
                    "bit-identical to the input checkpoint")
    ap.add_argument("--distill", type=float, default=0.0, metavar="W",
                    help="function-space anchored recovery: add W * "
                    "KL(frozen pre-fine-tune model || student) on the "
                    "sequential fps=1/dg=1 teacher-forced path (talker + "
                    "code predictor). Costs two extra teacher-forced "
                    "forwards per step; full fine-tune only")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="process-group backend under torchrun (required "
                    "when WORLD_SIZE > 1; nccl: one card a rank)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (enables save/resume)")
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint in --ckpt-dir")
    ap.add_argument("--export", default=None,
                    help="write the tuned model (native format) here; "
                    "LoRA deltas are merged exactly before export")
    ap.add_argument("--eval-quality", action="store_true",
                    help="post-train decode-quality eval (quality.py): "
                    "synthesize held texts at the trained decode shape "
                    "(--mtp-fps/--depth-group) AND the fps=1/dg=1 baseline "
                    "of the same tuned weights, ASR both, report the WER "
                    "delta in the summary BEFORE native export; a delta "
                    "past --eval-max-wer-delta exports with a loud warning "
                    "and exits non-zero")
    ap.add_argument("--eval-max-wer-delta", type=float, default=0.02)
    ap.add_argument("--eval-texts", type=int, default=4,
                    help="how many training transcripts to evaluate on")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    cpu = os.environ.get("QWEN3_TTS_CPU", "0") not in ("", "0")
    own_group = False
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        if args.backend is None:
            print("error: --backend {nccl,gloo} is required when WORLD_SIZE "
                  "> 1 (torchrun): the process group's backend is never "
                  "guessed", file=sys.stderr)
            return 1
        if not cpu:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(args.backend)
        own_group = True
    elif dist.is_initialized() and args.backend not in (None,
                                                        dist.get_backend()):
        print(f"error: --backend {args.backend}, but the process group "
              f"runs {dist.get_backend()}", file=sys.stderr)
        return 1
    try:
        return _main(args, cpu)
    finally:
        if own_group:
            dist.destroy_process_group()


def _main(args, cpu: bool) -> int:
    import torch
    import torch.distributed as dist

    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    rank0 = n_dev == 1 or dist.get_rank() == 0
    device = "cpu" if cpu else (
        "cuda" if n_dev == 1 else f"cuda:{torch.cuda.current_device()}")

    def say(*a, **kw) -> None:
        if rank0:
            print(*a, **kw)

    from .engine import configs
    from .engine.api import Qwen3TTSModel, load_model
    from .engine.weights import flatten_tree
    from .profiling import emit_metrics, metrics_enabled
    from .training import (
        default_optimizer,
        init_train_state,
        make_train_step,
    )
    from .training.checkpoint import (
        latest_checkpoint,
        restore_train_state,
        save_train_state,
    )
    from .parallel.sharding import (
        gather_params,
        shard_for_training,
        training_specs,
    )
    from .training.data import batches_from_pairs
    from .training.train import clone_tree, freeze_tree

    if args.model == "synthetic":
        # trainable synthetics are dense (the quant guard below explains)
        model = Qwen3TTSModel.synthetic(
            configs.with_quant(configs.flagship(args.mode), False),
            device=device)
    elif args.model == "synthetic-tiny":
        model = Qwen3TTSModel.synthetic(configs.tiny(args.mode), device=device)
    elif args.model == "synthetic-tiny-feedback":
        # the published decode protocol (residual-sum feedback, cp-in-loop)
        # at tiny size: the offline stand-in for the shape real checkpoints
        # run
        model = Qwen3TTSModel.synthetic(configs.tiny_feedback(args.mode),
                                        device=device)
    else:
        model = load_model(args.model, device=device)
    if (args.mtp_fps > 1 or args.depth_group > 1 or args.mtp_cp_batch
            or args.spec):
        try:
            model = apply_decode_extensions(
                model, fps=args.mtp_fps, depth_group=args.depth_group,
                mtp_cp_batch=args.mtp_cp_batch, spec=args.spec,
                seed=args.seed,
            )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    if args.freeze_base:
        if args.lora:
            print("error: --freeze-base is the full-fine-tune sibling of "
                  "LoRA-style adaptation; use one or the other",
                  file=sys.stderr)
            return 1
        if args.anchor > 0.0 or args.distill > 0.0:
            print("error: --anchor/--distill are pointless under "
                  "--freeze-base — the base weights they anchor cannot "
                  "move (their updates are masked to zero), so --distill "
                  "only burns two teacher-forced forwards per step and "
                  "--anchor actively penalises the draft's distance from "
                  "its own grafted init (the one thing the mode trains)",
                  file=sys.stderr)
            return 1
        if args.mtp_fps <= 1 and args.depth_group <= 1:
            print("error: --freeze-base trains ONLY the recovery params "
                  "(MTP chain / grouped draft) — it needs --mtp-fps N "
                  "and/or --depth-group K", file=sys.stderr)
            return 1
        if args.depth_group > 1 and "draft" not in model.cp_params:
            # graft the draft adapter: a full copy of the cp module that
            # the grouped layout (and the spec draft) reads while the
            # primary tree (sequential decode and the spec verifier)
            # stays bit-identical to the raw import
            model.cp_params = {
                **model.cp_params,
                "draft": clone_tree({k: v for k, v in model.cp_params.items()
                                     if k != "draft"}),
            }
    cfg = model.cfg
    if cfg.quant.enabled and all(
            leaf.is_floating_point() for leaf in
            flatten_tree([model.params, model.cp_params]).values()):
        # a quantized checkpoint loaded with QWEN3_TTS_COMPUTE=bf16: no
        # int8 codes are left in its trees, so it trains (and exports) as
        # a dense model
        cfg = configs.with_quant(cfg, False)
        model.cfg = cfg
    if cfg.quant.enabled:
        print("error: fine-tuning needs an unquantized base "
              "(QWEN3_TTS_COMPUTE=bf16 import, or a native bf16 export)",
              file=sys.stderr)
        return 1

    if args.lora and (args.pp > 1 or args.sequence_parallel):
        print("error: --pp/--sequence-parallel apply to the full fine-tune "
              "path only (LoRA's adapter-sized step has no layer pipeline)",
              file=sys.stderr)
        return 1
    if args.lora and (args.anchor > 0.0 or args.distill > 0.0):
        print("error: --anchor/--distill apply to the full fine-tune path "
              "only (LoRA already anchors implicitly — the base is frozen)",
              file=sys.stderr)
        return 1
    if args.pp < 1:
        print(f"error: --pp {args.pp} must be >= 1", file=sys.stderr)
        return 1
    if args.microbatches and args.pp <= 1:
        print("error: --microbatches only applies with --pp > 1 (the "
              "pipeline schedule is what consumes microbatches)",
              file=sys.stderr)
        return 1
    if args.pp > 1 and (n_dev % args.pp or cfg.talker.n_layers % args.pp):
        print(f"error: --pp {args.pp} must divide both the device count "
              f"({n_dev}) and n_layers ({cfg.talker.n_layers})",
              file=sys.stderr)
        return 1
    from .parallel.mesh import MeshPlan, auto_plan, build_mesh

    inner = auto_plan(n_dev // args.pp, tp_divisors=cfg.talker.n_kv_heads)
    plan = MeshPlan(dp=inner.dp, tp=inner.tp, pp=args.pp)
    microbatches = (args.microbatches or 4 * plan.pp) if plan.pp > 1 else 0
    if args.batch_size % plan.dp:
        print(f"error: --batch-size {args.batch_size} must divide "
              f"dp={plan.dp}", file=sys.stderr)
        return 1
    if microbatches and args.batch_size % microbatches:
        print(f"error: --batch-size {args.batch_size} must divide into "
              f"--microbatches {microbatches}", file=sys.stderr)
        return 1
    if args.sequence_parallel and plan.tp <= 1:
        print(f"error: --sequence-parallel needs tp > 1 (mesh has "
              f"tp={plan.tp})", file=sys.stderr)
        return 1
    mesh = build_mesh(plan, device) if n_dev > 1 else None

    pairs = load_pairs(args.data)
    if not pairs:
        print(f"error: no usable (wav, txt) pairs in {args.data}",
              file=sys.stderr)
        return 1
    batches = [
        b for b in batches_from_pairs(
            model, pairs, batch_size=args.batch_size,
            shuffle_seed=args.seed,
        )
        if b["text_tokens"].shape[0] == args.batch_size
    ]
    if not batches:
        print("error: dataset smaller than one batch; lower --batch-size",
              file=sys.stderr)
        return 1

    say(f"fine-tune: {len(pairs)} pairs, {len(batches)} batches/epoch, "
        f"mesh pp={plan.pp} dp={plan.dp} tp={plan.tp}"
        f"{' sp' if args.sequence_parallel else ''}, "
        f"{'LoRA r=%d' % args.lora if args.lora else 'full'}")

    opt = default_optimizer(lr=args.lr)
    if args.freeze_base:
        # updates (and the clip's norm) cover only the recovery subtrees:
        # the optimizer holds the mtp/draft leaves alone, and no other
        # leaf gets a gradient
        opt = dataclasses.replace(opt, trainable=(("mtp",), ("draft",)))
    t0 = time.perf_counter()
    losses: list[float] = []
    saved_at = -1

    def save(state) -> None:
        nonlocal saved_at
        if int(state.step) != saved_at:
            save_train_state(state, args.ckpt_dir)
            saved_at = int(state.step)

    def run(step_fn, state, *extra) -> None:
        for i in range(int(state.step), args.steps):
            batch = batches[i % len(batches)]
            ts = time.perf_counter()
            state, metrics = step_fn(state, *extra, batch)
            losses.append(float(metrics["loss"]))    # waits for the step
            if metrics_enabled() and rank0:
                line = {
                    "step": i + 1, "loss": losses[-1],
                    "grad_norm": float(metrics["grad_norm"]),
                    "step_s": time.perf_counter() - ts,
                    "frames": int(np.asarray(batch["frame_mask"]).sum()),
                }
                if model.device.type == "cuda":
                    # resident after the step: weights and moments
                    line["allocated_gb"] = torch.cuda.memory_allocated() / 1e9
                emit_metrics("finetune_step", line)
            if (i + 1) % 10 == 0 or i + 1 == args.steps:
                say(f"step {i + 1}/{args.steps}: loss={losses[-1]:.4f}")
            if args.ckpt_dir and (i + 1) % args.save_every == 0:
                save(state)
        if args.ckpt_dir:
            save(state)

    if args.lora:
        from .training import (
            add_lora,
            init_lora_train_state,
            make_lora_train_step,
            merge_lora,
            merge_trees,
            split_lora,
        )

        lora, base = split_lora(
            add_lora(model.params, rank=args.lora, seed=args.seed)
        )
        cp_params = model.cp_params
        if mesh is not None:   # adapters drawn on the whole tree, then cut
            from .parallel.sharding import shard_params, talker_param_spec

            lora = shard_params(lora, mesh, talker_param_spec(lora))
            base = shard_params(base, mesh)
            cp_params = shard_params(cp_params, mesh, training_specs(
                model.params, cp_params, mesh)[1])
            model.params = model.cp_params = None   # the whole trees go
        state = init_lora_train_state(lora, opt, mesh=mesh)
        lstep = make_lora_train_step(cfg, opt, mesh=mesh)
        if args.resume and args.ckpt_dir:
            path = latest_checkpoint(args.ckpt_dir)
            if path:
                state = restore_train_state(path, state)
                say(f"resumed LoRA state from {path}")
        run(lstep, state, base, cp_params)
        final_params = merge_lora(merge_trees(base, state.lora))
        final_cp = cp_params
    else:
        params, cp_params = model.params, model.cp_params
        if mesh is not None:
            params, cp_params = shard_for_training(cfg, params, cp_params,
                                                   mesh)
            model.params = model.cp_params = None   # the whole trees go
        anchor = distill = None
        if args.anchor > 0.0 or args.distill > 0.0:
            # fresh buffers of this rank's slices: the train step updates
            # state.params in place, so the frozen reference must not alias
            # the trees it trains
            frozen = (clone_tree(params), clone_tree(cp_params))
            anchor = frozen if args.anchor > 0.0 else None
            distill = frozen if args.distill > 0.0 else None
        state = init_train_state(params, cp_params, opt, mesh=mesh)
        step = make_train_step(
            cfg, opt, anchor=anchor, anchor_weight=args.anchor,
            distill=distill, distill_weight=args.distill, mesh=mesh,
            microbatches=microbatches,
            sequence_parallel=args.sequence_parallel,
        )
        if args.resume and args.ckpt_dir:
            path = latest_checkpoint(args.ckpt_dir)
            if path:
                state = restore_train_state(path, state)
                say(f"resumed from {path}")
        run(step, state)
        final_params, final_cp = state.params, state.cp_params
    del state  # the optimizer's moments
    if mesh is not None:   # the whole trees, on rank 0 alone
        specs = training_specs(final_params, final_cp, mesh)
        final_params = gather_params(final_params, mesh, specs[0])
        final_cp = gather_params(final_cp, mesh, specs[1])
        if not rank0:
            return 0

    summary: dict[str, Any] = {
        "steps": args.steps,
        "first_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "wall_seconds": round(time.perf_counter() - t0, 1),
    }
    # hand the tuned trees to the model, with no autograd flags left on
    # them, and drop its decode-layout copies of the weights as they were
    # before training
    model.params = freeze_tree(final_params)
    model.cp_params = freeze_tree(final_cp)
    model._generator = None
    model._serving = None

    gate_ok = True
    if args.eval_quality:
        from . import transcription
        from .quality import compare_decode_configs

        transcribe = (
            transcription.transcribe_wav
            if transcription.asr_available() else None
        )
        fps = max(1, args.mtp_fps or cfg.talker.frames_per_step)
        dg = max(1, args.depth_group or cfg.code_predictor.depth_group)
        spec = cfg.code_predictor.spec_decode
        texts = [t for t, _, _ in pairs[: args.eval_texts]]
        voice = "ryan" if args.mode == "custom" else None
        variant: dict[str, Any] = {"fps": fps, "dg": dg}
        if spec:
            variant["spec"] = True
        rep = compare_decode_configs(
            model,
            {"trained_shape": variant},
            texts,
            transcribe,
            voice=voice,
        )
        v = rep["variants"]["trained_shape"]
        summary["quality"] = {
            "decode_shape": {"fps": fps, "depth_group": dg, "spec": spec,
                             "mtp_cp_batch": cfg.talker.mtp_cp_batch},
            "median_wer_delta": v["median_wer_delta"],
            "median_mel_dist": v["median_mel_dist"],
            "median_identical_frac": v["median_identical_frac"],
            "asr": transcribe is not None,
            "texts": len(texts),
        }
        if v["median_wer_delta"] is None:
            warnings.warn(
                "quality eval ran without an ASR provider: WER delta "
                "unmeasured (register one or install a local Whisper "
                "checkpoint — transcription.py)"
            )
        elif v["median_wer_delta"] > args.eval_max_wer_delta:
            gate_ok = False
            warnings.warn(
                f"quality gate FAILED: decoding at fps={fps}/dg={dg} costs "
                f"{v['median_wer_delta']:+.4f} median WER vs the fps=1/dg=1 "
                f"baseline of the same weights (budget "
                f"{args.eval_max_wer_delta}); exporting anyway — do not "
                "serve this shape without listening checks"
            )
        summary["quality"]["pass"] = (
            None if v["median_wer_delta"] is None else gate_ok
        )

    if args.export:
        from .engine.weights import save_model

        save_model(model, args.export)
        summary["exported"] = args.export
    print(json.dumps(summary))
    return 0 if gate_ok else 3


if __name__ == "__main__":
    raise SystemExit(main())
