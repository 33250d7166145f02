#!/usr/bin/env python3
"""Time to first audio and RTF of the port's single-stream decode on one
NVIDIA GPU, three arms of the same code in one process, interleaved:

- ``serial``: the prompt through the eager assembly chain and
  ``pipeline_depth`` 1 (each chunk read before the next is dispatched:
  the order of the port's loop before the plan and the pipelining);
- ``plan``: the AssemblyPlan at ``pipeline_depth`` 1;
- ``pipelined``: the AssemblyPlan and ``pipeline_depth`` 2 (the default).

    python3 tools/ab_decode.py                 # both flagship paths
    python3 tools/ab_decode.py --rounds 4 --frames 64

Each model (grouped int8 layout, random weights from seed 0, bf16) runs
one warm call of ``frames`` frames, then ``rounds`` times the arms in the
order serial, plan, pipelined, pipelined, plan, serial. One JSON line per
call (ttfa_s, rtf, wall_s, assembly, assembly_ms), one summary line per
model (each arm's medians, and in how many adjacent serial/pipelined
pairs pipelined had the higher RTF), the card's name and power limit,
and a last line ``{"ok": true}``. Greedy codes of the arms must be
equal, or it fails.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

ARMS = {"serial": (False, 1), "plan": (True, 1),
        "pipelined": (True, 2)}                        # (plan, depth)
ORDER = ("serial", "plan", "pipelined", "pipelined", "plan", "serial")
MODELS = ("synthetic:flagship", "flagship_feedback_code2wav")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--frames", type=int, default=64)
    args = ap.parse_args()

    import os

    import numpy as np
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    chip_smoke.phase_build()
    os.environ["QWEN3_TTS_INT8_LAYOUT"] = "grouped"

    from qwen3_tts_tpu_torch.engine import generate_audio
    from qwen3_tts_tpu_torch.runtime.prompts import build_prompt
    from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig

    for label in MODELS:
        model = chip_smoke._build(label)
        gen = model.generator
        runs: dict = {arm: [] for arm in ARMS}
        order = []
        with tempfile.TemporaryDirectory() as out:
            # warm at full length: the allocator's blocks for every chunk
            generate_audio(model=model, text=chip_smoke.TEXT, voice="ryan",
                           output_path=out, max_frames=args.frames, seed=1)
            for _ in range(args.rounds):
                for arm in ORDER:
                    order.append(arm)
                    gen._fast_assembly, gen.pipeline_depth = ARMS[arm]
                    torch.cuda.synchronize()
                    m = generate_audio(model=model, text=chip_smoke.TEXT,
                                       voice="ryan", output_path=out,
                                       max_frames=args.frames, seed=0)
                    row = {"ttfa_s": m["ttfa_s"], "rtf": m["rtf"],
                           "wall_s": m["wall_s"], "frames": m["frames"],
                           **gen.last_assembly}
                    runs[arm].append(row)
                    chip_smoke.log({"tool": "ab_decode", "model": label,
                                    "arm": arm, **row})
        # the arms' greedy codes must agree
        prompt = build_prompt(model.tokenizer, model.cfg.mode,
                              chip_smoke.TEXT, voice="ryan",
                              speakers=model.cfg.speakers)
        sampling, gen.sampling = gen.sampling, SamplingConfig(greedy=True)
        codes = {}
        for arm, (plan, depth) in ARMS.items():
            gen._fast_assembly, gen.pipeline_depth = plan, depth
            codes[arm] = gen.synthesize(prompt, max_frames=args.frames,
                                        collect_codes=True).codes
        gen.sampling = sampling
        gen._fast_assembly, gen.pipeline_depth = True, 2
        if any(not np.array_equal(c, codes["serial"])
               for c in codes.values()):
            chip_smoke.fail(f"{label}: the arms' greedy codes differ")
        # (serial, pipelined) pairs of a round (serial, plan, pipelined,
        # pipelined, plan, serial): calls 0 and 2, calls 5 and 3
        rtf = {arm: iter(r["rtf"] for r in rows) for arm, rows in runs.items()}
        seq = [next(rtf[arm]) for arm in order]
        pairs = [(seq[i + a], seq[i + b]) for i in range(0, len(seq), 6)
                 for a, b in ((0, 2), (5, 3))]
        chip_smoke.log({
            "tool": "ab_decode", "model": label, "summary": True,
            "frames": args.frames, "rounds": args.rounds,
            "greedy_codes_equal": True,
            "pipelined_rtf_higher_in_pairs": [
                sum(p > s for s, p in pairs), len(pairs)],
            **{f"{arm}_{key}_median": statistics.median(r[key] for r in rows)
               for arm, rows in runs.items()
               for key in ("ttfa_s", "rtf", "assembly_ms")}})
        del model, gen
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True}), flush=True)


if __name__ == "__main__":
    main()
