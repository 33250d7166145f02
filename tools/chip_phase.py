#!/usr/bin/env python3
"""One phase of ``chip_smoke.py`` alone on one NVIDIA GPU: phase ``build``,
then the named phase, with the script's float rules.

    python3 tools/chip_phase.py parallel
    python3 tools/chip_phase.py train_parallel

``parallel`` runs ``phase_parallel`` with no kernel shape checked before
it (so it holds every kernel B shape of its ranks against the plain
version, the float32 steps' at float32) and prints its launches (the
float32 instances' apart), shapes and seconds. ``train_parallel``
runs ``phase_train_parallel`` (eight training ranks on the card) and
prints its launches (both 0) and seconds.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("phase", choices=("parallel", "train_parallel"))
    args = ap.parse_args()

    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    chip_smoke.phase_build()
    t0 = time.perf_counter()
    if args.phase == "train_parallel":
        counts = chip_smoke.phase_train_parallel(torch)
        chip_smoke.log({"phase": "train_parallel", "step": "alone",
                        "launches": counts,
                        "phase_s": time.perf_counter() - t0})
        return
    counts, shapes, f32_counts = chip_smoke.phase_parallel(torch, {}, {})
    chip_smoke.log({"phase": "parallel", "step": "alone", "launches": counts,
                    "f32_launches": f32_counts,
                    "shapes": {k: len(v) for k, v in shapes.items()},
                    "phase_s": time.perf_counter() - t0})


if __name__ == "__main__":
    main()
