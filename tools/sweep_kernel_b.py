#!/usr/bin/env python3
"""Kernel B of the PyTorch/CUDA port (``csrc/dequant_matmul.cu``) at every
flagship (N, K) and row count, timed at the split of K that
``plan_kernel_b`` picks and at others, on one NVIDIA GPU: the measurement
behind the plan's constants.

    python3 tools/sweep_kernel_b.py [--rows 1,8,24,32,128]

One JSON line per (M, N, K, splits): kernel time, bound and error against
the plain version; then one line per shape comparing the plan's split with
the fastest one measured. Timing as ``chip_smoke.py``'s kernel phase.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SPLITS = (1, 2, 3, 4, 5, 6, 8, 9, 10, 11, 12, 16, 17, 21, 24, 32)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default="1,8,24,32,128")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from qwen3_tts_tpu_torch.ops.cuda_kernels import DEQUANT_MATMUL
    from qwen3_tts_tpu_torch.ops.dequant_matmul import (
        SB_GROUPS_MAX, _scratch, plan_kernel_b, quantized_matmul_ref,
    )

    if not torch.cuda.is_available():
        cs.fail("this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fn = DEQUANT_MATMUL.load()
    gen = torch.Generator(device=dev).manual_seed(0)
    for n, k in cs.FLAGSHIP_NK:
        for m in map(int, args.rows.split(",")):
            gs = cs.GS
            plan = plan_kernel_b(m, n, k, gs, sms)
            units = k // plan.k_unit
            x = torch.randn((m, k), generator=gen, device=dev)
            x = x.to(torch.bfloat16)
            copies = max(1, min(32, math.ceil(128e6 / (n * k * 1.125))))
            sets = [(x, *cs._weights(torch, n, k, gs, gen, dev))
                    for _ in range(copies)]
            want = quantized_matmul_ref(*sets[0]).float()
            times = {}
            for s in sorted({plan.k_splits, *SPLITS}):
                groups = -(-units // s) * (plan.k_unit // gs)
                if s > units or groups > SB_GROUPS_MAX:
                    continue
                tiles = plan.blocks // plan.k_splits
                need = plan._replace(
                    k_splits=s, counters=tiles,
                    workspace_floats=s * tiles * plan.tile_m * 64)
                stream = torch.cuda.current_stream(dev).cuda_stream
                ws, cnt = _scratch(dev, stream, need)

                def run(x, q, sc, b, s=s, groups=groups, ws=ws, cnt=cnt):
                    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
                    rc = fn(x.data_ptr(), q.data_ptr(), sc.data_ptr(),
                            b.data_ptr(), out.data_ptr(), ws.data_ptr(),
                            cnt.data_ptr(), m, k, n, gs, plan.m_frags, s,
                            plan.k_unit, groups, stream)
                    if rc:
                        cs.fail(f"launch failed: cudaError {rc}")
                    return out

                err = (run(*sets[0]).float() - want).abs().max().item()
                if not err <= cs.TOL * want.abs().max().item():
                    cs.fail(f"M={m} N={n} K={k} splits={s}: error {err}")
                times[s] = cs.device_time_ms(torch, run, sets)
                cs.log({"M": m, "N": n, "K": k, "splits": s,
                        "kernel_ms": times[s],
                        "bound_ms": cs.bound_ms(m, n, k, gs)[0],
                        "max_abs_err": err})
            best = min(times, key=times.get)
            cs.log({"M": m, "N": n, "K": k, "plan_splits": plan.k_splits,
                    "plan_ms": times[plan.k_splits], "best_splits": best,
                    "best_ms": times[best]})
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
