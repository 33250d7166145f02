#!/usr/bin/env python3
"""Kernel B of the PyTorch/CUDA port (``csrc/dequant_matmul.cu``) at every
flagship (N, K) and row count, timed at the split of K that
``plan_kernel_b`` picks and at others, on one NVIDIA GPU: the measurement
behind the plan's constants.

    python3 tools/sweep_kernel_b.py [--rows 1,8,24,32,128] [--f32]
        [--shapes 6144x2048,3072x2048] [--splits 1,2,4,8]
        [--variant 'NAME:old=>new@@old2=>new2' ...]

Each ``--variant`` builds a copy of dequant_matmul.cu with the text
replaced (as tools/sweep_kernel_a.py's) and times it after the committed
source ("base") in the same process.

``--f32`` times the float32 instance (float32 x and out, the f32 ring as
``plan_kernel_b_f32`` plans it, its bound at the float32 CUDA-core rate,
error within chip_smoke.TOL_F32) and, for each shape, one full-f32
``torch.matmul`` on a dense float32 weight of that shape (cuBLAS, TF32
off): the f32 FMA rate a library reaches there. One JSON line per (M, N,
K, splits): kernel time, bound and error against the plain version; then
one line per shape comparing the plan's split with the fastest one
measured. Timing as ``chip_smoke.py``'s kernel phase.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SPLITS = (1, 2, 3, 4, 5, 6, 8, 9, 10, 11, 12, 16, 17, 21, 24, 32)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default="1,8,24,32,128")
    ap.add_argument("--shapes", default="",
                    help="NxK,... (default: every flagship shape)")
    ap.add_argument("--f32", action="store_true",
                    help="the float32 instance instead of the bf16 one")
    ap.add_argument("--splits", default=",".join(map(str, SPLITS)))
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from qwen3_tts_tpu_torch.ops.cuda_kernels import DEQUANT_MATMUL, Kernel
    from sweep_kernel_a import variant_kernel
    from qwen3_tts_tpu_torch.ops.dequant_matmul import (
        plan_kernel_b, plan_kernel_b_f32, quantized_matmul_ref,
    )

    if not torch.cuda.is_available():
        cs.fail("this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    dtype, tol = ((torch.float32, cs.TOL_F32) if args.f32
                  else (torch.bfloat16, cs.TOL))
    entry = str(dtype).replace("torch.", "")
    kernels = {"base": DEQUANT_MATMUL}
    for spec in args.variant:
        kernels[spec.partition(":")[0]] = variant_kernel(spec, DEQUANT_MATMUL)
    with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc each, together
        fns = {name: entries[entry] for name, entries in
               zip(kernels, pool.map(Kernel.load, kernels.values()))}
    for name, kern in kernels.items():
        spills = [ln.strip() for ln in kern.build_log.splitlines()
                  if "bytes spill" in ln and " 0 bytes spill" not in ln]
        cs.log({"variant": name, "spills": spills})
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = ([tuple(map(int, s.split("x"))) for s in args.shapes.split(",")]
              if args.shapes else cs.FLAGSHIP_NK)
    for n, k in shapes:
        for m in map(int, args.rows.split(",")):
            gs = cs.GS
            plan = (plan_kernel_b_f32 if args.f32 else plan_kernel_b)(
                m, n, k, gs, sms)
            x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            copies = max(1, min(32, math.ceil(128e6 / (n * k * 1.125))))
            sets = [(x, *cs._weights(torch, n, k, gs, gen, dev))
                    for _ in range(copies)]
            want = quantized_matmul_ref(*sets[0]).float()
            if args.f32:
                dense = [(x, torch.randn((n, k), generator=gen, device=dev))
                         for _ in range(copies)]
                t = cs.device_time_ms(torch, lambda a, w: a @ w.T, dense)
                cs.log({"M": m, "N": n, "K": k, "dense_f32_ms": t,
                        "dense_tflops": 2 * m * n * k / t / 1e9})
                del dense
            for name, fn in fns.items():
                sweep_one(cs, torch, name, fn, plan, m, n, k, gs, sets, want,
                          dtype, tol, args, dev)
            del sets
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)


def sweep_one(cs, torch, name, fn, plan, m, n, k, gs, sets, want, dtype, tol,
              args, dev) -> None:
    """One kernel build at one shape: every split count, then the line that
    compares the plan's with the fastest."""
    from qwen3_tts_tpu_torch.ops.dequant_matmul import SB_GROUPS_MAX, _scratch

    units = k // plan.k_unit
    # the first plan int: the bf16 ring's fragments, the f32 ring's rows
    first = plan.tile_m if args.f32 else plan.m_frags
    times = {}
    for s in sorted({plan.k_splits, *map(int, args.splits.split(","))}):
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
            out = torch.empty((m, n), dtype=dtype, device=dev)
            rc = fn(x.data_ptr(), q.data_ptr(), sc.data_ptr(),
                    b.data_ptr(), out.data_ptr(), ws.data_ptr(),
                    cnt.data_ptr(), m, k, n, gs, first, s,
                    plan.k_unit, groups, stream)
            if rc:
                cs.fail(f"launch failed: cudaError {rc}")
            return out

        err = (run(*sets[0]).float() - want).abs().max().item()
        if not err <= tol * want.abs().max().item():
            cs.fail(f"{name} M={m} N={n} K={k} splits={s}: error {err}")
        if not torch.equal(run(*sets[0]), run(*sets[0])):
            cs.fail(f"{name} M={m} N={n} K={k} splits={s}: repeats differ")
        times[s] = cs.device_time_ms(torch, run, sets)
        cs.log({"variant": name, "M": m, "N": n, "K": k, "splits": s,
                "kernel_ms": times[s],
                "bound_ms": cs.bound_ms(m, n, k, gs, args.f32)[0],
                "max_abs_err": err})
    best = min(times, key=times.get)
    cs.log({"variant": name, "M": m, "N": n, "K": k, "f32": args.f32,
            "rows": plan.tile_m, "plan_splits": plan.k_splits,
            "plan_ms": times[plan.k_splits], "best_splits": best,
            "best_ms": times[best]})


if __name__ == "__main__":
    main()
