#!/usr/bin/env python3
"""The port's two CUDA kernels from two checkouts, timed in turns on one
NVIDIA GPU (a, b, b, a): how a change to a kernel moved its time, with the
card's noise beside it.

    python3 tools/ab_kernels.py --roots build/parent,. [--f32]
        [--cases grouped_qmv:1x6144x2048,dequant_matmul:128x6144x2048]

Each root is a checkout holding ``src/qwen3_tts_tpu_torch`` and
``chip_smoke.py``; its kernels build from its own ``csrc/`` into its own
``build/kernels/``. One child process per (round, root) holds every case
(gs = 64) against its plain version (``chip_smoke.TOL``, or ``TOL_F32``
with ``--f32``, float32 x and out) and times it as ``chip_smoke.py``'s
kernel phase does. Output: one JSON line per child and case, then one per
case with each root's two times and their median, and the ratio b / a.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

DEFAULT_CASES = (
    "grouped_qmv:1x6144x2048,grouped_qmv:8x6144x2048,"
    "grouped_qmv:32x6144x2048,grouped_qmv:64x6144x2048,"
    "dequant_matmul:1x6144x2048,dequant_matmul:32x6144x2048,"
    "dequant_matmul:128x6144x2048,dequant_matmul:512x3072x2048"
)


def parse_cases(text: str) -> list[tuple[str, int, int, int]]:
    cases = []
    for item in text.split(","):
        name, _, shape = item.partition(":")
        m, n, k = map(int, shape.split("x"))
        cases.append((name, m, n, k))
    return cases


def child(root: Path, cases, f32: bool) -> None:
    """Build ``root``'s kernels, then check and time every case."""
    sys.path[:0] = [str(root / "src"), str(root)]
    import math

    import torch

    import chip_smoke as cs
    from qwen3_tts_tpu_torch.ops import cuda_kernels
    from qwen3_tts_tpu_torch.ops.dequant_matmul import (
        dequant_matmul_cuda, quantized_matmul_ref,
    )
    from qwen3_tts_tpu_torch.ops.grouped_qmv import (
        grouped_qmv_cuda, pack_grouped, quantized_matmul_grouped_ref,
    )

    if not torch.cuda.is_available():
        cs.fail("this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cuda_kernels.build_all()
    dev = torch.device("cuda")
    dtype, tol = ((torch.float32, cs.TOL_F32) if f32
                  else (torch.bfloat16, cs.TOL))
    gen = torch.Generator(device=dev).manual_seed(0)
    fns = {"grouped_qmv": (grouped_qmv_cuda, quantized_matmul_grouped_ref),
           "dequant_matmul": (dequant_matmul_cuda, quantized_matmul_ref)}
    for name, m, n, k in cases:
        gs = cs.GS
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        copies = max(1, min(32, math.ceil(128e6 / (n * k * 1.125))))
        sets = []
        for _ in range(copies):
            q, s, b = cs._weights(torch, n, k, gs, gen, dev)
            if name == "grouped_qmv":
                gp = pack_grouped({"q": q, "scale": s, "bias": b})
                sets.append((x, gp["qg"], gp["sg"], gp["bg"]))
            else:
                sets.append((x, q, s, b))
        kern, plain = fns[name]
        got, want = kern(*sets[0]).float(), plain(*sets[0]).float()
        err = (got - want).abs().max().item()
        if not err <= tol * want.abs().max().item():
            cs.fail(f"{root} {name} M={m} N={n} K={k}: error {err}")
        print(json.dumps({"root": str(root), "kernel": name, "M": m, "N": n,
                          "K": k, "f32": f32, "max_abs_err": err,
                          "kernel_ms": cs.device_time_ms(torch, kern, sets)}),
              flush=True)
        del sets


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", required=True, help="a,b: two checkouts")
    ap.add_argument("--cases", default=DEFAULT_CASES,
                    help="kernel:MxNxK,... (gs = 64)")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    cases = parse_cases(args.cases)
    if args.child:
        child(Path(args.child).resolve(), cases, args.f32)
        return
    a, b = (Path(r).resolve() for r in args.roots.split(","))
    times: dict = {}
    for root in (a, b, b, a):
        cmd = [sys.executable, __file__, "--roots", args.roots, "--cases",
               args.cases, "--child", str(root)] + (["--f32"] if args.f32 else [])
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.exit(f"{root}: exit {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                row = json.loads(line)
                key = (row["kernel"], row["M"], row["N"], row["K"])
                times.setdefault(key, {}).setdefault(str(root), []).append(
                    row["kernel_ms"])
    for (name, m, n, k), by_root in times.items():
        ta, tb = by_root[str(a)], by_root[str(b)]
        print(json.dumps({"kernel": name, "M": m, "N": n, "K": k,
                          "f32": args.f32, "a": str(a), "b": str(b),
                          "a_ms": ta, "b_ms": tb,
                          "a_median_ms": statistics.median(ta),
                          "b_median_ms": statistics.median(tb),
                          "b_over_a": statistics.median(tb)
                          / statistics.median(ta)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
