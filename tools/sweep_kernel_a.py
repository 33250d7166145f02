#!/usr/bin/env python3
"""Kernel A of the PyTorch/CUDA port (``csrc/grouped_qmv.cu``) at flagship
(N, K) and row counts, timed at the split of K that ``plan_kernel_a``
picks and at others, beside ``_dense_route`` (its library yardstick), on
one NVIDIA GPU: the measurement behind the plan's constants.

    python3 tools/sweep_kernel_a.py [--rows 1,8,24,32,64]
        [--shapes 6144x2048,2048x6144] [--splits 1,2,4,8] [--f32]
        [--variant 'NAME:old=>new@@old2=>new2' ...] [--probe ...]

``--f32`` times the float32 instance (float32 x and out, its bound at the
float32 CUDA-core rate, error within chip_smoke.TOL_F32).

Each ``--variant`` builds a copy of the source (into
build/variants/grouped_qmv/NAME/) with the given text replaced, e.g.
``st8:kRows <= 8 ? 6=>kRows <= 8 ? 8``, and is timed with the same entry
point after the committed source ("base"). A ``--probe`` is a variant
that leaves part of the work out to see what it costs: it is timed, and
its output is not checked. One JSON line per (variant, M, N, K, splits):
kernel time, bound and error against the plain version; then one line per
shape and variant comparing the plan's split with the fastest one measured
and with the library call. Timing as ``chip_smoke.py``'s kernel phase.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SPLITS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 14, 16)


def variant_kernel(spec: str, base=None):
    """A Kernel built from a copy of ``base``'s source (grouped_qmv.cu by
    default) with text replaced."""
    from qwen3_tts_tpu_torch.ops import cuda_kernels

    name, _, edits = spec.partition(":")
    base = base or cuda_kernels.GROUPED_QMV
    text = base.source.read_text()
    for edit in filter(None, edits.split("@@")):
        old, new = edit.split("=>")
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in the source")
        text = text.replace(old, new)
    out = ROOT / "build" / "variants" / base.name / name
    out.mkdir(parents=True, exist_ok=True)
    for header in base.headers():
        shutil.copy(header, out / header.name)
    (out / base.source.name).write_text(text)
    return cuda_kernels.Kernel(f"{base.name}_{name}", str(out / base.source.name),
                               base.symbols, base.argtypes)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default="1,8,24,32,64")
    ap.add_argument("--shapes", default="",
                    help="NxK,... (default: every flagship shape)")
    ap.add_argument("--splits", default=",".join(map(str, SPLITS)))
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--probe", action="append", default=[])
    ap.add_argument("--f32", action="store_true",
                    help="the float32 instance instead of the bf16 one")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from qwen3_tts_tpu_torch.ops.cuda_kernels import GROUPED_QMV, Kernel
    from qwen3_tts_tpu_torch.ops.grouped_qmv import (
        SB_GROUPS_MAX, SLICE_K, TILE_N, _dense_route, _scratch, pack_grouped,
        plan_kernel_a, quantized_matmul_grouped_ref,
    )

    if not torch.cuda.is_available():
        cs.fail("this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kernels = {"base": GROUPED_QMV}
    for spec in args.variant + args.probe:
        kernels[spec.partition(":")[0]] = variant_kernel(spec)
    probes = {spec.partition(":")[0] for spec in args.probe}
    dtype, tol = ((torch.float32, cs.TOL_F32) if args.f32
                  else (torch.bfloat16, cs.TOL))
    entry = str(dtype).replace("torch.", "")
    with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc each, together
        fns = {name: entries[entry] for name, entries in
               zip(kernels, pool.map(Kernel.load, kernels.values()))}
    for name, kern in kernels.items():
        ptxas = [ln.strip() for ln in kern.build_log.splitlines()
                 if "registers" in ln or "bytes spill" in ln]
        cs.log({"variant": name, "ptxas": ptxas})
    shapes = ([tuple(map(int, s.split("x"))) for s in args.shapes.split(",")]
              if args.shapes else cs.FLAGSHIP_NK)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for n, k in shapes:
        for m in map(int, args.rows.split(",")):
            gs = cs.GS
            plan = plan_kernel_a(m, n, k, gs, sms)
            units = k // SLICE_K
            tiles = -(-n // TILE_N)
            x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            copies = max(1, min(32, math.ceil(128e6 / (n * k * 1.125))))
            sets = []
            for _ in range(copies):
                q, s, b = cs._weights(torch, n, k, gs, gen, dev)
                gp = pack_grouped({"q": q, "scale": s, "bias": b})
                sets.append((x, gp["qg"], gp["sg"], gp["bg"]))
            want = quantized_matmul_grouped_ref(*sets[0]).float()
            lib = cs.device_time_ms(torch, _dense_route, sets)
            split_list = sorted({plan.k_splits,
                                 *map(int, args.splits.split(","))})
            for name, fn in fns.items():
                times = {}
                for splits in split_list:
                    groups = -(-units // splits) * (SLICE_K // gs)
                    if splits > units or groups > SB_GROUPS_MAX:
                        continue
                    need = plan._replace(
                        k_splits=splits, counters=tiles,
                        workspace_floats=splits * tiles * plan.rows * TILE_N)
                    ws, cnt = _scratch(dev, stream, need)

                    def run(x, qg, sg, bg, fn=fn, splits=splits,
                            groups=groups, ws=ws, cnt=cnt):
                        out = torch.empty((m, n), dtype=dtype, device=dev)
                        rc = fn(x.data_ptr(), qg.data_ptr(), sg.data_ptr(),
                                bg.data_ptr(), out.data_ptr(), ws.data_ptr(),
                                cnt.data_ptr(), m, k, n, gs, plan.band_rows,
                                plan.bands, splits, groups, stream)
                        if rc:
                            cs.fail(f"launch failed: cudaError {rc}")
                        return out

                    err = (run(*sets[0]).float() - want).abs().max().item()
                    if name not in probes and not (
                            err <= tol * want.abs().max().item()):
                        cs.fail(f"{name} M={m} N={n} K={k} splits={splits}: "
                                f"error {err}")
                    times[splits] = cs.device_time_ms(torch, run, sets)
                    cs.log({"variant": name, "M": m, "N": n, "K": k,
                            "splits": splits, "kernel_ms": times[splits],
                            "bound_ms": cs.bound_ms(m, n, k, gs, args.f32)[0],
                            "max_abs_err": err})
                best = min(times, key=times.get)
                cs.log({"variant": name, "M": m, "N": n, "K": k, "f32": args.f32,
                        "plan_splits": plan.k_splits,
                        "plan_ms": times[plan.k_splits], "best_splits": best,
                        "best_ms": times[best], "library_ms": lib})
            del sets
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
