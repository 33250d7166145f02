#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the CUDA device it starts on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It makes the cell's weights from the seed, builds the program
(``src/qwen3_tts_tpu_torch``) over them, warms up, drives the daemon's
engine with the cell's closed-loop clients for ``--seconds``, checks a
sample of what was served against ``perfbench/reference``, and prints one
JSON line last on standard output (with ``--trace 1`` the per-layer
metrics and the profiled slice's breakdown, else the end-to-end metrics).
The compared numbers and their limits are the last lines on standard
error, after a line of what the host did in the window.

Not part of a benchmark run: ``--control lower`` (or ``int8``, for a
dense configuration) puts that control in the program's place, so the
line reads ``correct`` false where the check separates it, and prints the
program's numbers beside it.

It exits non-zero, and prints no result, without a CUDA device or with
fewer than the cell asks for, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the program's default path: no knob of its environment applies
for _k in [k for k in os.environ if k.startswith("QWEN3_TTS_")]:
    del os.environ[_k]
os.environ["USE_FLAX"] = "0"
# build caches at fixed paths inside the checkout (kernel A itself builds
# into build/kernels/ there)
BUILD = os.path.join(ROOT, "build")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, HERE)


def _finite(obj):
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("none", "lower", "int8"),
                    default="none")
    args = ap.parse_args(argv)

    from harness.bench import NoDevice, run_cell
    from harness.guard import banned_modules

    try:
        result, lines = run_cell(ROOT, args.workload, args.seed, args.seconds,
                                 bool(args.trace), T_START,
                                 control=(None if args.control == "none"
                                          else args.control))
    except NoDevice as e:
        print(f"perfbench: no result: {e}", file=sys.stderr)
        return 2
    bad = banned_modules()
    if bad:
        print(f"perfbench: no result: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
