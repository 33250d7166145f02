"""One run of one cell: set up, warm up, measure, check, report.

``run_cell`` returns the result line's object and the check's lines; the
caller (``perfbench/run.py``) prints them and applies the import guard.
"""

from __future__ import annotations

import gc
import math
import subprocess
import time
from dataclasses import dataclass

import torch

from . import check, host, traffic
from .drive import Clients, Recorder
from .manifest import Family, Manifest, family_of, problems
from .program import build_model, port_config


class NoDevice(RuntimeError):
    pass


@dataclass
class Context:
    """What the metric readers read (``perfbench/metrics/*.py``)."""

    config: dict
    family: Family
    setup_s: float
    t_open: float
    t_close: float
    recorder: Recorder
    records: list
    peak_bytes: int
    hop: int
    profile: dict | None = None


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def _wait(cond, timeout: float, what: str | None, poll: float = 0.2) -> None:
    """Wait for ``cond``; past ``timeout`` raise, or (``what`` None) return."""
    end = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() > end:
            if what is None:
                return
            raise TimeoutError(f"{what}: not within {timeout:.0f} s")
        time.sleep(poll)


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, t_start: float, device: str = "cuda",
             control: str | None = None) -> tuple[dict, list[str]]:
    """One run. ``control`` (a name in ``reference.quant.CONTROLS``, no
    part of a benchmark run) puts that control in the program's place for
    the verdict, which it has to fail."""
    man = Manifest(root)
    bad = problems(man.bench, root)
    if bad:
        raise ValueError("BENCHMARK.json: " + "; ".join(bad))
    cell = man.cell(workload)
    cfg = man.config(cell["config"])
    family = man.family(family_of(cfg))
    mix = man.traffic(cell["traffic"])
    spec = man.cell_file(workload)
    limits = spec["check"]["limits"]
    if set(limits) - set(check.NAMES):
        raise ValueError(f"workloads/{workload}.json: no such number "
                         f"{sorted(set(limits) - set(check.NAMES))}")
    if control == "int8" and cfg["weights"]["format"] == "int8":
        raise ValueError("the int8 control is for a dense configuration")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoDevice("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell["chips"]:
            raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the "
                           f"cell asks for {cell['chips']}")
    dev = torch.device(device)
    phases = [("start", t_start)]

    # -- set-up ---------------------------------------------------------------
    raw = family.weights.make_weights(cfg, seed, dev)
    model = build_model(cfg, port_config(cfg), raw, dev)
    if device == "cuda" and cfg["weights"]["format"] == "int8":
        from qwen3_tts_tpu_torch.ops import cuda_kernels

        cuda_kernels.build_all()
    from qwen3_tts_tpu_torch.server import TTSService

    service = TTSService(model, max_streams=mix["slots"],
                         queue_size=max(64, mix["clients"]))
    rec = Recorder(service, trace)
    rec.install()
    clients = Clients(service, traffic.generate(mix, cfg["speakers"], seed))
    warm = set(mix["warmup_chunks"])
    try:
        # warm-up: every client's first request queued before the engine
        # thread starts, so they fill the slots in one cold batch; then a
        # step of each chunk size the mix uses
        clients.start()
        _wait(lambda: service._intake.qsize() >= mix["clients"],
              mix["warmup_timeout_s"], "first requests queued")
        service.start()
        _wait(lambda: warm <= {c[1] for c in rec.collects},
              mix["warmup_timeout_s"], "warm-up")
        if device == "cuda":
            torch.cuda.synchronize()
        t_open = time.perf_counter()
        p_open = host.process_sample()
        setup_s = t_open - t_start
        phases.append(("window", t_open))

        # -- the window ---------------------------------------------------------
        # the profiled slice (``--trace 1``) is the next whole step after the
        # window's middle or after the drain below (the mix's
        # ``slice_after``); host-clock metrics end where it begins
        if trace and mix["slice_after"] == "mid_window":
            time.sleep(seconds / 2)
            rec.want_slice.set()
        time.sleep(max(0.0, t_open + seconds - time.perf_counter()))
        t_close = time.perf_counter()
        p_close = host.process_sample()
        window = [r for r in list(clients.records)
                  if t_open <= r["t_submit"] <= t_close]
        if rec.want_slice.is_set():
            _wait(rec.slice_done.is_set, mix["drain_timeout_s"],
                  "profiled slice")
            phases.append(("sliced", time.perf_counter()))
        # first audio of every request sent in the window, load kept on;
        # what has none by the drain's end counts as missing
        _wait(lambda: all(r["t_first"] is not None or r["error"] is not None
                          for r in window),
              mix["drain_timeout_s"], None)
        phases.append(("drained", time.perf_counter()))
        if trace and mix["slice_after"] == "drain":
            rec.want_slice.set()
            _wait(rec.slice_done.is_set, mix["drain_timeout_s"],
                  "profiled slice")
            phases.append(("sliced", time.perf_counter()))
        # enough finished requests for the check (a batch cell's first
        # requests end after its window)
        _wait(lambda: sum(r["t_done"] is not None for r in clients.records)
              >= spec["check"]["requests"], mix["drain_timeout_s"], None)
        phases.append(("finished", time.perf_counter()))
    finally:
        clients.stop.set()
        service.stop(timeout=mix["drain_timeout_s"])
        clients.release()
        clients.join(30.0)
        rec.uninstall()
    if device == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        name = torch.cuda.get_device_name(0)
        platform = "gpu"
    else:
        peak, name, platform = 0, "cpu", "cpu"
    phases.append(("stopped", time.perf_counter()))
    if service._thread is not None and service._thread.is_alive():
        raise RuntimeError("the engine thread did not stop")
    if clients.alive():
        raise RuntimeError(f"{clients.alive()} client threads did not stop")

    w = cfg["code2wav"]
    hop = math.prod(w["upsample_rates"]) * math.prod(w["upsampling_ratios"])
    # a slice inside the window ends the host clock's part of it
    t_host = min(t_close, rec.slice_t0) if trace else t_close
    host_line = host.summary(t_open, t_host, rec.engine_host, p_open, p_close)
    ctx = Context(config=cfg, family=family, setup_s=setup_s, t_open=t_open,
                  t_close=t_host, recorder=rec, records=list(clients.records),
                  peak_bytes=peak, hop=hop,
                  profile=rec.slice.read() if trace else None)
    phases.append(("read", time.perf_counter()))
    metrics = {}
    for m in man.metrics(workload, trace):
        value = man.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": platform, "kind": name,
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if device == "cuda":
        device_info["power"] = _power_limit()
    if trace:
        device_info["busy_s"] = ctx.profile["busy_s"]
        device_info["window_s"] = ctx.profile["window_s"]

    # -- the check, with the program's state freed ----------------------------
    breakdown = ({k: ctx.profile[k] for k in ("device_ops", "idle_gaps")}
                 if trace else None)
    seeds = rec.seed_codes()
    served = rec.served
    records = ctx.records
    # attempted: the requests the window served (sent before it closed, not
    # done before it opened)
    attempted = sum(1 for r in records if r["t_submit"] <= t_close and (
        r["t_done"] is None or r["t_done"] >= t_open))
    failed = sum(1 for r in records if r["error"] is not None)
    del model, service, ctx, rec
    clients.records = []
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    picked = check.pick(records, served, t_open, spec["check"]["requests"],
                        seed)
    sample = [check.served_request(r, served, seeds, cfg) for r in picked]
    phases.append(("checking", time.perf_counter()))
    prog, ctl = check.judge(family.reference, raw, cfg, sample, dev,
                            control=control)
    phases.append(("checked", time.perf_counter()))
    # the numbers judged: the program's, or the control's in its place
    numbers = prog if ctl is None else ctl
    n_sample = spec["check"]["requests"]
    # every sampled request judged (as many as the cell asks for finished),
    # no request failed, every number the cell limits within its limit
    correct = len(sample) == n_sample and failed == 0 and all(
        numbers[k] <= v for k, v in limits.items())
    lines = ["phases " + " ".join(f"{n}={t - t_start:.1f}" for n, t in phases),
             host_line]
    if ctl is not None:
        lines += [f"program {k} {prog[k]!r}" for k in check.NAMES]
        lines += [f"control {control} {k} {ctl[k]!r}" for k in check.NAMES]
    lines += [f"check requests {len(sample)} limit {n_sample}",
              f"check failed {failed} limit 0"]
    lines += [f"check {k} {numbers[k]!r} limit {v!r}"
              for k, v in limits.items()]
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = breakdown
    if ctl is not None:
        result["control"] = {"name": control, **ctl}
        result["program"] = prog
    result["check"] = {"requests": {"value": len(sample), "limit": n_sample},
                       "failed": {"value": failed, "limit": 0},
                       **{k: {"value": numbers[k], "limit": v}
                          for k, v in limits.items()}}
    return result, lines
