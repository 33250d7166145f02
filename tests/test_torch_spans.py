"""The benchmark's reader of the program's spans (``perfbench/harness/
spans.py``) and the per-layer metrics that read it, on a hand-built
profile: containment on the engine thread, self time under nesting, device
time linked by correlation id, a user-scope shadow skipped, a kernel
launched before the slice left unattributed, idle gaps put down to the
innermost span; and kernel A's entry opening its span. No JAX."""

import importlib
import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from qwen3_tts_tpu_torch.ops.grouped_qmv import quantized_matmul_grouped

ROOT = Path(__file__).resolve().parent.parent
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MS = 1_000_000  # ns


@pytest.fixture(scope="module")
def harness():
    """``perfbench/harness`` as the benchmark's command imports it."""
    sys.path.insert(0, str(ROOT / "perfbench"))
    try:
        yield SimpleNamespace(
            spans=importlib.import_module("harness.spans"),
            manifest=importlib.import_module("harness.manifest"))
    finally:
        sys.path.remove(str(ROOT / "perfbench"))


class _Event:
    """The part of a kineto event that the reader reads."""

    def __init__(self, name, start_ms, end_ms, dev=CPU, tid=1, corr=0,
                 user=False):
        self._v = (name, dev, int(start_ms * MS),
                   int((end_ms - start_ms) * MS), tid, corr, user)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def _span(name, a, b, tid=1):
    return _Event("qwen3_tts." + name, a, b, tid=tid)


def _launch(name, at, corr, tid=1):
    return _Event(name, at, at + 0.5, tid=tid, corr=corr)


def _kernel(a, b, corr, name="ring_kernel<__nv_bfloat16, 1, 2, false>"):
    return _Event(name, a, b, dev=CUDA, corr=corr)


# one dispatch (talker with an attention and kernel A's entry in it, the
# predictor with an attention, code2wav) and one collection with its host
# wait, on engine thread 1; thread 2 holds a span and a launch of its own
EVENTS = [
    _span("engine.dispatch", 0, 100),
    _span("model.talker", 10, 42),
    _span("model.attention", 15, 25),
    _span("kernel.grouped_qmv", 18, 22),
    _span("model.predictor", 50, 89),
    _span("model.attention", 55, 60),
    _span("model.code2wav", 92, 99),
    _span("engine.collect", 110, 120),
    _span("engine.host_wait", 112, 118),
    _span("model.talker", 0, 120, tid=2),
    # a host op whose own correlation id equals a launch's: not a launch
    _Event("aten::mm", 5, 6, corr=104),
    _launch("cudaLaunchKernel", 20, 101),
    _launch("cudaLaunchKernel", 45, 102),
    _launch("cudaMemcpyAsync", 57, 103),
    _launch("cuLaunchKernel", 70, 104),
    _launch("cudaLaunchKernel", 30, 105, tid=2),
    _launch("cudaLaunchKernel", 95, 107),
    _launch("cudaMemsetAsync", 113, 106),
    _kernel(0, 3, 99),            # launched before the slice
    _kernel(30, 35, 101),
    _kernel(45, 47, 102),
    _kernel(60, 64, 103, name="Memcpy DtoH (Device -> Pinned)"),
    _kernel(70, 80, 104),
    _kernel(84, 85, 105),
    _kernel(95, 97, 107),
    _kernel(114, 115, 106, name="Memset (Device)"),
    # a user-scope range's shadow on the device: no device work
    _Event("perfbench.dispatch_step", 0, 120, dev=CUDA, corr=1, user=True),
]


def _close(got: dict, want: dict):
    assert set(got) == {"qwen3_tts." + k if k != "-" else k for k in want}
    for k, v in want.items():
        assert got["qwen3_tts." + k if k != "-" else k] == pytest.approx(v)


def test_reader_splits_host_device_and_idle_time_by_span(harness):
    s = harness.spans.summarize(EVENTS)
    # inclusive and self host time on the engine thread only
    _close(s["host_ms"], {
        "engine.dispatch": 100, "model.talker": 32, "model.attention": 15,
        "kernel.grouped_qmv": 4, "model.predictor": 39,
        "model.code2wav": 7, "engine.collect": 10, "engine.host_wait": 6})
    _close(s["self_ms"], {
        "engine.dispatch": 22, "model.talker": 22, "model.attention": 11,
        "kernel.grouped_qmv": 4, "model.predictor": 34,
        "model.code2wav": 7, "engine.collect": 4, "engine.host_wait": 6})
    assert s["calls"]["qwen3_tts.model.attention"] == 2
    assert s["calls"]["qwen3_tts.model.talker"] == 1
    # device time by correlation id: to every span open at the launch, and
    # to the innermost
    _close(s["device_ms"], {
        "engine.dispatch": 23, "model.talker": 5, "model.attention": 9,
        "kernel.grouped_qmv": 5, "model.predictor": 14,
        "model.code2wav": 2, "engine.collect": 1, "engine.host_wait": 1})
    _close(s["device_self_ms"], {
        "engine.dispatch": 2, "model.attention": 4, "kernel.grouped_qmv": 5,
        "model.predictor": 10, "model.code2wav": 2, "engine.host_wait": 1})
    assert s["device_before_ms"] == pytest.approx(3)
    assert s["device_outside_ms"] == pytest.approx(1)
    # the shadow is no busy time: the union of the kernels and copies
    assert s["busy_ms"] == pytest.approx(28)
    assert s["window_ms"] == pytest.approx(120)
    assert (sum(s["device_self_ms"].values()) + s["device_before_ms"]
            + s["device_outside_ms"]) == pytest.approx(s["busy_ms"])
    # each idle gap to the innermost span open at its midpoint
    _close(s["idle_ms"], {
        "model.attention": 27, "model.talker": 10, "model.predictor": 23,
        "engine.dispatch": 10, "-": 17, "engine.host_wait": 5})
    assert sum(s["idle_ms"].values()) == pytest.approx(120 - 28)
    assert s["coverage"] == pytest.approx(110 / 120)


def test_reader_gives_nothing_without_program_spans(harness):
    """A program that opens no span (the benchmark's traced run of an
    older program): None, and every metric that reads it None."""
    assert harness.spans.summarize(
        [e for e in EVENTS if not e.name().startswith("qwen3_tts.")]) is None


def _ctx(events, profile=True):
    """What a metric reads: the recorder's dispatches (two 4-frame steps
    in the slice, one 32-frame step before it) and the slice's events."""
    prof = SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: list(events)))
    recorder = SimpleNamespace(
        dispatches=[(1.0, 32, 2, False), (2.0, 4, 2, True),
                    (3.0, 4, 2, True)],
        slice=SimpleNamespace(prof=prof))
    return SimpleNamespace(recorder=recorder,
                           profile={"busy_s": 0.028} if profile else None)


# each new metric over the hand-built slice: 2 steps, 8 frame-steps
METRICS = {
    "engine.host_wait_ms": 6 / 2,
    "engine.self_host_ms": (22 + 4) / 2,
    "model.talker_host_ms": 32 / 8,
    "model.predictor_host_ms": 39 / 8,
    "model.code2wav_host_ms": 7 / 8,
    "model.talker_device_ms": 5 / 8,
    "model.predictor_device_ms": 14 / 8,
    "model.code2wav_device_ms": 2 / 8,
    "model.attention_device_ms": 9 / 8,
    "kernels.kernel_a_host_ms": 4 / 8,
}


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_span_metric_reads_its_share_of_the_slice(harness, metric):
    man = harness.manifest.Manifest(str(ROOT))
    entry = next(m for m in man.bench["per_layer"] if m["name"] == metric)
    assert entry["source"] == "device_trace"
    assert entry["moves"] == "audio_s_per_s"
    read = man.reader(metric)
    assert read(_ctx(EVENTS)) == pytest.approx(METRICS[metric])
    assert read(_ctx([e for e in EVENTS
                      if not e.name().startswith("qwen3_tts.")])) is None
    assert read(_ctx(EVENTS, profile=False)) is None


def test_decode_attention_share_counts_kernel_c_over_attention_calls(
        harness, monkeypatch):
    """``kernels.decode_attention_share``: 100 x the slice's kernel C spans
    over its attention spans; 0 where attention ran without kernel C;
    nothing where no span was recorded or the program has no kernel C."""
    man = harness.manifest.Manifest(str(ROOT))
    name = "kernels.decode_attention_share"
    entry = next(m for m in man.bench["per_layer"] if m["name"] == name)
    assert (entry["source"], entry["unit"], entry["layer"], entry["moves"]) \
        == ("device_trace", "%", "kernels", "audio_s_per_s")
    read = man.reader(name)
    # kernel C in the talker's attention, not in the predictor's
    one = EVENTS + [_span("kernel.decode_attention", 22.5, 24)]
    assert read(_ctx(one)) == pytest.approx(50.0)
    both = one + [_span("kernel.decode_attention", 56, 59)]
    assert read(_ctx(both)) == pytest.approx(100.0)
    assert read(_ctx(EVENTS)) == 0.0
    assert read(_ctx([e for e in both
                      if not e.name().startswith("qwen3_tts.")])) is None
    assert read(_ctx(both, profile=False)) is None
    # a program without kernel C: the same slice reads nothing
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name.endswith(".decode_attention") else find_spec(name, *a)))
    assert read(_ctx(EVENTS)) is None
    assert read(_ctx(both)) is None


def test_kernel_a_entry_opens_its_span_on_either_route():
    """``quantized_matmul_grouped`` (the plain route on the CPU) records
    one ``qwen3_tts.kernel.grouped_qmv`` span around its work."""
    g, gs, n = 2, 32, 8
    gen = torch.Generator().manual_seed(0)
    qg = torch.randint(0, 256, (g, gs, n), generator=gen, dtype=torch.uint8)
    sg = torch.rand(g, n, generator=gen)
    bg = torch.rand(g, n, generator=gen)
    x = torch.randn(3, g * gs, generator=gen)
    with torch.autograd.profiler.profile(use_kineto=True) as prof:
        out = quantized_matmul_grouped(x, qg, sg, bg)
    assert out.shape == (3, n)
    events = list(prof.kineto_results.events())
    span = [e for e in events if e.name() == "qwen3_tts.kernel.grouped_qmv"]
    assert len(span) == 1 and not span[0].is_user_annotation()
    s0 = span[0].start_ns()
    s1 = s0 + span[0].duration_ns()
    bmm = [e for e in events if e.name() == "aten::bmm"]
    assert bmm and all(s0 <= e.start_ns() <= s1 for e in bmm)
