"""The port's main path as a whole against the JAX package: greedy float32
synthesis on one tiny int8 tree under both int8 layouts, generate_audio's
WAV contract, the entry points' device rules, and the isolation of the port
(no JAX, nothing of the JAX package)."""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys
import warnings
import wave
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from qwen3_tts_tpu.engine import configs as jcfgs
from qwen3_tts_tpu.engine.api import Qwen3TTSModel as JaxModel
from qwen3_tts_tpu.engine.api import generate_audio as jax_generate_audio
from qwen3_tts_tpu.engine.tokenizer import ByteTokenizer
from qwen3_tts_tpu.models.code_predictor import init_code_predictor
from qwen3_tts_tpu.models.codec import init_codec
from qwen3_tts_tpu.models.talker import init_talker
from qwen3_tts_tpu.runtime.generate import Generator as JaxGenerator
from qwen3_tts_tpu.runtime.prompts import build_prompt as jax_build_prompt
from qwen3_tts_tpu.runtime.sampling import SamplingConfig as JaxSampling
from qwen3_tts_tpu_torch.engine import configs as tcfgs
from qwen3_tts_tpu_torch.engine import api as tapi
from qwen3_tts_tpu_torch.engine.weights import params_from_numpy
from qwen3_tts_tpu_torch.runtime.generate import Generator, chunk_plan
from qwen3_tts_tpu_torch.runtime.prompts import build_prompt
from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig
from torch_port_helpers import tame_codec, tiny_f32

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "qwen3_tts_tpu_torch"
TEXT = "Hello there, general."
PCM_LSB = 2  # int16 PCM tolerance: float32 summation order in the codec


@pytest.mark.parametrize("layout", ["grouped", "rowmajor"])
def test_synthesize_matches_jax_generator(layout, monkeypatch):
    """Same tree, same prompt, greedy float32: identical codec codes and
    int16 PCM within 2 LSB, across three chunks (streaming codec state and
    the per-chunk EOS/valid clipping included)."""
    monkeypatch.setenv("QWEN3_TTS_INT8_LAYOUT", layout)
    jc, tc = tiny_f32(jcfgs), tiny_f32(tcfgs)
    trees = (init_talker(jc, 0), init_code_predictor(jc, 1),
             tame_codec(init_codec(jc, 2)))
    jgen = JaxGenerator(cfg=jc, params=trees[0], cp_params=trees[1],
                        codec_params=trees[2],
                        sampling=JaxSampling(greedy=True), chunk_schedule=(4,))
    params, cp_params, codec_params = params_from_numpy(*trees, device="cpu")
    tgen = Generator(cfg=tc, params=params, cp_params=cp_params,
                     codec_params=codec_params,
                     sampling=SamplingConfig(greedy=True), chunk_schedule=(4,))
    kw = dict(voice="ryan", speakers=jc.speakers)
    jprompt = jax_build_prompt(ByteTokenizer(), "custom", TEXT, **kw)
    tprompt = build_prompt(tapi.load_tokenizer(None, 256), "custom", TEXT, **kw)
    np.testing.assert_array_equal(tprompt.text_tokens, jprompt.text_tokens)

    ref = jgen.synthesize(jprompt, max_frames=12, collect_codes=True)
    got = tgen.synthesize(tprompt, max_frames=12, collect_codes=True)
    assert got.frames == ref.frames > 4
    np.testing.assert_array_equal(got.codes, ref.codes)
    assert got.wav.dtype == np.int16 and got.wav.shape == ref.wav.shape
    diff = np.abs(got.wav.astype(np.int32) - ref.wav.astype(np.int32))
    assert diff.max() <= PCM_LSB
    assert np.abs(ref.wav).max() > 1000  # a live waveform, not silence


def test_generate_audio_writes_the_same_wav_length(temp_dir):
    """Both packages' synthetic tiny float32 models (the port's host
    initialisers draw the JAX package's values) through generate_audio:
    audio_000.wav, mono 16-bit 24 kHz, of the same length."""
    lengths = {}
    for name, cfgmod, build, run in (
        ("jax", jcfgs, lambda c: JaxModel.synthetic(c, seed=0),
         jax_generate_audio),
        ("torch", tcfgs,
         lambda c: tapi.Qwen3TTSModel.synthetic(c, seed=0, device="cpu"),
         tapi.generate_audio),
    ):
        model = build(tiny_f32(cfgmod))
        model.sampling = (JaxSampling if name == "jax" else SamplingConfig)(
            greedy=True)
        out = os.path.join(temp_dir, name)
        metrics = run(model=model, text=TEXT, voice="ryan", output_path=out,
                      max_frames=8)
        with wave.open(os.path.join(out, "audio_000.wav"), "rb") as w:
            assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == \
                (1, 2, 24000)
            lengths[name] = w.getnframes()
        assert lengths[name] == metrics["frames"] * 2000
    assert lengths["torch"] == lengths["jax"] > 0


@pytest.mark.parametrize("longform", ["serving", "serial"])
def test_generate_audio_serial_segments_and_metrics(longform, temp_dir,
                                                    monkeypatch):
    """Two segments, through the serving engine (the default) or one after
    another (QWEN3_TTS_LONGFORM=serial): each segment's audio, a gap
    between them, and the metrics."""
    monkeypatch.setenv("QWEN3_TTS_LONGFORM", longform)
    model = tapi.load_model("synthetic:tiny", device="cpu")
    text = "A long first sentence. " * 30 + "The second segment begins."
    m = tapi.generate_audio(model=model, text=text, voice="ryan",
                            output_path=temp_dir, max_frames=4)
    assert (model._serving is not None) == (longform == "serving")
    assert m["segments"] == 2 and m["frames"] == 8
    with wave.open(os.path.join(temp_dir, "audio_000.wav"), "rb") as w:
        assert w.getnframes() == 8 * 2000 + int(0.15 * 24000)
    assert m["rtf"] > 0 and m["ttfa_s"] > 0


def test_stream_stops_at_the_cache_budget():
    """A frame budget past the talker cache: the prompt bucket (64) plus
    the budget fill max_seq_len (256) exactly, so the last chunk is cut to
    fit instead of writing past the cache."""
    model = tapi.load_model("synthetic:tiny", device="cpu")
    model.sampling = SamplingConfig(greedy=True)
    gen = model.generator
    prompt = build_prompt(model.tokenizer, "custom", TEXT, voice="ryan",
                          speakers=model.cfg.speakers)
    assert gen._assemble_cb0(prompt)[0].shape[1] == 64
    res = gen.synthesize(prompt, max_frames=10_000, collect_codes=True)
    assert 0 < res.frames <= model.cfg.max_seq_len - 64
    assert res.codes.shape == (model.cfg.codec.num_codebooks, res.frames)
    assert len(res.wav) == res.frames * model.cfg.codec.hop


@pytest.mark.parametrize("schedule,max_frames,fps,want", [
    ((8, 32), 64, 1, [8, 32, 24]),
    ((8, 32), 5, 1, [5]),
    ((8, 32), 100, 1, [8, 32, 32, 28]),
    ((4, 8), 7, 2, [4, 4]),
])
def test_chunk_plan_cuts_the_last_chunk_to_the_budget(schedule, max_frames,
                                                      fps, want):
    assert list(chunk_plan(schedule, max_frames, fps)) == want


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.load_model("synthetic:tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.Qwen3TTSModel.synthetic(tcfgs.tiny(quant=True))


def _with_env(env: dict, call):
    with mock.patch.dict(os.environ, env):
        return call()


def _with_fps(cfg, fps: int):
    return dataclasses.replace(
        cfg, talker=dataclasses.replace(cfg.talker, frames_per_step=fps))


def _train_step(**kw):
    from qwen3_tts_tpu_torch.training import default_optimizer, make_train_step

    return make_train_step(tcfgs.tiny(), default_optimizer(), **kw)


@pytest.mark.parametrize("call,item", [
    (lambda m, d: tapi.Qwen3TTSModel.synthetic(
        _with_fps(tcfgs.tiny_feedback(), 2), device="cpu"), "9"),
    (lambda m, d: _train_step(sequence_parallel=True), "15"),
    (None, "15"),
], ids=["residual_sum_mtp", "sequence_parallel", "pipeline_mesh"])
def test_unported_features_raise_with_their_roadmap_item(call, item, temp_dir):
    """What raised naming its ROADMAP item runs now. Item 15 (training
    across devices) is ported: sequence parallelism without a mesh raises
    the JAX package's ValueError, and no NotImplementedError in the port's
    source names the item (the pipeline mesh trains,
    tests/test_torch_parallel_training.py). Item 9 (MTP): building a
    residual_sum model at two frames a step gives a model with its MTP
    heads whose generate_audio writes its WAV."""
    if item == "15" and call is not None:
        with pytest.raises(ValueError, match="sequence_parallel needs a mesh"):
            call(None, temp_dir)
        return
    if item == "9":
        model = call(tapi.load_model("synthetic:tiny", device="cpu"),
                     temp_dir)
        assert model.cfg.talker.frames_per_step == 2 and "mtp" in model.params
        m = tapi.generate_audio(model=model, text=TEXT, voice="ryan",
                                output_path=temp_dir, max_frames=6)
        with wave.open(os.path.join(temp_dir, "audio_000.wav"), "rb") as f:
            assert f.getnframes() == m["frames"] * model.cfg.codec.hop > 0
    raising = [p.name for p in PORT.rglob("*.py")
               if f"item {item}" in p.read_text()
               and "NotImplementedError" in p.read_text()]
    assert raising == [], raising


def _reference_wav(temp_dir: str) -> str:
    from qwen3_tts_tpu_torch.audio import write_wav

    rng = np.random.default_rng(0)
    path = os.path.join(temp_dir, "ref.wav")
    write_wav(path, (0.2 * rng.standard_normal(24000)).astype(np.float32),
              24000)
    return path


def _snapshot_base(d: str):
    from qwen3_tts_tpu_torch.engine.fabricate import fabricate_full_checkpoint

    return tapi.load_model(fabricate_full_checkpoint(os.path.join(d, "snap")),
                           device="cpu", mode="base")


@pytest.mark.parametrize("build,kw", [
    (lambda d: tapi.load_model("synthetic:tiny:base", device="cpu"),
     {"ref_audio": True}),
    (lambda d: tapi.load_model("synthetic:tiny-code2wav:base", device="cpu"),
     {"ref_audio": True}),
    (_snapshot_base, {"ref_audio": True}),
    (lambda d: tapi.load_model("synthetic:tiny", device="cpu"),
     {"ref_audio": True, "voice": "ryan"}),
    (lambda d: tapi.load_model("synthetic:tiny", device="cpu"),
     {"voice": "ryan", "env": {"QWEN3_TTS_KV": "int8"}}),
    (lambda d: tapi.load_model("synthetic:tiny", device="cpu"),
     {"voice": "ryan", "speed": 1.3}),
], ids=["base_mode", "code2wav", "checkpoint_dir", "ref_audio", "kv_int8",
        "speed"])
def test_features_that_raised_now_run_and_write_their_wav(build, kw, temp_dir):
    """What raised for ROADMAP items 11, 12 and 13 runs now: the base
    (cloning) mode of synthetic names and of a checkpoint directory,
    ref_audio in any mode, and the int8 KV cache, each writing frames x hop
    samples (less the code2wav decoder's run-in); speed != 1, the whole
    signal time-stretched on the host to frames x hop / speed samples."""
    model = build(temp_dir)
    speed = kw.get("speed", 1.0)
    args = dict(model=model, text=TEXT, output_path=temp_dir, max_frames=8,
                voice=kw.get("voice"), speed=speed)
    if kw.get("ref_audio"):
        args.update(ref_audio=_reference_wav(temp_dir),
                    ref_text="A reference transcript.")
    m = _with_env(kw.get("env", {}), lambda: tapi.generate_audio(**args))
    cfg = model.cfg
    skip = cfg.code2wav.startup_samples if cfg.codec_arch == "code2wav" else 0
    with wave.open(os.path.join(temp_dir, "audio_000.wav"), "rb") as w:
        n = w.getnframes()
        pcm = np.frombuffer(w.readframes(n), dtype="<i2")
    unstretched = m["frames"] * cfg.codec.hop - skip
    if speed == 1.0:
        assert n == unstretched
    else:
        assert abs(n - unstretched / speed) < 0.1 * unstretched
        assert n == round(m["audio_s"] * cfg.codec.sample_rate)
    assert m["frames"] > 0 and pcm.any()


def test_a_checkpoint_directory_loads_and_its_cloning_names_item_12(temp_dir):
    """What raised for items 10 and 12 runs: a missing path is not found;
    the fixture's Mimi speech tokenizer maps (no warning), and the loaded
    directory clones through it and speaks with a preset voice."""
    from qwen3_tts_tpu_torch.engine.fabricate import fabricate_full_checkpoint

    with pytest.raises(FileNotFoundError):
        tapi.load_model(os.path.join(temp_dir, "absent"), device="cpu")
    snap = fabricate_full_checkpoint(os.path.join(temp_dir, "snap"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        model = tapi.load_model(snap, device="cpu")
    assert model.import_report.unmapped == []
    assert model.import_report.speech_tokenizer["family"] == "mimi"
    assert model.st_params is not None
    m = tapi.generate_audio(model=model, text=TEXT, output_path=temp_dir,
                            ref_audio=_reference_wav(temp_dir),
                            ref_text="A reference transcript.", max_frames=4)
    assert m["frames"] > 0
    m = tapi.generate_audio(model=model, text=TEXT, voice="ryan",
                            output_path=temp_dir, max_frames=4)
    assert m["frames"] > 0


@pytest.mark.parametrize("build", [
    lambda: tapi.load_model("synthetic:tiny-code2wav", device="cpu"),
    lambda: tapi.Qwen3TTSModel.synthetic(tcfgs.tiny_feedback(), device="cpu"),
    lambda: tapi.Qwen3TTSModel.synthetic(tcfgs.with_code2wav(
        tcfgs.tiny_feedback(), tcfgs.tiny_code2wav().code2wav), device="cpu"),
], ids=["code2wav", "residual_sum", "residual_sum_code2wav"])
def test_code2wav_and_the_published_protocol_run_through_generate_audio(
        build, temp_dir):
    """What used to raise (ROADMAP items 8 and 9 at one frame a step) now
    writes its WAV: frames x hop samples, less the code2wav decoder's
    startup run-in."""
    model = build()
    m = tapi.generate_audio(model=model, text=TEXT, voice="ryan",
                            output_path=temp_dir, max_frames=12)
    cfg = model.cfg
    skip = cfg.code2wav.startup_samples if cfg.codec_arch == "code2wav" else 0
    with wave.open(os.path.join(temp_dir, "audio_000.wav"), "rb") as w:
        assert w.getnframes() == m["frames"] * cfg.codec.hop - skip
        pcm = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
    assert m["frames"] > 0 and pcm.any()


def test_compute_format_auto_is_int8(monkeypatch):
    monkeypatch.delenv("QWEN3_TTS_COMPUTE", raising=False)
    assert tapi.compute_format() == "int8"
    monkeypatch.setenv("QWEN3_TTS_COMPUTE", "bf16")
    model = tapi.load_model("synthetic:tiny", device="cpu")
    assert set(model.params["head"]) == {"w"}
    monkeypatch.setenv("QWEN3_TTS_COMPUTE", "INT8")
    with pytest.raises(ValueError):
        tapi.compute_format()


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "qwen3_tts_tpu"), (path, name)


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """No CUDA here: chip_smoke.py exits non-zero and prints no result, in
    the repository and alone in an empty directory."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    for script in (ROOT / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                              capture_output=True, text=True, timeout=120,
                              env=env)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout



JAX_PKG = ROOT / "src" / "qwen3_tts_tpu"
# JAX names the port holds under another name, or in another module:
# "module::name" -> "port module::name" (a class's members follow it)
MAPPED = {
    "ops/linear.py::quantized_matmul":
        "ops/dequant_matmul.py::quantized_matmul",
    "ops/linear.py::quantized_matmul_xla":
        "ops/dequant_matmul.py::quantized_matmul_ref",
    "ops/pallas_matmul.py::quantized_matmul_pallas":
        "ops/dequant_matmul.py::dequant_matmul_cuda",
    "ops/pallas_matmul.py::pallas_compatible":
        "ops/dequant_matmul.py::plan_kernel_b",
    "ops/grouped_qmv.py::quantized_matmul_grouped_xla":
        "ops/grouped_qmv.py::quantized_matmul_grouped_ref",
    "ops/grouped_qmv.py::pallas_grouped_compatible":
        "ops/grouped_qmv.py::plan_kernel_a",
    "models/code2wav.py::Code2WavConfig": "engine/configs.py::Code2WavConfig",
    # transformer_block returns the block's output (the caches are written
    # in place); the JAX BlockOut also carries the caches
    "models/layers.py::BlockOut": "models/layers.py::transformer_block",
}
# JAX names whose absence a departure of ROADMAP.md §C records, cited by
# its words
DEPARTED = {
    "engine/__init__.py::enable_compilation_cache":
        "*No compilation cache*, because eager PyTorch compiles nothing.",
    "ops/__init__.py::default_backend":
        "**The kernel follows the tensor's device.**",
    "ops/__init__.py::use_pallas":
        "**The kernel follows the tensor's device.**",
    "profiling.py::StageTimer": "**No `StageTimer` and no `profile_to`.**",
    "profiling.py::StageTimer.stage":
        "**No `StageTimer` and no `profile_to`.**",
    "profiling.py::StageTimer.summary":
        "**No `StageTimer` and no `profile_to`.**",
    "profiling.py::profile_to": "**No `StageTimer` and no `profile_to`.**",
}


def _public_names(path: Path) -> set:
    """Top-level functions, classes and UPPER constants, and the methods
    and properties of the classes, of one module (read with ast)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{m.name}" for m in node.body
                           if isinstance(m, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))
                           and not m.name.startswith("_"))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            out.update(t.id for t in targets if isinstance(t, ast.Name)
                       and t.id.isupper() and not t.id.startswith("_"))
    return out


def test_every_public_name_of_the_jax_package_has_a_counterpart():
    """Every public name of every JAX module (functions, classes, their
    methods and properties, UPPER constants) is in the port's module of
    the same path, or MAPPED to a port name that exists, or DEPARTED with
    words that ROADMAP.md §C holds. Both packages are read with ast;
    neither is imported."""
    roadmap = " ".join((ROOT / "ROADMAP.md").read_text().split())
    section_c = roadmap[roadmap.index("### C."):roadmap.index("## Recent")]
    port_names: dict = {}

    def port(rel: str) -> set:
        if rel not in port_names:
            path = PORT / rel
            port_names[rel] = _public_names(path) if path.exists() else set()
        return port_names[rel]

    missing = []
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).as_posix()
        for name in sorted(_public_names(path) - port(rel)):
            owner, _, member = name.partition(".")
            key = f"{rel}::{owner}"
            if key in MAPPED:
                target_rel, target = MAPPED[key].split("::")
                want = f"{target}.{member}" if member else target
                assert want in port(target_rel), (name, MAPPED[key])
            elif f"{rel}::{name}" in DEPARTED:
                words = DEPARTED[f"{rel}::{name}"]
                assert words in section_c, (name, words)
            else:
                missing.append(f"{rel}::{name}")
    assert not missing, missing
    # no stale entry: each names a JAX name the port's module lacks
    for key in list(MAPPED) + list(DEPARTED):
        rel, name = key.split("::")
        assert name in _public_names(JAX_PKG / rel) - port(rel), key
