"""The port's fine-tuning CLI (qwen3_tts_tpu_torch.finetune) on the CPU:
ports of the single-device cases of tests/test_finetune_cli.py and of
tests/test_freeze_base.py, every error path with the JAX CLI's message and
exit code, and exports that the JAX package's load_native reads with the
port's greedy codes at float32 (the native format is shared)."""

import dataclasses
import json
import os
import wave

import numpy as np
import pytest
import torch

from qwen3_tts_tpu.engine import configs as jcfgs
from qwen3_tts_tpu.engine.api import Qwen3TTSModel as JaxModel
from qwen3_tts_tpu.engine.weights import load_native as jax_load_native
from qwen3_tts_tpu.engine.weights import save_model as jax_save_model
from qwen3_tts_tpu.quality import variant_model as jax_variant_model
from qwen3_tts_tpu.runtime.prompts import PromptSpec as JaxPrompt
from qwen3_tts_tpu.runtime.sampling import SamplingConfig as JaxSampling
from qwen3_tts_tpu_torch import finetune
from qwen3_tts_tpu_torch.engine.api import generate_audio, load_model
from qwen3_tts_tpu_torch.quality import variant_model
from qwen3_tts_tpu_torch.runtime.prompts import PromptSpec
from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig
from qwen3_tts_tpu_torch.runtime.serving import ServingEngine
from qwen3_tts_tpu_torch.training.train import tree_leaves
from torch_port_helpers import one_torch_thread  # noqa: F401

GREEDY = SamplingConfig(greedy=True)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("QWEN3_TTS_CPU", "1")


def _write_pair(d, name, text, seconds=0.4, sr=24_000, freq=330):
    t = np.arange(int(seconds * sr))
    pcm = (np.sin(2 * np.pi * freq * t / sr) * 9000).astype(np.int16)
    with wave.open(os.path.join(d, f"{name}.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    if text is not None:
        with open(os.path.join(d, f"{name}.txt"), "w") as fh:
            fh.write(text + "\n")


def _make_data(d):
    os.makedirs(d, exist_ok=True)
    for i in range(4):
        _write_pair(d, f"clip{i}", f"utterance number {i}",
                    seconds=0.3 + 0.1 * i, freq=220 + 60 * i)
    return d


@pytest.fixture()
def data_dir(tmp_path):
    return _make_data(str(tmp_path / "data"))


def _summary(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_load_pairs_skips_untranscribed(tmp_path):
    d = str(tmp_path)
    _write_pair(d, "good", "hello there")
    _write_pair(d, "no_txt", None)
    _write_pair(d, "dot", ".")
    _write_pair(d, "empty", "")
    with pytest.warns(UserWarning, match="without a usable transcript"):
        pairs = finetune.load_pairs(d)
    assert len(pairs) == 1
    text, wav, rate = pairs[0]
    assert text == "hello there" and rate == 24_000
    assert wav.dtype == np.float32 and np.abs(wav).max() <= 1.0


def test_full_finetune_with_resume_and_export(data_dir, tmp_path, capsys):
    ckpt = str(tmp_path / "ckpts")
    export = str(tmp_path / "tuned_model")
    base_args = ["--model", "synthetic-tiny", "--data", data_dir,
                 "--batch-size", "4", "--lr", "1e-3",
                 "--ckpt-dir", ckpt, "--save-every", "2"]
    assert finetune.main(base_args + ["--steps", "2"]) == 0
    first = _summary(capsys)
    assert first["steps"] == 2 and first["final_loss"] is not None

    rc = finetune.main(base_args + ["--steps", "4", "--resume",
                                    "--export", export])
    assert rc == 0
    out = capsys.readouterr().out
    assert "resumed from" in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["exported"] == export
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000004"]

    # an uninterrupted 4-step run ends at the resumed run's loss
    assert finetune.main(base_args[:-4] + ["--steps", "4"]) == 0
    assert _summary(capsys)["final_loss"] == pytest.approx(
        summary["final_loss"], rel=1e-6)

    model = load_model(export, device="cpu")
    outdir = str(tmp_path / "gen")
    metrics = generate_audio(model=model, text="post finetune synthesis",
                             voice=sorted(model.cfg.speakers)[0],
                             output_path=outdir, max_frames=12)
    assert os.path.exists(os.path.join(outdir, "audio_000.wav"))
    assert metrics["audio_s"] > 0


def test_lora_finetune_exports_merged_model(data_dir, tmp_path, capsys):
    export = str(tmp_path / "lora_model")
    ckpt = str(tmp_path / "ck")
    rc = finetune.main(["--model", "synthetic-tiny", "--data", data_dir,
                        "--batch-size", "4", "--steps", "2", "--lora", "2",
                        "--lr", "1e-2", "--export", export,
                        "--ckpt-dir", ckpt])
    assert rc == 0
    assert _summary(capsys)["final_loss"] is not None
    model = load_model(export, device="cpu")
    assert not any("lora" in p for p, _ in tree_leaves(model.params))
    assert os.listdir(ckpt) == ["step_00000002"]
    rc = finetune.main(["--model", "synthetic-tiny", "--data", data_dir,
                        "--batch-size", "4", "--steps", "3", "--lora", "2",
                        "--ckpt-dir", ckpt, "--resume"])
    assert rc == 0
    assert "resumed LoRA state from" in capsys.readouterr().out


def _err(capsys) -> str:
    return capsys.readouterr().err


@pytest.mark.parametrize("extra,message", [
    (["--lora", "2", "--pp", "2"], "full fine-tune path only"),
    (["--pp", "2"], "must divide both the device count (1)"),
    (["--pp", "0"], "must be >= 1"),
    (["--microbatches", "4"], "only applies with --pp"),
    (["--sequence-parallel"], "needs tp > 1 (mesh has tp=1)"),
    (["--depth-group", "2"], "depth_group"),
    (["--freeze-base"], "needs --mtp-fps N"),
    (["--freeze-base", "--mtp-fps", "2", "--lora", "2"], "use one or the other"),
    (["--freeze-base", "--mtp-fps", "2", "--anchor", "0.1"], "pointless"),
    (["--lora", "2", "--distill", "0.1"], "full fine-tune path only"),
    (["--mtp-cp-batch"], "--mtp-cp-batch needs frames_per_step > 1"),
    (["--batch-size", "8"], "dataset smaller than one batch"),
], ids=["lora_pp", "pp_indivisible", "pp_zero", "microbatches", "sp",
        "bad_divisor", "freeze_alone", "freeze_lora", "freeze_anchor",
        "lora_distill", "cpb_alone", "batch_size"])
def test_error_paths(data_dir, capsys, extra, message):
    args = ["--model", "synthetic-tiny", "--data", data_dir,
            "--batch-size", "4", "--steps", "1"] + extra
    assert finetune.main(args) == 1
    assert message in _err(capsys)


def test_spec_flag_requires_grouped_draft(data_dir, capsys):
    rc = finetune.main(["--model", "synthetic-tiny-feedback", "--data",
                        data_dir, "--batch-size", "4", "--steps", "1",
                        "--spec"])
    assert rc == 1
    assert "--spec needs a grouped draft" in _err(capsys)


def test_empty_data_dir_errors(tmp_path, capsys):
    d = str(tmp_path / "empty")
    os.makedirs(d)
    rc = finetune.main(["--model", "synthetic-tiny", "--data", d,
                        "--steps", "1", "--batch-size", "4"])
    assert rc == 1
    assert "no usable" in _err(capsys)


def test_batch_size_divides_the_one_device(data_dir, capsys):
    """dp is 1 on one device: any batch size divides it (the JAX test's
    3-on-8-devices failure has no single-device counterpart)."""
    rc = finetune.main(["--model", "synthetic-tiny", "--data", data_dir,
                        "--batch-size", "3", "--steps", "1"])
    assert rc == 0
    assert "dp=1" in capsys.readouterr().out


def test_quantized_base_is_refused_unless_dequantized(data_dir, capsys,
                                                      monkeypatch):
    """An int8 tree is refused with the JAX CLI's message; loaded with
    QWEN3_TTS_COMPUTE=bf16 its trees are dense and it trains, exporting
    a dense config."""
    rc = finetune.main(["--model", "synthetic:tiny", "--data", data_dir,
                        "--batch-size", "4", "--steps", "1"])
    assert rc == 1
    assert "needs an unquantized base" in _err(capsys)
    monkeypatch.setenv("QWEN3_TTS_COMPUTE", "bf16")
    export = os.path.join(data_dir, "..", "deq")
    assert finetune.main(["--model", "synthetic:tiny", "--data", data_dir,
                          "--batch-size", "4", "--steps", "1",
                          "--export", export]) == 0
    assert not load_model(export, device="cpu").cfg.quant.enabled


def test_step_metrics_lines(data_dir, capsys, monkeypatch):
    monkeypatch.setenv("QWEN3_TTS_METRICS", "1")
    assert finetune.main(["--model", "synthetic-tiny", "--data", data_dir,
                          "--batch-size", "4", "--steps", "2"]) == 0
    lines = [json.loads(ln) for ln in _err(capsys).splitlines()
             if '"finetune_step"' in ln]
    assert [ln["step"] for ln in lines] == [1, 2]
    assert all(ln["frames"] > 0 and ln["step_s"] > 0 and
               np.isfinite(ln["grad_norm"]) for ln in lines)


def test_eval_quality_decodes_the_tuned_weights(data_dir, capsys,
                                                monkeypatch):
    """--eval-quality runs on the model the loop tuned: its trees are the
    trained ones, free of autograd flags, with no decode-layout copies
    made before training."""
    import qwen3_tts_tpu_torch.quality as quality

    seen = {}

    def fake(model, variants, texts, transcribe, *, voice="ryan"):
        seen["generator"] = model._generator
        seen["serving"] = model._serving
        seen["grad"] = any(v.requires_grad for _, v in
                           tree_leaves([model.params, model.cp_params]))
        seen["mtp"] = "mtp" in model.params
        seen["variants"] = variants
        v = {"median_wer_delta": None, "median_mel_dist": 0.0,
             "median_identical_frac": 1.0}
        return {"variants": {"trained_shape": v}}

    monkeypatch.setattr(quality, "compare_decode_configs", fake)
    rc = finetune.main(["--model", "synthetic-tiny", "--data", data_dir,
                        "--batch-size", "4", "--steps", "1",
                        "--mtp-fps", "2", "--eval-quality"])
    assert rc == 0
    summary = _summary(capsys)
    assert summary["quality"]["decode_shape"]["fps"] == 2
    assert seen == {"generator": None, "serving": None, "grad": False,
                    "mtp": True, "variants": {"trained_shape":
                                              {"fps": 2, "dg": 1}}}


def test_decode_extension_flags_train_and_export(data_dir, tmp_path, capsys):
    export = str(tmp_path / "tuned_ext")
    rc = finetune.main(["--model", "synthetic-tiny", "--data", data_dir,
                        "--batch-size", "4", "--steps", "1", "--lr", "1e-3",
                        "--mtp-fps", "2", "--depth-group", "3",
                        "--export", export])
    assert rc == 0
    assert _summary(capsys)["exported"] == export
    model = load_model(export, device="cpu")
    assert model.cfg.talker.frames_per_step == 2
    assert model.cfg.code_predictor.depth_group == 3
    assert "mtp" in model.params
    outdir = str(tmp_path / "gen_ext")
    generate_audio(model=model, text="extended decode", voice="ryan",
                   output_path=outdir, max_frames=8)
    assert os.path.exists(os.path.join(outdir, "audio_000.wav"))


def test_spec_flag_exports_lossless_decode(data_dir, tmp_path, capsys):
    export = str(tmp_path / "tuned_spec")
    rc = finetune.main(["--model", "synthetic-tiny-feedback", "--data",
                        data_dir, "--batch-size", "4", "--steps", "1",
                        "--lr", "1e-3", "--depth-group", "3", "--spec",
                        "--export", export])
    assert rc == 0
    assert _summary(capsys)["exported"] == export
    model = load_model(export, device="cpu")
    assert model.cfg.code_predictor.spec_decode is True
    assert model.cfg.code_predictor.depth_group == 3
    model.sampling = GREEDY
    p = PromptSpec(text_tokens=np.arange(6, dtype=np.int32) + 5, speaker_id=1)
    r_spec = model.generator.synthesize(p, max_frames=6, seed=0)
    base = variant_model(model, {"dg": 1, "spec": False})
    base.sampling = GREEDY
    r_base = base.generator.synthesize(p, max_frames=6, seed=0)
    np.testing.assert_array_equal(r_spec.wav, r_base.wav)


def test_feedback_protocol_finetune_recovery_shape(data_dir, tmp_path,
                                                   capsys):
    export = str(tmp_path / "tuned_fb")
    rc = finetune.main(["--model", "synthetic-tiny-feedback", "--data",
                        data_dir, "--batch-size", "4", "--steps", "1",
                        "--lr", "1e-3", "--mtp-fps", "2", "--mtp-cp-batch",
                        "--depth-group", "3", "--export", export])
    assert rc == 0
    assert _summary(capsys)["exported"] == export
    model = load_model(export, device="cpu")
    assert model.cfg.talker.feedback == "residual_sum"
    assert model.cfg.talker.frames_per_step == 2
    assert model.cfg.talker.mtp_cp_batch
    assert model.cfg.code_predictor.depth_group == 3
    outdir = str(tmp_path / "gen_fb")
    generate_audio(model=model, text="protocol recovery", voice="ryan",
                   output_path=outdir, max_frames=8)
    assert os.path.exists(os.path.join(outdir, "audio_000.wav"))


def test_freeze_base_recovery_on_an_imported_code2wav_snapshot(
        tmp_path, capsys, monkeypatch):
    """A user's recovery path: a published-layout snapshot (int8, code2wav,
    a Mimi speech tokenizer) loaded with QWEN3_TTS_COMPUTE=bf16, MTP heads
    grafted and trained with --freeze-base: every leaf outside ``mtp``
    equals the loaded tree's bit for bit, the grafted linears moved, and
    the dense export decodes at fps 2 (the JAX package's encode_reference
    raises on a code2wav tree, so it cannot take this path)."""
    from qwen3_tts_tpu_torch.engine import configs
    from qwen3_tts_tpu_torch.engine.fabricate import write_published_snapshot
    from qwen3_tts_tpu_torch.models.talker import add_mtp_params

    cfg = configs.with_quant(configs.with_code2wav(
        configs.tiny_feedback(), configs.tiny_code2wav().code2wav), True)
    snap, export = str(tmp_path / "snap"), str(tmp_path / "rec")
    write_published_snapshot(snap, cfg, seed=0, speech_tokenizer=True)
    data = _make_data(str(tmp_path / "data"))
    monkeypatch.setenv("QWEN3_TTS_COMPUTE", "bf16")
    assert finetune.main(["--model", snap, "--data", data, "--mtp-fps", "2",
                          "--mtp-cp-batch", "--freeze-base", "--steps", "2",
                          "--batch-size", "4", "--lr", "1e-3",
                          "--export", export]) == 0
    assert _summary(capsys)["exported"] == export
    base, tuned = load_model(snap, device="cpu"), load_model(export,
                                                             device="cpu")
    assert base.st_params is not None and tuned.st_params is not None
    assert not tuned.cfg.quant.enabled and tuned.cfg.talker.mtp_cp_batch
    for name in ("params", "cp_params", "codec_params"):
        assert not _moved_leaves(getattr(base, name), getattr(tuned, name),
                                 skip=("mtp",)), name
    grafted = add_mtp_params(
        base.params, configs.with_frames_per_step(base.cfg, 2), seed=0)["mtp"]
    assert _moved_leaves(grafted, tuned.params["mtp"])
    outdir = str(tmp_path / "gen")
    m = generate_audio(model=tuned, text="recovered decode", voice=None,
                       output_path=outdir, max_frames=8)
    assert tuned.cfg.talker.frames_per_step == 2 and m["frames"] > 0


# ports of tests/test_freeze_base.py, on float32 trees the JAX package
# wrote, so that its load_native can decode the port's exports ---------------

def _moved_leaves(a, b, skip: tuple = ()):
    fa, fb = dict(tree_leaves(a)), dict(tree_leaves(b))
    return [k for k in fa if not any(s in k for s in skip)
            and k in fb and not torch.equal(fa[k], fb[k])]


@pytest.fixture(scope="module")
def recovery(tmp_path_factory):
    """A JAX-written float32 tiny_feedback base, a full fine-tune export
    of it, and a freeze-base recovery export (fps=2, dg=3, spec)."""
    work = tmp_path_factory.mktemp("freeze_base")
    data = _make_data(str(work / "data"))
    raw = str(work / "raw")
    jax_save_model(JaxModel.synthetic(dataclasses.replace(
        jcfgs.tiny_feedback(), dtype="float32"), seed=0), raw)
    base_d, rec_d = str(work / "base"), str(work / "rec")
    mp = pytest.MonkeyPatch()
    mp.setenv("QWEN3_TTS_CPU", "1")
    try:
        assert finetune.main([
            "--model", raw, "--data", data, "--steps", "3",
            "--batch-size", "4", "--lr", "1e-3", "--export", base_d]) == 0
        assert finetune.main([
            "--model", base_d, "--data", data, "--steps", "3",
            "--batch-size", "4", "--lr", "3e-4", "--freeze-base",
            "--mtp-fps", "2", "--depth-group", "3", "--spec",
            "--export", rec_d]) == 0
    finally:
        mp.undo()
    return base_d, rec_d


def _load(path):
    m = load_model(path, device="cpu")
    m.sampling = GREEDY
    return m


def test_base_weights_bit_identical(recovery):
    base_d, rec_d = recovery
    base, rec = _load(base_d), _load(rec_d)
    assert "draft" in rec.cp_params
    assert not _moved_leaves(base.params, rec.params, skip=("mtp",))
    assert not _moved_leaves(base.cp_params, rec.cp_params, skip=("draft",))


def test_recovery_params_actually_trained(recovery):
    base_d, rec_d = recovery
    rec = _load(rec_d)
    draft_init = {k: v for k, v in rec.cp_params.items() if k != "draft"}
    assert _moved_leaves(draft_init, rec.cp_params["draft"])
    assert "mtp" in rec.params and "mtp" not in _load(base_d).params


def test_spec_decode_bit_exact_vs_raw_base(recovery):
    base_d, rec_d = recovery
    base, rec = _load(base_d), _load(rec_d)
    p = PromptSpec(text_tokens=np.arange(8, dtype=np.int32) + 3, speaker_id=1)
    r_base = base.generator.synthesize(p, max_frames=6, seed=0,
                                       collect_codes=True)
    spec_view = variant_model(rec, {"fps": 1})  # dg=3+spec from training
    spec_view.sampling = GREEDY
    r_spec = spec_view.generator.synthesize(p, max_frames=6, seed=0,
                                            collect_codes=True)
    assert r_base.frames == r_spec.frames
    np.testing.assert_array_equal(r_base.codes, r_spec.codes)
    np.testing.assert_array_equal(r_base.wav, r_spec.wav)


def test_grouped_decode_reads_draft(recovery):
    _, rec_d = recovery
    p = PromptSpec(text_tokens=np.arange(8, dtype=np.int32) + 5, speaker_id=0)

    def codes(model, opts):
        view = variant_model(model, opts)
        view.sampling = GREEDY
        return view.generator.synthesize(p, max_frames=4, seed=0,
                                         collect_codes=True).codes

    rec = _load(rec_d)
    rec2 = _load(rec_d)
    rec2.cp_params = {**rec2.cp_params, "draft": {
        **rec2.cp_params["draft"],
        "heads": torch.zeros_like(rec2.cp_params["draft"]["heads"])}}
    dg = {"fps": 1, "spec": False}
    assert not np.array_equal(codes(rec, dg), codes(rec2, dg))
    seq = {"fps": 1, "dg": 1, "spec": False}
    np.testing.assert_array_equal(codes(rec, seq), codes(rec2, seq))


def test_serving_draft_model_matches_single_stream(recovery):
    _, rec_d = recovery
    view = variant_model(_load(rec_d), {"fps": 1})
    view.sampling = GREEDY
    prompts = [PromptSpec(text_tokens=np.arange(8, dtype=np.int32) + s,
                          speaker_id=s % 4) for s in (2, 5)]
    singles = [view.generator.synthesize(q, max_frames=6, seed=0,
                                         collect_codes=True)
               for q in prompts]
    eng = ServingEngine(view, max_streams=2, chunk=4, sampling=GREEDY)
    for r, (_, stream) in zip(singles, eng.run(prompts, max_frames=6)):
        assert stream.frames == r.frames
        np.testing.assert_array_equal(
            np.concatenate(stream.codes, axis=1)[:, :r.frames], r.codes)


@pytest.mark.parametrize("opts", [
    {"fps": 1, "spec": False},   # grouped depth through the draft
    {"fps": 2, "spec": False},   # MTP chain + draft
    {"fps": 2},                  # the trained shape: fps 2, dg 3 + spec
], ids=["dg3_draft", "fps2_dg3", "fps2_spec"])
def test_recovery_export_decodes_equal_in_jax(recovery, opts):
    """The port's export loads in the JAX package's load_native and its
    greedy codes there equal the port's at float32, through the grafted
    MTP heads and the draft adapter."""
    _, rec_d = recovery
    jm = jax_load_native(rec_d)
    jview = jax_variant_model(jm, opts)
    jview.sampling = JaxSampling(greedy=True)
    view = variant_model(_load(rec_d), opts)
    view.sampling = GREEDY
    kw = dict(text_tokens=np.arange(8, dtype=np.int32) + 4, speaker_id=2)
    want = jview.generator.synthesize(JaxPrompt(**kw), max_frames=8, seed=0,
                                      collect_codes=True)
    got = view.generator.synthesize(PromptSpec(**kw), max_frames=8, seed=0,
                                    collect_codes=True)
    assert got.frames == want.frames > 0
    np.testing.assert_array_equal(got.codes, want.codes)
