"""The plain reference against the program at a tiny float32 size on the
CPU, and the check's verdict on runs with the timed path broken."""

import time

import numpy as np
import pytest
import torch

from tiny import LIMITS, SEED, TINY, TINY_DENSE, family, make_root

from harness.bench import run_cell
from harness.program import build_model, port_config
from reference import model as ref
from reference.prompt import text_tokens
from reference.quant import REFERENCE

PORT = family("port_geometry")


@pytest.fixture(scope="module")
def tiny_model():
    torch.manual_seed(0)
    raw = PORT.weights.make_weights(TINY, SEED, "cpu")
    return raw, build_model(TINY, port_config(TINY), raw, torch.device("cpu"))


@pytest.mark.parametrize("text,instruct,voice", [
    ("Hello there, friend.", None, "ryan"),
    ("A much longer sentence about the river and the quiet village " * 2,
     "Whispering quietly", "sohee"),
    ("Hi.", "Angry and shouting", "eric"),
])
def test_prompt_rows_equal_the_programs(tiny_model, text, instruct, voice):
    from qwen3_tts_tpu_torch.engine import prepare_segments

    raw, model = tiny_model
    prompt = prepare_segments(model, text, voice=voice, instruct=instruct)[0][0]
    emb, pad, trailing = model.generator.assemble_prompt_full(prompt)
    toks = text_tokens(text, instruct)
    assert list(prompt.text_tokens) == toks
    rows, buf = PORT.reference.assemble(raw["talker"], TINY["talker"], toks,
                                        TINY["speakers"].index(voice))
    assert torch.equal(emb[0, pad:], rows)
    assert torch.equal(trailing[0], buf)


def test_code2wav_reference_equals_the_programs_stream(tiny_model):
    from qwen3_tts_tpu_torch.models.code2wav import (code2wav_stream_step,
                                                     stream_state_init)

    raw, model = tiny_model
    c = model.cfg.code2wav
    params = model.generator.codec_params["c2w"]
    codes = torch.randint(0, c.codebook_size, (1, c.num_quantizers, 44))
    state = stream_state_init(c, 1, dtype=torch.float32)
    out, pos = [], 0
    for n in (4, 32, 8):
        wav, state = code2wav_stream_step(params, c, state,
                                          codes[:, :, pos:pos + n], pos)
        out.append(wav[0])
        pos += n
    stream = torch.cat(out)[c.startup_samples:]
    with torch.no_grad():
        want = ref.code2wav(ref.Weights(raw, REFERENCE), TINY["code2wav"],
                            codes[0])
    assert stream.shape == want.shape
    assert float((stream - want).abs().max()) < 1e-5


def _run(tmp_path, control=None, config=TINY):
    root = make_root(str(tmp_path), config)
    return run_cell(root, "tiny", SEED, 2.0, False, time.perf_counter(),
                    device="cpu", control=control)


def test_a_sound_run_is_correct_and_its_control_is_not(tmp_path):
    result, lines = _run(tmp_path / "sound")
    assert result["correct"], lines
    assert result["check"]["requests"]["value"] == 3
    assert result["check"]["talker_gap"]["value"] <= 1e-5
    assert result["check"]["pcm_err"]["value"] <= 1e-4
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "check"]
    assert lines[-1].startswith("check frames_short")
    assert lines[1].startswith("host steps")
    # the control (bfloat16 activations, 4-bit linears, float8 tables) in
    # the program's place: the harness's own verdict is false, and every
    # number that reads a precision is over its limit
    result, lines = _run(tmp_path / "control", control="lower")
    assert result["correct"] is False, lines
    ctl = result["control"]
    assert ctl["name"] == "lower"
    for k in ("talker_gap", "predictor_gap", "talker_gap_mean",
              "predictor_gap_mean", "pcm_err"):
        assert ctl[k] > LIMITS[k], (k, ctl[k])
        assert result["check"][k]["value"] == ctl[k]
        assert result["program"][k] <= LIMITS[k], (k, result["program"][k])
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "control", "program", "check"]
    assert lines[-1].startswith("check frames_short")


def test_the_int8_control_of_a_dense_configuration_is_not_correct(tmp_path):
    result, lines = _run(tmp_path, control="int8", config=TINY_DENSE)
    assert result["correct"] is False, lines
    prog, ctl = result["program"], result["control"]
    assert ctl["name"] == "int8"
    # at this size the tokens' margins are wide, so only the waveform
    # shows the control; at the cells' size the mean gaps do (PERF.md)
    assert prog["pcm_err"] <= LIMITS["pcm_err"] < ctl["pcm_err"]


def test_the_judge_takes_the_widest_and_the_mean_gap():
    from harness.check import Judge

    j = Judge()
    logits = torch.tensor([[0.0, 1.0, 3.0], [2.0, 0.5, 0.0]])
    j.add("talker", logits, torch.tensor([2, 1]))        # gaps 0 and 1.5
    j.add("talker", logits[:1], torch.tensor([0]))       # gap 3
    n = j.numbers()
    assert n["talker_gap"] == 3.0
    assert n["talker_gap_mean"] == pytest.approx(4.5 / 3)
    assert n["predictor_gap"] == 0.0 and n["predictor_gap_mean"] == 0.0


def test_the_int8_control_needs_a_dense_configuration(tmp_path):
    with pytest.raises(ValueError, match="dense configuration"):
        _run(tmp_path, control="int8")


def _alter_tokens(mp):
    from qwen3_tts_tpu_torch.runtime import generate

    orig = generate.sample_token

    def sample_token(logits, gen, cfg):
        out = orig(logits, gen, cfg)
        odd = torch.arange(out.shape[0], device=out.device) % 2 == 1
        return torch.where(odd, (out + 1) % 64, out)

    mp.setattr(generate, "sample_token", sample_token)


def _kv_unchanged(mp):
    from qwen3_tts_tpu_torch.models import layers

    orig = layers._write_rows

    def write_rows(cache, new, pos):
        if new.shape[1] > 1:             # the prefill writes; decode does not
            orig(cache, new, pos)

    mp.setattr(layers, "_write_rows", write_rows)


def _codec_state_unchanged(mp):
    from qwen3_tts_tpu_torch.models import codec

    orig = codec.code2wav_stream_step

    def step(params, cfg, state, codes, pos):
        wav, _ = orig(params, cfg, state, codes, pos)
        return wav, state

    mp.setattr(codec, "code2wav_stream_step", step)


def _alter_pcm(mp):
    from qwen3_tts_tpu_torch.runtime import generate

    orig = generate.wav_to_pcm16
    mp.setattr(generate, "wav_to_pcm16", lambda x: orig(x * 0.98))


@pytest.mark.parametrize("fault", [_alter_tokens, _kv_unchanged,
                                   _codec_state_unchanged, _alter_pcm],
                         ids=["token_altered", "kv_state_unchanged",
                              "codec_state_unchanged", "pcm_altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    result, lines = _run(tmp_path)
    assert not result["correct"], lines


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card_is_correct(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = make_root(str(tmp_path))
    result, lines = run_cell(root, "tiny", SEED, 2.0, False,
                             time.perf_counter(), device="cuda")
    assert result["device"]["platform"] == "gpu"
    assert result["check"]["frames_short"]["value"] == 0
    assert np.isfinite(result["check"]["pcm_err"]["value"])
