"""The port's checkpoint import (engine/safetensors_io.py, engine/weights.py,
engine/tokenizer.py, runtime/prompts.py, ops/quant.py::unpack_mlx_uint32)
against the JAX package and the ``safetensors`` package, on tiny snapshots:
imported trees must equal the JAX importer's bit for bit (bf16 through a
uint16 view), with equal import reports."""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_numpy
from safetensors.numpy import save_file as st_save_numpy
from safetensors.torch import load_file as st_load_torch
from safetensors.torch import save_file as st_save_torch

from qwen3_tts_tpu.engine import configs as jcfgs
from qwen3_tts_tpu.engine import fabricate as jfab
from qwen3_tts_tpu.engine import weights as jw
from qwen3_tts_tpu.ops.quant import unpack_mlx_uint32 as jax_unpack
from qwen3_tts_tpu.runtime import prompts as jprompts
from qwen3_tts_tpu_torch.engine import configs as tcfgs
from qwen3_tts_tpu_torch.engine import fabricate as tfab
from qwen3_tts_tpu_torch.engine import safetensors_io as sio
from qwen3_tts_tpu_torch.engine import weights as tw
from qwen3_tts_tpu_torch.ops.quant import unpack_mlx_uint32
from qwen3_tts_tpu_torch.runtime import prompts as tprompts
from test_code2wav import _tiny_cfgs, _torch_model
from test_weights import _feedback_cfg_and_extras
from torch_port_helpers import assert_trees_equal, leaf_bits


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


def _published_cfg():
    """The tiny residual_sum + code2wav config (quantized)."""
    cfg = tcfgs.with_code2wav(tcfgs.tiny_feedback(), tcfgs.tiny_code2wav().code2wav)
    return dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant,
                                                              enabled=True))


# -- safetensors_io -----------------------------------------------------------

def test_reader_equals_safetensors_on_the_jax_fabricators_files(temp_dir):
    """U32 codes, F32 tables: the same names, dtypes and values."""
    jfab.write_mlx_style_checkpoint(temp_dir, jcfgs.tiny(quant=True), full=True)
    path = os.path.join(temp_dir, "model.safetensors")
    want = st_load_numpy(path)
    got = sio.load_file(path)
    assert sorted(got) == sorted(want)
    assert {str(t.dtype) for t in got.values()} == {"torch.uint32",
                                                     "torch.float32"}
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name].numpy(), arr)


def test_reader_reads_bf16_and_writer_round_trips_through_safetensors(temp_dir):
    rng = np.random.default_rng(0)
    tensors = {
        "bf": torch.from_numpy(rng.normal(size=(5, 7)).astype(np.float32)
                               ).to(torch.bfloat16),
        "f16": torch.ones(3, dtype=torch.float16),
        "i64": torch.arange(4),
        "u8": torch.arange(5, dtype=torch.uint8),
        "b": torch.tensor([True, False]),
        "f64": torch.tensor([1.5], dtype=torch.float64),
        "scalar": torch.tensor(2.0),
    }
    theirs = os.path.join(temp_dir, "theirs.safetensors")
    st_save_torch(tensors, theirs)
    got = sio.load_file(theirs)
    assert leaf_bits(got) == leaf_bits(tensors)

    ours = os.path.join(temp_dir, "ours.safetensors")
    sio.save_file(tensors, ours)
    assert leaf_bits(st_load_torch(ours)) == leaf_bits(tensors)
    u32 = {"codes": np.arange(12, dtype=np.uint32).reshape(3, 4),
           "w": np.ones((2, 2), np.float32)}
    sio.save_file(u32, ours)
    for name, arr in st_load_numpy(ours).items():
        np.testing.assert_array_equal(arr, u32[name])
        assert arr.dtype == u32[name].dtype
    header = open(ours, "rb").read(8)
    assert int.from_bytes(header, "little") % 8 == 0


def test_reader_rejects_truncated_files_and_overlapping_offsets(temp_dir):
    path = os.path.join(temp_dir, "x.safetensors")
    st_save_numpy({"a": np.ones((4, 4), np.float32),
                   "b": np.zeros(8, np.float32)}, path)
    blob = open(path, "rb").read()
    short = os.path.join(temp_dir, "short.safetensors")
    open(short, "wb").write(blob[:-5])
    with pytest.raises(sio.SafetensorsError, match="truncated"):
        sio.load_file(short)
    header = {"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]},
              "b": {"dtype": "F32", "shape": [4], "data_offsets": [8, 24]}}
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    bad = os.path.join(temp_dir, "overlap.safetensors")
    with open(bad, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw + bytes(24))
    with pytest.raises(sio.SafetensorsError, match="overlap"):
        sio.load_file(bad)


# -- unpack_mlx_uint32 --------------------------------------------------------

@pytest.mark.parametrize("bits", [2, 4, 8])
def test_unpack_mlx_uint32_matches_jax(bits):
    rng = np.random.default_rng(bits)
    packed = rng.integers(0, 2**32, (6, 5), dtype=np.uint32)
    in_dim = 5 * 32 // bits - 3
    want = jax_unpack(packed, bits, in_dim)
    got = unpack_mlx_uint32(torch.from_numpy(packed), bits, in_dim)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


# -- config -------------------------------------------------------------------

def _c2w_section():
    return {
        "codebook_size": 16, "num_quantizers": 3, "hidden_size": 32,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "intermediate_size": 64,
        "sliding_window": 4, "upsample_rates": [3, 2],
        "upsampling_ratios": [2], "decoder_dim": 16,
        "max_position_embeddings": 128,
    }


@pytest.mark.parametrize("name", ["tiny", "feedback", "code2wav", "published"])
def test_config_from_hf_matches_jax(name):
    if name == "tiny":
        hf = jfab.hf_config_dict(jcfgs.tiny(quant=True))
    elif name == "feedback":
        cfg, _, _, extra = _feedback_cfg_and_extras()
        hf = {**jfab.hf_config_dict(cfg), **extra}
    elif name == "code2wav":
        hf = {"talker_config": {"vocab_size": 256, "hidden_size": 64,
                                "num_hidden_layers": 2,
                                "num_attention_heads": 4,
                                "num_key_value_heads": 2, "head_dim": 16,
                                "intermediate_size": 128},
              "code2wav_config": _c2w_section()}
    else:
        hf = tfab.published_config_dict(tcfgs.flagship_feedback_code2wav())
    hf = json.loads(json.dumps(hf))
    for mode in ("custom", "design"):
        assert dataclasses.asdict(tw._config_from_hf(hf, mode)) == \
            dataclasses.asdict(jw._config_from_hf(hf, mode))


# -- import -------------------------------------------------------------------

def _save(path, tensors):
    os.makedirs(path, exist_ok=True)
    st_save_numpy(tensors, os.path.join(path, "model.safetensors"))


def _feedback_snapshot(path, *, tts=True, drop=()):
    cfg, extra, _, config_extra = _feedback_cfg_and_extras()
    if not tts:
        for k in ("tts_pad_token_id", "tts_bos_token_id", "tts_eos_token_id"):
            del config_extra[k]
    tensors, _ = jfab.write_mlx_style_checkpoint(
        path, cfg, full=False, extra_tensors=extra, config_extra=config_extra)
    if drop:
        _save(path, {k: v for k, v in tensors.items()
                     if not k.startswith(drop)})


def _code2wav_snapshot(path):
    model = _torch_model(_tiny_cfgs()[0])
    _save(path, {f"code2wav.{k}": v.detach().numpy()
                 for k, v in model.state_dict().items()})
    config = {"talker_config": {
        "vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "intermediate_size": 128, "codec_vocab_size": 67,
        "codec_bos_token_id": 64, "codec_eos_token_id": 65,
        "codec_pad_token_id": 66, "num_speakers": 4},
        "code_predictor_config": {
            "hidden_size": 32, "num_hidden_layers": 1,
            "num_attention_heads": 2, "head_dim": 16, "intermediate_size": 64},
        "code2wav_config": _c2w_section()}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)


def _rename_snapshot(path):
    cfg = jcfgs.tiny(quant=True)
    jfab.write_mlx_style_checkpoint(path, cfg)
    odd = np.full((cfg.codec.codebook_size, cfg.codec.latent_dim), 0.25,
                  np.float32)
    st_save_numpy({"weird.vq.table": odd},
                  os.path.join(path, "model-weird.safetensors"))
    with open(os.path.join(path, "_tpu_rename.json"), "w") as f:
        json.dump({"weird.vq.table": "codec.dec.cb0_emb"}, f)


def _text_vocab_head_snapshot(path):
    cfg = jcfgs.tiny(quant=True)
    t = cfg.talker
    rng = np.random.default_rng(4)
    _save(path, {"model.embed_tokens.weight": rng.normal(
        size=(t.vocab_size, t.hidden)).astype(np.float32),
        "lm_head.weight": np.zeros((t.vocab_size, t.hidden), np.float32)})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(jfab.hf_config_dict(cfg), f)


# name -> (write the snapshot into a directory, import kwargs)
SNAPSHOTS = {
    "full": (lambda p: jfab.fabricate_full_checkpoint(p), {}),
    "feedback": (_feedback_snapshot, {}),
    "feedback_without_tts_ids": (
        lambda p: _feedback_snapshot(p, tts=False), {}),
    "code2wav": (_code2wav_snapshot, {"allow_partial": True}),
    "partial": (lambda p: jfab.write_mlx_style_checkpoint(
        p, jcfgs.tiny(quant=True)), {"allow_partial": True}),
    "missing_linear": (lambda p: _feedback_snapshot(p, drop=(
        "model.layers.1.mlp.down_proj", "code_predictor.lm_head.1.")), {}),
    "rename": (_rename_snapshot, {"allow_partial": True}),
    "text_vocab_lm_head": (_text_vocab_head_snapshot, {"allow_partial": True}),
    "published": (lambda p: tfab.write_published_snapshot(
        p, _published_cfg(), seed=5, fast=False), {}),
}


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_import_matches_jax_bit_for_bit(name, temp_dir):
    write, kwargs = SNAPSHOTS[name]
    write(temp_dir)
    ref = _quiet(jw.import_hf_checkpoint, temp_dir, **kwargs)
    got = _quiet(tw.import_hf_checkpoint, temp_dir, **kwargs)
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(ref.cfg)
    for comp in ("params", "cp_params", "codec_params"):
        assert_trees_equal(getattr(got, comp), getattr(ref, comp))
    r, g = ref.import_report, got.import_report
    assert g.assigned == r.assigned
    assert g.synthetic == r.synthetic
    assert g.unmapped == r.unmapped
    assert g.prompt_template == r.prompt_template
    assert g.speech_tokenizer == r.speech_tokenizer
    if name == "full":  # the fixture's Mimi speech tokenizer maps
        assert g.speech_tokenizer["family"] == "mimi" and got.st_raw is None
        assert dataclasses.asdict(got.st_cfg) == dataclasses.asdict(ref.st_cfg)
        assert_trees_equal(got.st_params, ref.st_params)
    if name == "feedback":
        assert got.cfg.talker.feedback == "residual_sum"
    if name == "missing_linear":
        assert not g.unmapped and g.assigned["code_predictor"] > 0


def test_feedback_gate_warns_without_tts_ids(temp_dir):
    _feedback_snapshot(temp_dir, tts=False)
    with pytest.warns(UserWarning, match="tts_"):
        model = tw.import_hf_checkpoint(temp_dir)
    assert model.cfg.talker.feedback == "cb0"
    assert model.cfg.code_predictor.input_layout == "hidden_token"


@pytest.mark.parametrize("case", ["no_component", "unrecognised_layout"])
def test_import_errors_match_jax(case, temp_dir):
    cfg = jcfgs.tiny(quant=True)
    jfab.write_mlx_style_checkpoint(temp_dir, cfg)
    kwargs = {}
    if case == "unrecognised_layout":
        st_save_numpy({"codec.mystery.block.0.weight":
                       np.zeros((3, 3), np.float32)},
                      os.path.join(temp_dir, "model-codec.safetensors"))
        kwargs["allow_partial"] = True
    with pytest.raises(jw.CheckpointImportError) as ref:
        _quiet(jw.import_hf_checkpoint, temp_dir, **kwargs)
    with pytest.raises(tw.CheckpointImportError) as got:
        _quiet(tw.import_hf_checkpoint, temp_dir, **kwargs)
    assert str(got.value) == str(ref.value)


# -- native format ------------------------------------------------------------

@pytest.mark.parametrize("name", ["feedback", "full"])
def test_native_directories_load_across_packages(name, temp_dir):
    """JAX save_model -> port load_native, and port save_model -> JAX
    load_native: equal configs and trees (``full`` carries the mapped
    speech tokenizer both ways)."""
    snap = os.path.join(temp_dir, "snap")
    SNAPSHOTS[name][0](snap)
    ref = _quiet(jw.import_hf_checkpoint, snap)
    got = _quiet(tw.import_hf_checkpoint, snap)

    jax_dir, port_dir = (os.path.join(temp_dir, d) for d in ("jax", "port"))
    jw.save_model(ref, jax_dir)
    tw.save_model(got, port_dir)
    for loaded in (_quiet(tw.load_native, jax_dir),
                   _quiet(jw.load_native, port_dir)):
        assert dataclasses.asdict(loaded.cfg) == dataclasses.asdict(ref.cfg)
        for comp in ("params", "cp_params", "codec_params"):
            assert_trees_equal(getattr(loaded, comp), getattr(ref, comp))
    from_jax = tw.load_native(jax_dir)
    if name == "full":
        from_port = _quiet(jw.load_native, port_dir)
        for loaded in (from_jax, from_port):
            assert dataclasses.asdict(loaded.st_cfg) == \
                dataclasses.asdict(ref.st_cfg)
            assert_trees_equal(loaded.st_params, ref.st_params)
    tw.save_model(from_jax, os.path.join(temp_dir, "again"))
    assert_trees_equal(tw.load_native(os.path.join(temp_dir, "again")).st_params,
                       from_jax.st_params)


def test_load_checkpoint_caches_only_complete_imports(temp_dir):
    full = os.path.join(temp_dir, "full")
    tfab.fabricate_full_checkpoint(full)
    first = _quiet(tw.load_checkpoint, full)
    assert set(first.load_times) == {"import_s", "cache_write_s"}
    assert os.path.exists(os.path.join(full, tw.NATIVE_DIR, tw.NATIVE_CONFIG))
    again = tw.load_checkpoint(full)
    assert set(again.load_times) == {"native_load_s"}
    assert again.st_raw is None and again.template.source == "file"
    for comp in ("params", "cp_params", "codec_params", "st_params"):
        assert_trees_equal(getattr(again, comp), getattr(first, comp))

    partial = os.path.join(temp_dir, "partial")
    tfab.write_mlx_style_checkpoint(partial, tcfgs.tiny(quant=True))
    with pytest.warns(UserWarning, match="not caching"):
        tw.load_checkpoint(partial, allow_partial=True)
    assert not os.path.exists(os.path.join(partial, tw.NATIVE_DIR))


# -- prompt templates ---------------------------------------------------------

CHAT = ("{% for m in messages %}<|im_start|>{{ m.role }}\n{{ m.content }}"
        "<|im_end|>\n{% endfor %}{% if add_generation_prompt %}"
        "<|im_start|>assistant\n{% endif %}")
FILES = {"custom": "<|instruct|>{instruct}<|speed:{speed_bucket}|>{text}",
         "design": "<|voice|>{instruct}<|/voice|>{text}",
         "base": "<|ref|>{ref_text}<|/ref|>{text}", "base_noref": "{text}"}


@pytest.mark.parametrize("source", ["file", "chat_template", "synthetic"])
@pytest.mark.parametrize("mode", ["custom", "design", "base"])
def test_prompt_template_render_matches_jax(source, mode, temp_dir):
    if source == "file":
        with open(os.path.join(temp_dir, "tts_prompts.json"), "w") as f:
            json.dump(FILES, f)
    elif source == "chat_template":
        with open(os.path.join(temp_dir, "tokenizer_config.json"), "w") as f:
            json.dump({"chat_template": CHAT}, f)
    got = tprompts.load_prompt_template(temp_dir)
    ref = jprompts.load_prompt_template(temp_dir)
    assert got.source == ref.source == source
    for kw in ({"instruct": "Warm.", "speed": 1.3, "voice": "Ryan"},
               {"ref_text": "Hello ref."}, {"ref_text": "."}, {}):
        assert got.render(mode, "Some text.", **kw) == \
            ref.render(mode, "Some text.", **kw)


def test_load_prompt_template_priority_and_marker_check(temp_dir):
    with open(os.path.join(temp_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": CHAT}, f)
    with open(os.path.join(temp_dir, "generation_config.json"), "w") as f:
        json.dump({"tts_prompts": {"custom": "G:{text}"}}, f)
    for mod in (tprompts, jprompts):
        assert mod.load_prompt_template(temp_dir).source == "file"
        assert mod.load_prompt_template(temp_dir).render("custom", "x") == "G:x"
    with open(os.path.join(temp_dir, "tts_prompts.json"), "w") as f:
        json.dump({"custom": "F:{text}"}, f)
    for mod in (tprompts, jprompts):
        assert mod.load_prompt_template(temp_dir).render("custom", "x") == "F:x"

    class Splits:  # a tokenizer that knows <|im_start|> but not <|im_end|>
        def encode(self, s):
            return [1] if s == "<|im_start|>" else list(range(len(s)))

    rendered = "<|im_start|>user\nhi<|im_end|>\n"
    for mod in (tprompts, jprompts):
        with pytest.raises(ValueError, match="<\\|im_end\\|>"):
            mod.validate_special_tokens(rendered, Splits())
        mod.validate_special_tokens("<|im_start|>", Splits())


def test_tokenizer_warns_when_its_files_cannot_be_built(temp_dir, monkeypatch):
    """Named for the byte fallback it pinned before the port had its own
    BPE encoder. Tokenizer files that cannot be read now raise, under the
    default encoder and under QWEN3_TTS_TOKENIZER=hf without transformers:
    nothing falls back to bytes. Bytes stay the answer, without a word,
    for a directory without vocabulary files and for tiny vocabularies."""
    from qwen3_tts_tpu_torch.engine.tokenizer import ByteTokenizer, load_tokenizer

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert isinstance(load_tokenizer(temp_dir, 151_936), ByteTokenizer)
        with open(os.path.join(temp_dir, "tokenizer_config.json"), "w") as f:
            json.dump({"chat_template": CHAT}, f)  # no vocabulary in it
        assert isinstance(load_tokenizer(temp_dir, 151_936), ByteTokenizer)
        open(os.path.join(temp_dir, "tokenizer.json"), "w").write("{}")
        with pytest.raises(ValueError, match="BPE"):
            load_tokenizer(temp_dir, 151_936)
        monkeypatch.setenv("QWEN3_TTS_TOKENIZER", "hf")
        monkeypatch.setitem(__import__("sys").modules, "transformers", None)
        with pytest.raises(ImportError):
            load_tokenizer(temp_dir, 151_936)
        assert isinstance(load_tokenizer(temp_dir, 200), ByteTokenizer)
        monkeypatch.setenv("QWEN3_TTS_TOKENIZER", "sentencepiece")
        with pytest.raises(ValueError, match="QWEN3_TTS_TOKENIZER"):
            load_tokenizer(temp_dir, 151_936)
