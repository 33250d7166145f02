"""Fabricate checkpoint snapshots in the layouts the importer reads.

No real weights are in the repository, so import is held against
fabricated snapshots: MLX-quantized (uint32-packed) linears, dense norms
and embeddings, per-component ``config.json`` sections, written with
numpy and ``engine/safetensors_io.py`` alone.

- ``write_mlx_style_checkpoint`` / ``fabricate_full_checkpoint``: the JAX
  package's fixtures (the synthetic cb0 layout with the rvq codec and a
  scaled-down Mimi speech tokenizer);
- ``write_published_snapshot``: the published layout that switches the
  importer to the residual_sum protocol and the code2wav decoder: the
  two-position code predictor (no input projection, no qk-norm) under its
  published names, the talker's text_projection MLP, the think and tts
  ids, a speaker-name map, ``code2wav.*`` under transformers'
  Qwen3OmniMoeCode2Wav module paths with its ``code2wav_config``, and
  ``tts_prompts.json``; optionally a Mimi speech tokenizer
  (``speech_tokenizer_tensors``) for cloning; and, where the talker's text
  vocabulary holds it, a small Qwen2-style text tokenizer
  (``write_qwen_tokenizer``);
- ``write_whisper_snapshot``: an HF Whisper snapshot and its vocabulary.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np
import torch

from .safetensors_io import save_file


def hf_config_dict(cfg) -> dict:
    """config.json describing all three components of ``cfg`` the way a
    snapshot does (per-component sections)."""
    t, cp, cc = cfg.talker, cfg.code_predictor, cfg.codec
    return {
        "vocab_size": t.vocab_size,
        "hidden_size": t.hidden,
        "num_hidden_layers": t.n_layers,
        "num_attention_heads": t.n_heads,
        "num_key_value_heads": t.n_kv_heads,
        "head_dim": t.head_dim,
        "intermediate_size": t.ffn,
        "rope_theta": t.rope_theta,
        "rms_norm_eps": t.rms_eps,
        "codec_vocab_size": t.codec_vocab,
        "codec_bos_token_id": t.codec_bos,
        "codec_eos_token_id": t.codec_eos,
        "codec_pad_token_id": t.codec_pad,
        "num_speakers": t.n_speakers,
        "code_predictor_config": {
            "hidden_size": cp.hidden,
            "num_hidden_layers": cp.n_layers,
            "num_attention_heads": cp.n_heads,
            "head_dim": cp.head_dim,
            "intermediate_size": cp.ffn,
            "rms_norm_eps": cp.rms_eps,
            "rope_theta": cp.rope_theta,
        },
        "codec_config": {
            "sample_rate": cc.sample_rate,
            "frame_rate": cc.frame_rate,
            "num_codebooks": cc.num_codebooks,
            "codebook_size": cc.codebook_size,
            "residual_codebook_size": cc.residual_codebook_size,
            "latent_dim": cc.latent_dim,
            "upsample_rates": list(cc.upsample_rates),
            "decoder_channels": list(cc.decoder_channels),
            "decoder_kernel": cc.decoder_kernel,
            "n_transformer_layers": cc.n_transformer_layers,
            "transformer_heads": cc.transformer_heads,
        },
        "quantization": {"bits": 8, "group_size": cfg.quant.group_size},
    }


def add_cp_tensors(tensors: dict, cfg, rng) -> None:
    """Qwen-style code-predictor tensors under ``code_predictor.`` (dense
    f32; the importer quantizes them into quantized slots)."""
    cp, t, cc = cfg.code_predictor, cfg.talker, cfg.codec
    q_dim = cp.n_heads * cp.head_dim
    n_res = cc.num_codebooks - 1

    def lin(name, o, i):
        tensors[f"code_predictor.{name}.weight"] = rng.normal(
            0, 0.05, (o, i)).astype(np.float32)

    lin("in_proj", cp.hidden, t.hidden)
    tensors["code_predictor.cb0_embedding.weight"] = rng.normal(
        0, 0.02, (cc.codebook_size, cp.hidden)).astype(np.float32)
    tensors["code_predictor.res_embedding.weight"] = rng.normal(
        0, 0.02, (n_res, cc.residual_codebook_size, cp.hidden)).astype(np.float32)
    tensors["code_predictor.heads.weight"] = rng.normal(
        0, 0.02, (n_res, cc.residual_codebook_size, cp.hidden)).astype(np.float32)
    tensors["code_predictor.norm.weight"] = np.ones(cp.hidden, np.float32)
    for i in range(cp.n_layers):
        lin(f"layers.{i}.self_attn.q_proj", q_dim, cp.hidden)
        lin(f"layers.{i}.self_attn.k_proj", q_dim, cp.hidden)
        lin(f"layers.{i}.self_attn.v_proj", q_dim, cp.hidden)
        lin(f"layers.{i}.self_attn.o_proj", cp.hidden, q_dim)
        lin(f"layers.{i}.mlp.gate_proj", cp.ffn, cp.hidden)
        lin(f"layers.{i}.mlp.up_proj", cp.ffn, cp.hidden)
        lin(f"layers.{i}.mlp.down_proj", cp.hidden, cp.ffn)
        p = f"code_predictor.layers.{i}"
        for norm, n in (("self_attn.q_norm", cp.head_dim),
                        ("self_attn.k_norm", cp.head_dim),
                        ("input_layernorm", cp.hidden),
                        ("post_attention_layernorm", cp.hidden)):
            tensors[f"{p}.{norm}.weight"] = np.ones(n, np.float32)


def add_codec_tensors(tensors: dict, cfg, seed: int) -> None:
    """Codec tensors as dotted tree paths under ``codec.`` (f32): the tree
    of ``init_codec`` with the cloning encoder, as the JAX package's
    fixtures write it."""
    from ..models.codec import init_codec
    from .weights import flatten_tree

    codec = init_codec(cfg, seed=seed, encoder=True)
    for path, arr in flatten_tree(codec).items():
        tensors["codec." + path.replace("/", ".")] = arr.float().numpy()


def speech_tokenizer_tensors(cfg, seed: int = 13, st=None) -> tuple[dict, dict]:
    """Mimi-layout ``speech_tokenizer.*`` tensors (the names of the torch
    ``MimiModel`` state dict) whose code space is ``cfg.codec``'s, and the
    ``speech_tokenizer_config`` section of config.json. ``st`` (a
    ``SpeechTokenizerConfig``) sets the geometry; the default is the JAX
    package's fixture, a scaled-down Mimi (4-stage SEANet at ~12.5 Hz)."""
    from ..models.speech_tokenizer import (
        SpeechTokenizerConfig, init_speech_tokenizer,
    )

    cc = cfg.codec
    if st is None:
        st = SpeechTokenizerConfig(
            num_filters=4, upsampling_ratios=(8, 6, 5, 4), hidden=32,
            n_layers=2, n_heads=2, n_kv_heads=2, head_dim=16, ffn=64,
            codebook_size=cc.codebook_size, codebook_dim=16,
            num_quantizers=cc.num_codebooks, num_semantic_quantizers=1,
            frame_div=2, sampling_rate=cc.sample_rate)
    p = init_speech_tokenizer(st, seed=seed)
    out: dict = {}
    pre = "speech_tokenizer."

    def conv(idx: int, sub: dict) -> None:
        out[f"{pre}encoder.layers.{idx}.conv.weight"] = sub["w"]
        if "b" in sub:
            out[f"{pre}encoder.layers.{idx}.conv.bias"] = sub["b"]

    conv(0, p["enc"]["conv_in"])
    per_stage = st.num_residual_layers + 2  # res..., ELU, down
    for s, stage in enumerate(p["enc"]["stages"]):
        base = 1 + s * per_stage
        for j, blk in enumerate(stage["res"]):
            for tag, c in (("1", blk["c1"]), ("3", blk["c2"])):
                nm = f"{pre}encoder.layers.{base + j}.block.{tag}.conv"
                out[nm + ".weight"] = c["w"]
                out[nm + ".bias"] = c["b"]
        conv(base + st.num_residual_layers + 1, stage["down"])
    conv(1 + len(p["enc"]["stages"]) * per_stage + 1, p["enc"]["conv_out"])

    lin = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
           "v": "self_attn.v_proj", "o": "self_attn.o_proj",
           "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    vec = {"ln1_w": "input_layernorm.weight",
           "ln1_b": "input_layernorm.bias",
           "ln2_w": "post_attention_layernorm.weight",
           "ln2_b": "post_attention_layernorm.bias",
           "scale_attn": "self_attn_layer_scale.scale",
           "scale_mlp": "mlp_layer_scale.scale"}
    for li, blk in enumerate(p["tf"]):
        tb = f"{pre}encoder_transformer.layers.{li}."
        for k, name in lin.items():
            # the tree holds x @ w [in, out]; files carry torch's [out, in]
            out[tb + name + ".weight"] = np.ascontiguousarray(blk[k]["w"].T)
        for k, name in vec.items():
            out[tb + name] = blk[k]
    if "down" in p:
        out[f"{pre}downsample.conv.weight"] = p["down"]["w"]
    for fam, q in (("semantic", p["quant"]["sem"]),
                   ("acoustic", p["quant"]["ac"])):
        qb = f"{pre}quantizer.{fam}_residual_vector_quantizer."
        out[qb + "input_proj.weight"] = np.ascontiguousarray(
            q["in_proj"]["w"].T)[:, :, None]                # conv1x1 [D, H, 1]
        for i, cb in enumerate(q["codebooks"]):
            # cluster_usage of ones: embed_sum is the codebook
            out[f"{qb}layers.{i}.codebook.embed_sum"] = cb
            out[f"{qb}layers.{i}.codebook.cluster_usage"] = np.ones(
                st.codebook_size, np.float32)
    section = {"head_dim": st.head_dim, "num_attention_heads": st.n_heads,
               "num_key_value_heads": st.n_kv_heads,
               "sampling_rate": st.sampling_rate}
    return out, section


def _pack_u8(codes: np.ndarray) -> np.ndarray:
    """uint8 codes [out, in] -> MLX uint32 words [out, in/4]."""
    return np.ascontiguousarray(codes).view("<u4")


def write_mlx_style_checkpoint(path: str, cfg, seed: int = 11,
                               full: bool = False, extra_tensors=None,
                               config_extra=None):
    """An MLX-layout talker checkpoint (uint32-packed quantized linears +
    dense norms and embeddings); ``full`` adds the code predictor and the
    codec. Returns (tensors, dense) where ``dense`` holds the dequantized
    weights of the quantized linears."""
    from ..ops.quant import dequantize, quantize_weights

    t = cfg.talker
    rng = np.random.default_rng(seed)
    gs = cfg.quant.group_size
    tensors: dict = {}
    dense: dict = {}

    def pack_linear(base, out_dim, in_dim):
        w = rng.normal(0, 0.05, (out_dim, in_dim)).astype(np.float32)
        qp = quantize_weights(w, group_size=gs, bits=8)
        tensors[f"{base}.weight"] = _pack_u8(qp["q"])
        tensors[f"{base}.scales"] = qp["scale"]
        tensors[f"{base}.biases"] = qp["bias"]
        dense[base] = dequantize(qp, torch.float32).numpy()

    tensors["model.embed_tokens.weight"] = rng.normal(
        0, 0.02, (t.vocab_size, t.hidden)).astype(np.float32)
    tensors["codec_embedding.weight"] = rng.normal(
        0, 0.02, (t.codec_vocab, t.hidden)).astype(np.float32)
    tensors["model.norm.weight"] = np.ones(t.hidden, np.float32)
    pack_linear("lm_head", t.codec_vocab, t.hidden)
    for i in range(t.n_layers):
        p = f"model.layers.{i}"
        pack_linear(f"{p}.self_attn.q_proj", t.q_dim, t.hidden)
        pack_linear(f"{p}.self_attn.k_proj", t.kv_dim, t.hidden)
        pack_linear(f"{p}.self_attn.v_proj", t.kv_dim, t.hidden)
        pack_linear(f"{p}.self_attn.o_proj", t.hidden, t.q_dim)
        pack_linear(f"{p}.mlp.gate_proj", t.ffn, t.hidden)
        pack_linear(f"{p}.mlp.up_proj", t.ffn, t.hidden)
        pack_linear(f"{p}.mlp.down_proj", t.hidden, t.ffn)
        for norm, n in (("self_attn.q_norm", t.head_dim),
                        ("self_attn.k_norm", t.head_dim),
                        ("input_layernorm", t.hidden),
                        ("post_attention_layernorm", t.hidden)):
            tensors[f"{p}.{norm}.weight"] = np.ones(n, np.float32)

    if full:
        tensors["speaker_embedding.weight"] = rng.normal(
            0, 0.02, (t.n_speakers, t.hidden)).astype(np.float32)
        add_cp_tensors(tensors, cfg, rng)
        add_codec_tensors(tensors, cfg, seed + 5)

    if extra_tensors:
        tensors.update(extra_tensors)
    hf = hf_config_dict(cfg)
    if config_extra:
        hf.update(config_extra)
    os.makedirs(path, exist_ok=True)
    save_file(tensors, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    return tensors, dense


# the ChatML template at the core of the Qwen2.5/Qwen3 tokenizer_config.json
QWEN_CHATML = (
    "{%- for message in messages %}"
    "{{- '<|im_start|>' + message['role'] + '\\n' + message['content']"
    " + '<|im_end|>' + '\\n' }}"
    "{%- endfor %}"
    "{%- if add_generation_prompt %}"
    "{{- '<|im_start|>assistant\\n' }}"
    "{%- endif %}"
)
# the added tokens of the fabricated Qwen tokenizer: the ChatML markers and
# the control markers of the tts_prompts.json templates (_write_prompts)
QWEN_SPECIAL_TOKENS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>",
                       "<|instruct|>", "<|/instruct|>", "<|voice|>",
                       "<|/voice|>", "<|ref|>", "<|/ref|>")
# the fixed text the fabricated merges are learnt from
QWEN_CORPUS = (
    "Hello there, general. The quick brown fox jumps over the lazy dog. "
    "Speak happily, and read this in a deep, calm narrator voice. "
    "Multi token prediction speaks two frames at every step of the talker. "
    "This is a test of the text to speech system; it reads every sentence "
    "aloud. We'll see: don't stop, it's fine, they're here, I've been, "
    "I'm sure, she'd say. Numbers like 42, 2026 and 3.14 read digit by "
    "digit. Café, naïve, über, señor, déjà vu.\n"
    "你好，世界。今天天气很好，我们一起说话吧。语音合成的声音很自然。"
    "这是一个测试，请读出这句话。\n"
    "こんにちは、世界。今日はいい天気ですね。音声合成のテストです。\n"
    "안녕하세요, 세계. 오늘 날씨가 좋네요.\n"
    "Hello world! Hello again, world. The voice says hello to the world, "
    "and the world says hello back. Speak, speak, speak the words.\r\n"
    "\tTabs and    runs of spaces stay as they are.  🙂 👍\n"
)


QWEN_MERGES = 320  # merges of the fabricated Qwen tokenizer


def _qwen_vocab() -> tuple[dict, list]:
    """A byte-level BPE vocabulary: the 256 byte characters, then
    QWEN_MERGES merges learnt from QWEN_CORPUS (pre-tokenized with the
    Qwen2 pattern; the most frequent pair first, ties by the pair's
    characters), and its merge list [(a, b), ...]."""
    import unicodedata
    from collections import Counter

    from .tokenizer import bytes_to_unicode, qwen2_pretokenizer

    char_of = bytes_to_unicode()
    words = Counter(
        "".join(char_of[b] for b in m.group().encode("utf-8"))
        for m in qwen2_pretokenizer().finditer(
            unicodedata.normalize("NFC", QWEN_CORPUS)))
    seqs = {w: list(w) for w in words}
    vocab = {c: i for i, c in enumerate(char_of.values())}
    merges = []
    while len(merges) < QWEN_MERGES:
        counts = Counter()
        for w, n in words.items():
            for pair in zip(seqs[w], seqs[w][1:]):
                counts[pair] += n
        if not counts:
            raise ValueError(f"QWEN_CORPUS yields {len(merges)} merges, "
                             f"not {QWEN_MERGES}")
        a, b = min(counts, key=lambda p: (-counts[p], p))
        merges.append((a, b))
        vocab.setdefault(a + b, len(vocab))
        for w, seq in seqs.items():
            out, i = [], 0
            while i < len(seq):
                if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            seqs[w] = out
    return vocab, merges


def write_qwen_tokenizer(path: str) -> int:
    """The text tokenizer files of a Qwen2-style checkpoint, written with
    json alone: ``tokenizer.json`` (BPE over ``_qwen_vocab``, the NFC
    normalizer, the Qwen2 Split pre-tokenizer and ByteLevel, the
    QWEN_SPECIAL_TOKENS as added tokens after the vocabulary), the same
    vocabulary as ``vocab.json`` + ``merges.txt``, and
    ``tokenizer_config.json`` (``added_tokens_decoder``, the ChatML chat
    template, ``tokenizer_class`` Qwen2Tokenizer). Deterministic: the same
    files on every call. Returns the vocabulary size with the added
    tokens (``len(AutoTokenizer)``)."""
    from .tokenizer import QWEN2_PATTERN

    vocab, merges = _qwen_vocab()
    flags = dict(single_word=False, lstrip=False, rstrip=False,
                 normalized=False, special=True)
    added = [{"id": len(vocab) + i, "content": tok, **flags}
             for i, tok in enumerate(QWEN_SPECIAL_TOKENS)]
    byte_level = {"type": "ByteLevel", "add_prefix_space": False,
                  "trim_offsets": False, "use_regex": False}
    files = {
        "tokenizer.json": {
            "version": "1.0", "truncation": None, "padding": None,
            "added_tokens": added,
            "normalizer": {"type": "NFC"},
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": QWEN2_PATTERN},
                 "behavior": "Isolated", "invert": False},
                byte_level]},
            "post_processor": byte_level,
            "decoder": byte_level,
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": "",
                      "end_of_word_suffix": "", "fuse_unk": False,
                      "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": [list(m) for m in merges]}},
        "vocab.json": vocab,
        "tokenizer_config.json": {
            "tokenizer_class": "Qwen2Tokenizer",
            "added_tokens_decoder": {
                str(t["id"]): {k: v for k, v in t.items() if k != "id"}
                for t in added},
            "additional_special_tokens": list(QWEN_SPECIAL_TOKENS[1:]),
            "bos_token": None, "eos_token": "<|im_end|>",
            "pad_token": "<|endoftext|>", "unk_token": None,
            "chat_template": QWEN_CHATML,
            "clean_up_tokenization_spaces": False, "errors": "replace",
            "model_max_length": 131072, "split_special_tokens": False},
    }
    os.makedirs(path, exist_ok=True)
    for name, obj in files.items():
        with open(os.path.join(path, name), "w", encoding="utf-8") as fh:
            json.dump(obj, fh, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as fh:
        fh.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges)
                 + "\n")
    return len(vocab) + len(added)


def _write_prompts(path: str) -> None:
    with open(os.path.join(path, "tts_prompts.json"), "w") as f:
        json.dump({
            "custom": "<|instruct|>{instruct}<|/instruct|>{text}",
            "design": "<|voice|>{instruct}<|/voice|>{text}",
            "base": "<|ref|>{ref_text}<|/ref|>{text}",
        }, f)


def fabricate_full_checkpoint(path: str, *, seed: int = 11,
                              template: bool = True) -> str:
    """A complete tiny quantized three-component snapshot (talker, code
    predictor, rvq codec) with a scaled-down Mimi speech tokenizer, plus
    prompt templates: the JAX package's fixture."""
    from .configs import tiny

    cfg = tiny("custom", quant=True)
    st_tensors, st_section = speech_tokenizer_tensors(cfg, seed=seed + 9)
    write_mlx_style_checkpoint(
        path, cfg, seed=seed, full=True, extra_tensors=st_tensors,
        config_extra={"speech_tokenizer_config": st_section})
    if template:
        _write_prompts(path)
    return path


# --------------------------------------------------------------------------
# the published layout
# --------------------------------------------------------------------------

_LINEARS = (("self_attn.q_proj", "attn", "q"), ("self_attn.k_proj", "attn", "k"),
            ("self_attn.v_proj", "attn", "v"), ("self_attn.o_proj", "attn", "o"),
            ("mlp.gate_proj", "mlp", "gate"), ("mlp.up_proj", "mlp", "up"),
            ("mlp.down_proj", "mlp", "down"))


def _c2w_hf_names(c2w_cfg) -> dict[str, str]:
    """Dotted ``c2w`` tree path -> transformers Qwen3OmniMoeCode2Wav name,
    for the conv stacks (the inverse of the importer's translation)."""
    from .weights import _C2W_CONVNEXT, _C2W_RES_UNIT, _c2w_native_name

    n = len(c2w_cfg.upsample_rates)
    names = [f"decoder.0.conv.{s}" for s in ("weight", "bias")]
    names += [f"decoder.{n + 1}.{s}" for s in ("alpha", "beta")]
    names += [f"decoder.{n + 2}.conv.{s}" for s in ("weight", "bias")]
    for i in range(len(c2w_cfg.upsampling_ratios)):
        names += [f"upsample.{i}.0.conv.{s}" for s in ("weight", "bias")]
        names += [f"upsample.{i}.1.{k}" for k in _C2W_CONVNEXT]
    for b in range(1, n + 1):
        names += [f"decoder.{b}.block.0.{s}" for s in ("alpha", "beta")]
        names += [f"decoder.{b}.block.1.conv.{s}" for s in ("weight", "bias")]
        names += [f"decoder.{b}.block.{j}.{k}" for j in (2, 3, 4)
                  for k in _C2W_RES_UNIT]
    return {_c2w_native_name(hf, n): hf for hf in names}


class _Values:
    """Leaf values of a fabricated snapshot: ``fast`` draws float32 normals
    and writes bf16 (as MLX snapshots store embeddings, scales and biases);
    otherwise float64 normals rounded to float32."""

    def __init__(self, seed: int, fast: bool):
        self.rng = np.random.default_rng(seed)
        self.fast = fast

    def normal(self, shape, std: float):
        if self.fast:
            a = self.rng.standard_normal(shape, dtype=np.float32)
            a *= np.float32(std)
            return torch.from_numpy(a).to(torch.bfloat16)
        return self.rng.normal(0.0, std, size=shape).astype(np.float32)

    def const(self, shape, value: float):
        a = np.full(shape, value, np.float32)
        return torch.from_numpy(a).to(torch.bfloat16) if self.fast else a

    def linear(self, tensors: dict, base: str, out_dim: int, in_dim: int,
               gs: int, quantized: bool, std: float = 0.05) -> None:
        """One linear: MLX-quantized (uint32 codes, per-group scales and
        biases) or dense."""
        if not quantized:
            tensors[f"{base}.weight"] = self.normal((out_dim, in_dim), std)
            return
        g = in_dim // gs
        if self.fast:
            tensors[f"{base}.weight"] = self.rng.integers(
                0, 2**32, (out_dim, in_dim // 4), dtype=np.uint32)
            tensors[f"{base}.scales"] = self.const((out_dim, g), 2 * std / 255)
            tensors[f"{base}.biases"] = self.const((out_dim, g), -std)
            return
        from ..ops.quant import quantize_weights

        qp = quantize_weights(self.normal((out_dim, in_dim), std),
                              group_size=gs, bits=8)
        tensors[f"{base}.weight"] = _pack_u8(qp["q"])
        tensors[f"{base}.scales"] = qp["scale"]
        tensors[f"{base}.biases"] = qp["bias"]


def published_config_dict(cfg) -> dict:
    """config.json of a snapshot in the published layout: ``hf_config_dict``
    with the talker's think markers and speaker-name map, the tts ids and
    a ``code2wav_config`` section."""
    t, c = cfg.talker, cfg.code2wav
    hf = hf_config_dict(cfg)
    hf.update({
        "codec_nothink_id": t.codec_nothink,
        "codec_think_bos_id": t.codec_think_bos,
        "codec_think_eos_id": t.codec_think_eos,
        "speaker_id": {name: t.codec_nothink - 1 - i
                       for i, name in enumerate(cfg.speakers[:4])},
        "tts_pad_token_id": t.tts_pad_id,
        "tts_bos_token_id": t.tts_bos_id,
        "tts_eos_token_id": t.tts_eos_id,
        "code2wav_config": {
            "codebook_size": c.codebook_size,
            "num_quantizers": c.num_quantizers,
            "hidden_size": c.hidden,
            "num_hidden_layers": c.n_layers,
            "num_attention_heads": c.n_heads,
            "num_key_value_heads": c.n_kv_heads,
            "intermediate_size": c.ffn,
            "rope_theta": c.rope_theta,
            "rms_norm_eps": c.rms_eps,
            "sliding_window": c.sliding_window,
            "layer_scale_initial_scale": c.layer_scale_init,
            "upsample_rates": list(c.upsample_rates),
            "upsampling_ratios": list(c.upsampling_ratios),
            "decoder_dim": c.decoder_dim,
            "sample_rate": c.sample_rate,
            "max_position_embeddings": c.max_positions,
        },
    })
    return hf


def write_published_snapshot(path: str, cfg, seed: int = 0,
                             fast: bool = True, speech_tokenizer=None) -> int:
    """Write a snapshot of ``cfg`` (a residual_sum + code2wav config, e.g.
    ``configs.flagship_feedback_code2wav()``) in the published layout into
    ``path``; returns the bytes written.

    ``fast`` draws the packed codes directly (uniform uint32 words with a
    constant scale/bias grid, as the synthetic ``fast`` init) and writes
    bf16 tables, scales and biases, so that a full-width snapshot is
    written in seconds; otherwise the talker's linears are quantized from
    normal draws and the code predictor's are dense f32, as the JAX
    package's published-layout test fixtures write them.

    ``speech_tokenizer`` adds a Mimi speech tokenizer for cloning: a
    ``SpeechTokenizerConfig`` (``SpeechTokenizerConfig()``, the published
    widths, whose 16 books of 2048 match the published code space), or
    ``True`` for the JAX package's scaled-down fixture; its code space is
    the config's.

    The text tokenizer files of ``write_qwen_tokenizer`` are written where
    the talker's text vocabulary holds their ids (not the tiny configs'
    256 ids)."""
    from ..models.code2wav import init_code2wav
    from ..models.init import InitPlan
    from .weights import _C2W_BLOCK_NORMS, _leaves

    t, cp, c2w = cfg.talker, cfg.code_predictor, cfg.code2wav
    if (t.feedback != "residual_sum" or cfg.codec_arch != "code2wav"
            or cp.hidden != t.hidden):
        raise ValueError("write_published_snapshot needs a residual_sum "
                         "config with the code2wav decoder")
    v = _Values(seed, fast)
    gs = cfg.quant.group_size
    tensors: dict = {}

    # talker
    tensors["talker.model.embed_tokens.weight"] = v.normal(
        (t.vocab_size, t.hidden), 0.02)
    tensors["talker.codec_embedding.weight"] = v.normal(
        (t.codec_vocab, t.hidden), 0.02)
    tensors["talker.speaker_embedding.weight"] = v.normal(
        (t.n_speakers, t.hidden), 0.02)
    tensors["talker.model.norm.weight"] = v.const((t.hidden,), 1.0)
    v.linear(tensors, "talker.codec_head", t.codec_vocab, t.hidden, gs, True)
    dims = {"q": (t.q_dim, t.hidden), "k": (t.kv_dim, t.hidden),
            "v": (t.kv_dim, t.hidden), "o": (t.hidden, t.q_dim),
            "gate": (t.ffn, t.hidden), "up": (t.ffn, t.hidden),
            "down": (t.hidden, t.ffn)}
    for i in range(t.n_layers):
        p = f"talker.model.layers.{i}"
        for hf, _, key in _LINEARS:
            v.linear(tensors, f"{p}.{hf}", *dims[key], gs, True)
        for norm, n in (("self_attn.q_norm", t.head_dim),
                        ("self_attn.k_norm", t.head_dim),
                        ("input_layernorm", t.hidden),
                        ("post_attention_layernorm", t.hidden)):
            tensors[f"{p}.{norm}.weight"] = v.const((n,), 1.0)
    for fc, (o, i) in (("linear_fc1", (t.ffn, t.hidden)),
                       ("linear_fc2", (t.hidden, t.ffn))):
        tensors[f"talker.text_projection.{fc}.weight"] = v.normal((o, i), 0.05)
        tensors[f"talker.text_projection.{fc}.bias"] = v.normal((o,), 0.01)

    # code predictor: the two-position layout, no in_proj, no qk-norm
    n_res = cfg.codec.num_codebooks - 1
    q_dim = cp.n_heads * cp.head_dim
    cp_dims = {"q": (q_dim, cp.hidden), "k": (q_dim, cp.hidden),
               "v": (q_dim, cp.hidden), "o": (cp.hidden, q_dim),
               "gate": (cp.ffn, cp.hidden), "up": (cp.ffn, cp.hidden),
               "down": (cp.hidden, cp.ffn)}
    tensors["code_predictor.cb0_embedding.weight"] = v.normal(
        (cfg.codec.codebook_size, cp.hidden), 0.02)
    for i in range(n_res):
        tensors[f"code_predictor.model.codec_embedding.{i}.weight"] = v.normal(
            (cfg.codec.residual_codebook_size, cp.hidden), 0.02)
        tensors[f"code_predictor.lm_head.{i}.weight"] = v.normal(
            (cfg.codec.residual_codebook_size, cp.hidden), 0.02)
    tensors["code_predictor.model.norm.weight"] = v.const((cp.hidden,), 1.0)
    for i in range(cp.n_layers):
        p = f"code_predictor.model.layers.{i}"
        for hf, _, key in _LINEARS:
            v.linear(tensors, f"{p}.{hf}", *cp_dims[key], min(gs, cp.hidden),
                     fast)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            tensors[f"{p}.{norm}.weight"] = v.const((cp.hidden,), 1.0)

    # code2wav: the drawn leaves of its tree get fresh values, the exact
    # ones (norms, layer scales, snake parameters) their init values
    shapes = init_code2wav(c2w, 0, torch.float32, InitPlan("template"))
    drawn = init_code2wav(c2w, 0, torch.float32, InitPlan("index"))
    values = {}
    for (key, leaf), (_, idx) in zip(_leaves(shapes), _leaves(drawn)):
        values[key] = (v.normal(tuple(leaf.shape), 0.02) if idx.max() >= 0
                        else v.const(tuple(leaf.shape), float(leaf.flatten()[0])))
    pre = "code2wav.pre_transformer"
    tensors["code2wav.code_embedding.weight"] = values[("code_emb",)]
    tensors[f"{pre}.norm.weight"] = values[("pre", "ln_f")]
    for i in range(c2w.n_layers):
        for hf, grp, key in _LINEARS:
            tensors[f"{pre}.layers.{i}.{hf}.weight"] = values[
                ("pre", "blocks", grp, key, "w")][i]
        for hf, key in _C2W_BLOCK_NORMS.items():
            tensors[f"{pre}.layers.{i}.{hf}"] = values[("pre", "blocks", key)][i]
    for native, hf in _c2w_hf_names(c2w).items():
        key = tuple(int(p) if p.isdigit() else p for p in native.split("."))
        tensors[f"code2wav.{hf}"] = values[key]

    hf = published_config_dict(cfg)
    if speech_tokenizer is not None:
        st = None if speech_tokenizer is True else dataclasses.replace(
            speech_tokenizer, codebook_size=cfg.codec.codebook_size,
            num_quantizers=cfg.codec.num_codebooks,
            sampling_rate=cfg.codec.sample_rate)
        st_tensors, hf["speech_tokenizer_config"] = speech_tokenizer_tensors(
            cfg, seed=seed + 13, st=st)
        tensors.update(st_tensors)
    os.makedirs(path, exist_ok=True)
    save_file(tensors, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    _write_prompts(path)
    if t.vocab_size >= 256 + QWEN_MERGES + len(QWEN_SPECIAL_TOKENS):
        write_qwen_tokenizer(path)
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


# --------------------------------------------------------------------------
# Whisper snapshots (models/whisper.py, transcription.py, quality.py)
# --------------------------------------------------------------------------

# the 100 language tokens of the multilingual Whisper vocabularies, in
# vocabulary order (ids from <|startoftranscript|> + 1)
WHISPER_LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln "
    "ha ba jw su yue").split()
WHISPER_TASKS = ("<|translate|>", "<|transcribe|>", "<|startoflm|>",
                 "<|startofprev|>", "<|nospeech|>", "<|notimestamps|>")


def whisper_config_dict(d_model: int, layers: tuple[int, int], heads: int,
                        ffn: int, n_mels: int, vocab_size: int,
                        max_source_positions: int = 1500,
                        max_target_positions: int = 448) -> dict:
    """config.json of an HF Whisper checkpoint (the keys
    ``WhisperConfig.from_hf`` and transformers read)."""
    return {
        "model_type": "whisper", "architectures": [
            "WhisperForConditionalGeneration"],
        "d_model": d_model,
        "encoder_layers": layers[0], "decoder_layers": layers[1],
        "encoder_attention_heads": heads, "decoder_attention_heads": heads,
        "encoder_ffn_dim": ffn, "decoder_ffn_dim": ffn,
        "num_mel_bins": n_mels, "vocab_size": vocab_size,
        "max_source_positions": max_source_positions,
        "max_target_positions": max_target_positions,
        "bos_token_id": 50257, "eos_token_id": 50257, "pad_token_id": 50257,
        "decoder_start_token_id": 50258, "activation_function": "gelu",
        "scale_embedding": False, "tie_word_embeddings": True,
    }


# openai/whisper-large-v3-turbo's published widths
WHISPER_LARGE_V3_TURBO = whisper_config_dict(
    1280, (32, 4), 20, 5120, 128, 51_866)


def _f16_draws(rng, shape, scale: float) -> np.ndarray:
    """Seeded float16 values drawn as raw bits: a random sign and mantissa,
    magnitudes in [2^e, 2^(e+1)) for e = floor(log2(scale)). Several times
    faster than normal draws, which matters at 809 M parameters."""
    n = int(np.prod(shape))
    bits = np.frombuffer(rng.bytes(2 * n), np.uint16).copy()
    bits &= np.uint16(0x83FF)                      # sign and mantissa
    bits |= np.uint16((math.floor(math.log2(scale)) + 15) << 10)
    return bits.view(np.float16).reshape(shape)


def whisper_tensors(config: dict, seed: int = 0,
                    dtype=np.float32) -> dict[str, np.ndarray]:
    """Seeded random weights (``_f16_draws``) under the HF Whisper tensor
    names (``model.encoder.*``, ``model.decoder.*``; the head is tied to
    the token embedding), stored in ``dtype``."""
    rng = np.random.default_rng(seed)
    D, F = config["d_model"], config["encoder_ffn_dim"]
    out: dict[str, np.ndarray] = {}

    def put(name, shape, std, mean=0.0):
        a = _f16_draws(rng, shape, std)
        if mean:
            a = a.astype(np.float32) + np.float32(mean)
        out[f"model.{name}"] = a.astype(dtype, copy=False)

    def attn(p):
        for proj in ("q", "k", "v", "out"):
            put(f"{p}.{proj}_proj.weight", (D, D), 0.02)
            if proj != "k":  # Whisper's key projections have no bias
                put(f"{p}.{proj}_proj.bias", (D,), 0.02)

    def norm(p):
        put(f"{p}.weight", (D,), 0.05, mean=1.0)
        put(f"{p}.bias", (D,), 0.02)

    def block(p, cross: bool):
        attn(f"{p}.self_attn")
        norm(f"{p}.self_attn_layer_norm")
        if cross:
            attn(f"{p}.encoder_attn")
            norm(f"{p}.encoder_attn_layer_norm")
        put(f"{p}.fc1.weight", (F, D), 0.02)
        put(f"{p}.fc1.bias", (F,), 0.02)
        put(f"{p}.fc2.weight", (D, F), 0.02)
        put(f"{p}.fc2.bias", (D,), 0.02)
        norm(f"{p}.final_layer_norm")

    put("encoder.conv1.weight", (D, config["num_mel_bins"], 3), 0.1)
    put("encoder.conv1.bias", (D,), 0.02)
    put("encoder.conv2.weight", (D, D, 3), 0.02)
    put("encoder.conv2.bias", (D,), 0.02)
    put("encoder.embed_positions.weight",
        (config["max_source_positions"], D), 0.02)
    for i in range(config["encoder_layers"]):
        block(f"encoder.layers.{i}", cross=False)
    norm("encoder.layer_norm")
    put("decoder.embed_tokens.weight", (config["vocab_size"], D), 0.02)
    put("decoder.embed_positions.weight",
        (config["max_target_positions"], D), 0.02)
    for i in range(config["decoder_layers"]):
        block(f"decoder.layers.{i}", cross=True)
    norm("decoder.layer_norm")
    return out


def _whisper_vocab(n_base: int, seed: int) -> tuple[dict, list]:
    """A byte-level BPE vocabulary of ``n_base`` entries (the 256 byte
    characters, then merges of earlier entries) and its merge list."""
    from .tokenizer import bytes_to_unicode

    rng = np.random.default_rng(seed)
    tokens = list(bytes_to_unicode().values())
    vocab = {t: i for i, t in enumerate(tokens)}
    merges = []
    while len(tokens) < n_base:  # pairs drawn in bulk from the entries so far
        for a, b in rng.integers(0, len(tokens), (4096, 2)).tolist():
            new = tokens[a] + tokens[b]
            if len(new) > 12 or new in vocab:
                continue
            merges.append(f"{tokens[a]} {tokens[b]}")
            vocab[new] = len(tokens)
            tokens.append(new)
            if len(tokens) == n_base:
                break
    return vocab, merges


def write_whisper_tokenizer(path: str, vocab_size: int, seed: int = 0,
                            eos_id: int = 50257) -> None:
    """The tokenizer files of an HF Whisper snapshot over the whole
    vocabulary: ``vocab.json`` (byte-level BPE entries below ``eos_id``),
    ``merges.txt``, ``added_tokens.json`` (``<|endoftext|>``,
    ``<|startoftranscript|>``, the language and task tokens, then
    timestamps ``<|0.00|>``... up to ``vocab_size``),
    ``special_tokens_map.json`` and ``tokenizer_config.json`` (the
    timestamps are not special; spaces are cleaned up, as published)."""
    vocab, merges = _whisper_vocab(eos_id, seed)
    specials = (["<|endoftext|>", "<|startoftranscript|>"]
                + [f"<|{lang}|>" for lang in WHISPER_LANGUAGES]
                + list(WHISPER_TASKS))
    n_stamps = vocab_size - eos_id - len(specials)
    if n_stamps < 0:
        raise ValueError(f"vocab_size {vocab_size} leaves no room for the "
                         f"{len(specials)} special tokens after {eos_id}")
    added = specials + [f"<|{0.02 * i:.2f}|>" for i in range(n_stamps)]
    added_ids = {tok: eos_id + i for i, tok in enumerate(added)}
    extra = specials[1:]
    os.makedirs(path, exist_ok=True)
    files = {
        "vocab.json": vocab,
        "added_tokens.json": added_ids,
        "special_tokens_map.json": {
            "bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
            "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>",
            "additional_special_tokens": extra},
        "tokenizer_config.json": {
            "tokenizer_class": "WhisperTokenizer",
            "bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
            "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>",
            "additional_special_tokens": extra,
            "clean_up_tokenization_spaces": True,
            "model_max_length": 1024,
            "added_tokens_decoder": {
                str(i): {"content": tok, "special": tok in specials,
                         "lstrip": False, "rstrip": False,
                         "normalized": False, "single_word": False}
                for tok, i in added_ids.items()}},
    }
    for name, obj in files.items():
        with open(os.path.join(path, name), "w", encoding="utf-8") as fh:
            json.dump(obj, fh, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as fh:
        fh.write("#version: 0.2\n" + "\n".join(merges) + "\n")


def write_whisper_snapshot(path: str, config: dict, seed: int = 0,
                           dtype=np.float32) -> str:
    """An HF Whisper snapshot: ``config.json``, ``model.safetensors``
    (``whisper_tensors`` in ``dtype``, written by
    ``engine/safetensors_io.py``) and the tokenizer files of
    ``write_whisper_tokenizer``. Returns ``path``."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(config, fh, indent=1)
    save_file(whisper_tensors(config, seed, dtype),
              os.path.join(path, "model.safetensors"))
    write_whisper_tokenizer(path, config["vocab_size"], seed,
                            config["eos_token_id"])
    return path
