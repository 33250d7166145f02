"""Checkpoint loading and saving, and parameter trees between numpy and torch.

Two on-disk formats (the JAX package's ``engine/weights.py``, read and
written here with ``engine/safetensors_io.py`` instead of the
``safetensors`` package, and bf16 leaves kept as torch tensors instead of
``ml_dtypes`` arrays):

1. **Native format** (``save_model``): ``tts_config.json`` (the whole
   ModelConfig) plus one ``<component>.safetensors`` per component
   (talker / code_predictor / codec) named by ``/``-joined tree paths,
   bf16 leaves stored as uint16 under ``<path>::bf16``. A directory
   written by either package loads in the other.
2. **HF/MLX import** (``import_hf_checkpoint``): ``config.json`` plus
   ``*.safetensors`` with Qwen-style names, optionally MLX-quantized
   (uint32-packed codes with per-group ``scales``/``biases``). The first
   import writes the native cache ``_tpu_native/`` inside the snapshot.

Import is strict: a component whose tensors are present but none map
raises ``CheckpointImportError``, a missing component raises unless
``allow_partial=True`` (then it keeps its random init, with a warning, and
the conversion is not cached), and unmapped tensor names are reported in
``model.import_report``. A ``_tpu_rename.json`` ``{checkpoint_name:
new_name}`` next to the safetensors adapts unusual names.

The trees are made by the init functions with a template source
(``models/init.py::TemplateInit``: shapes and types, no values drawn), and
the mapping fills them. A drawn leaf the checkpoint leaves unfilled gets
what the JAX importer leaves there, its random init of the JAX seed,
drawn only as far as that leaf (``_fill_unassigned``).

``speech_tokenizer.*`` tensors in the Mimi layout map onto the cloning
encoder (``models/speech_tokenizer.py``: ``model.st_params``/``st_cfg``,
written to the native cache as ``speech_tokenizer.safetensors``); an
unknown layout, or a code space unlike the codec's, is kept verbatim in
``st_raw`` (``speech_tokenizer_raw.safetensors``) and reported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
import warnings
from typing import Any

import numpy as np
import torch

from . import configs
from .configs import (
    Code2WavConfig,
    CodecConfig,
    CodePredictorConfig,
    ModelConfig,
    QuantConfig,
    TalkerConfig,
)
from .safetensors_io import load_file, save_file
from ..models.init import InitPlan
from ..ops.quant import dequantize, quantize_weights, unpack_mlx_uint32

NATIVE_DIR = "_tpu_native"
NATIVE_CONFIG = "tts_config.json"
RENAME_FILE = "_tpu_rename.json"
_COMPONENTS = ("talker", "code_predictor", "codec")


class CheckpointImportError(ValueError):
    """A checkpoint's tensors are present but could not be mapped onto the
    model trees (unrecognised layout), or required components are missing
    and ``allow_partial`` was not set."""


@dataclasses.dataclass
class ImportReport:
    """What an HF/MLX import did, attached to the model as
    ``import_report``."""

    assigned: dict[str, int]           # component -> tensors mapped
    synthetic: tuple[str, ...]         # components that kept their init
    unmapped: list[str]                # checkpoint tensor names not consumed
    # speech_tokenizer.*: {"tensors", "mapped", "family", "preserved",
    # "names"}
    speech_tokenizer: dict | None = None
    # {"source": "file"|"chat_template"|"synthetic", "samples": {mode: str}}
    prompt_template: dict | None = None


# --------------------------------------------------------------------------
# trees
# --------------------------------------------------------------------------

def array_to_tensor(a, device) -> torch.Tensor:
    """One numpy leaf -> tensor on ``device`` (bf16 bit-exact)."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def tree_to(tree: Any, device) -> Any:
    """Move every leaf of a dict/list tree (tensors or numpy arrays) to
    ``device`` as tensors."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return array_to_tensor(tree, device)


def params_from_numpy(params, cp_params, codec_params, *, device):
    """(talker, code predictor, codec) numpy trees -> tensor trees on
    ``device``; structure, dtypes and values are kept."""
    return (tree_to(params, device), tree_to(cp_params, device),
            tree_to(codec_params, device))


def flatten_tree(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Flatten a nested dict/list tree into {``a/b/0/c``: leaf}."""
    out: dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def unflatten_tree(flat: dict[str, Any]) -> Any:
    """Inverse of ``flatten_tree``. Integer path segments become lists."""
    root: dict = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def materialise(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(re.fullmatch(r"\d+", k) for k in keys):
            return [materialise(node[str(i)]) for i in range(len(keys))]
        return {k: materialise(v) for k, v in node.items()}

    return materialise(root)


def _leaves(tree: Any, path: tuple = ()):
    """(path, leaf) of every leaf; list and tuple indices are ints."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _get(tree: Any, path: tuple) -> Any:
    for p in path:
        tree = tree[p]
    return tree


# --------------------------------------------------------------------------
# config (de)serialisation
# --------------------------------------------------------------------------

def config_to_dict(cfg: ModelConfig) -> dict:
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict) -> ModelConfig:
    def build(cls, sub):
        def tup(v):  # deep list -> tuple (speaker_tokens nests pairs)
            return tuple(tup(x) for x in v) if isinstance(v, list) else v

        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tup(v) for k, v in sub.items() if k in fields})

    return ModelConfig(
        mode=d.get("mode", "custom"),
        talker=build(TalkerConfig, d.get("talker", {})),
        code_predictor=build(CodePredictorConfig, d.get("code_predictor", {})),
        codec=build(CodecConfig, d.get("codec", {})),
        quant=build(QuantConfig, d.get("quant", {})),
        codec_arch=d.get("codec_arch", "rvq"),
        code2wav=(build(Code2WavConfig, d["code2wav"]) if d.get("code2wav")
                  else None),
        dtype=d.get("dtype", "bfloat16"),
        max_seq_len=d.get("max_seq_len", 3072),
        native_speed=d.get("native_speed", False),
        speakers=tuple(d.get("speakers", ModelConfig().speakers)),
    )


# --------------------------------------------------------------------------
# native format
# --------------------------------------------------------------------------

def _save_tree(tree: Any, path: str) -> None:
    out = {}
    for name, leaf in flatten_tree(tree).items():
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            out[f"{name}::bf16"] = t.view(torch.uint16)
        else:
            out[name] = t
    save_file(out, path)


def save_model(model, path: str) -> None:
    """Write a loaded model to ``path`` in native format."""
    os.makedirs(path, exist_ok=True)
    cfg_d = config_to_dict(model.cfg)
    if getattr(model, "sampling", None) is not None:
        # the adopted talker sampling (generation_config.json intent): a
        # native dir outside the snapshot has no other record of it
        cfg_d["sampling"] = dataclasses.asdict(model.sampling)
    if getattr(model, "st_cfg", None) is not None:
        cfg_d["speech_tokenizer"] = dataclasses.asdict(model.st_cfg)
    with open(os.path.join(path, NATIVE_CONFIG), "w") as f:
        json.dump(cfg_d, f, indent=2)
    trees = {"talker": model.params, "code_predictor": model.cp_params,
             "codec": model.codec_params}
    if getattr(model, "st_params", None) is not None:
        trees["speech_tokenizer"] = model.st_params
    if getattr(model, "st_raw", None):
        # unmapped speech_tokenizer tensors, verbatim
        save_file({k: torch.as_tensor(v) for k, v in model.st_raw.items()},
                  os.path.join(path, "speech_tokenizer_raw.safetensors"))
    for comp, tree in trees.items():
        _save_tree(tree, os.path.join(path, f"{comp}.safetensors"))


def _load_component(path: str, comp: str) -> Any:
    flat = {}
    for name, t in load_file(os.path.join(path, f"{comp}.safetensors")).items():
        if name.endswith("::bf16"):
            flat[name[: -len("::bf16")]] = t.view(torch.bfloat16)
        else:
            flat[name] = t
    return unflatten_tree(flat)


def is_native_dir(path: str) -> bool:
    return os.path.exists(os.path.join(path, NATIVE_CONFIG))


def load_native(path: str):
    """A native-format directory (either package's) -> Qwen3TTSModel with
    host trees, its mapped speech tokenizer included."""
    from ..runtime.prompts import load_prompt_template
    from ..runtime.sampling import SamplingConfig
    from .api import Qwen3TTSModel
    from .tokenizer import load_tokenizer

    with open(os.path.join(path, NATIVE_CONFIG)) as f:
        cfg_d = json.load(f)
    cfg = config_from_dict(cfg_d)
    trees = {c: _load_component(path, c) for c in _COMPONENTS}
    st_params = st_cfg = st_raw = None
    if isinstance(cfg_d.get("speech_tokenizer"), dict) and os.path.exists(
            os.path.join(path, "speech_tokenizer.safetensors")):
        from ..models.speech_tokenizer import SpeechTokenizerConfig

        fields = {f.name for f in dataclasses.fields(SpeechTokenizerConfig)}
        st_cfg = SpeechTokenizerConfig(**{
            k: (tuple(v) if isinstance(v, list) else v)
            for k, v in cfg_d["speech_tokenizer"].items() if k in fields})
        st_params = _load_component(path, "speech_tokenizer")
    raw_p = os.path.join(path, "speech_tokenizer_raw.safetensors")
    if os.path.exists(raw_p):
        st_raw = load_file(raw_p)
    # template and tokenizer files live in the snapshot root when this is
    # its _tpu_native cache
    aux = os.path.dirname(os.path.normpath(path)) if (
        os.path.basename(os.path.normpath(path)) == NATIVE_DIR) else path
    return Qwen3TTSModel(
        cfg=cfg,
        params=trees["talker"],
        cp_params=trees["code_predictor"],
        codec_params=trees["codec"],
        tokenizer=load_tokenizer(aux, cfg.talker.vocab_size),
        device=torch.device("cpu"),
        template=load_prompt_template(aux),
        name=os.path.basename(os.path.normpath(path)),
        sampling=(SamplingConfig(**cfg_d["sampling"])
                  if isinstance(cfg_d.get("sampling"), dict)
                  else sampling_from_generation_config(aux)),
        st_params=st_params,
        st_cfg=st_cfg,
        st_raw=st_raw,
    )


# --------------------------------------------------------------------------
# HF / MLX import: config
# --------------------------------------------------------------------------

def _read_hf_config(path: str) -> dict:
    p = os.path.join(path, "config.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return {}


def sampling_from_generation_config(path: str):
    """The checkpoint's intended talker sampling (generation_config.json
    do_sample/temperature/top_k/top_p), or None when absent or unreadable.
    As in HF GenerationConfig, do_sample defaults to false: a file with
    only temperature/top_p decodes greedily."""
    from ..runtime.sampling import SamplingConfig

    p = os.path.join(path, "generation_config.json")
    if not os.path.exists(p):
        return None
    try:
        with open(p) as f:
            gc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(gc, dict):
        return None
    if not any(k in gc for k in ("do_sample", "temperature", "top_k", "top_p")):
        return None

    def _num(name, default, cast):
        v = gc.get(name)
        return default if v is None else cast(v)  # HF serializes nulls

    if not _num("do_sample", False, bool):
        return SamplingConfig(greedy=True)
    return SamplingConfig(
        temperature=_num("temperature", 0.9, float),
        top_k=_num("top_k", 50, int),
        top_p=_num("top_p", 1.0, float),
    )


def _first(d: dict, *keys, default=None):
    for k in keys:
        if k in d and d[k] is not None:
            return d[k]
    return default


def _prompt_head_ids(talker_cfg: dict) -> dict:
    """Codec prompt-head ids from a checkpoint config, all or none."""
    ids = {
        "codec_nothink": _first(talker_cfg, "codec_nothink_id",
                                "codec_nothink_token_id", default=None),
        "codec_think_bos": _first(talker_cfg, "codec_think_bos_id",
                                  "codec_think_bos_token_id", default=None),
        "codec_think_eos": _first(talker_cfg, "codec_think_eos_id",
                                  "codec_think_eos_token_id", default=None),
    }
    n = sum(v is not None for v in ids.values())
    if 0 < n < 3:
        warnings.warn(
            f"checkpoint defines only {n}/3 codec prompt-head ids "
            f"({ids}); ignoring the partial head (unrecognised key "
            "spelling? add the missing id via _tpu_rename.json-style "
            "config override)"
        )
        return {k: None for k in ids}
    return ids


def _config_from_hf(hf: dict, mode: str) -> ModelConfig:
    """ModelConfig from an HF config.json: talker dims from the top level or
    ``talker_config``; code-predictor and codec geometry from their own
    sections when present. Unknown fields keep the flagship's values."""
    base = configs.flagship(mode)
    talker_cfg = hf.get("talker_config", hf.get("text_config", hf))
    t = base.talker
    talker = dataclasses.replace(
        t,
        vocab_size=talker_cfg.get("vocab_size", t.vocab_size),
        hidden=talker_cfg.get("hidden_size", t.hidden),
        n_layers=talker_cfg.get("num_hidden_layers", t.n_layers),
        n_heads=talker_cfg.get("num_attention_heads", t.n_heads),
        n_kv_heads=talker_cfg.get("num_key_value_heads", t.n_kv_heads),
        head_dim=talker_cfg.get("head_dim", t.head_dim),
        ffn=talker_cfg.get("intermediate_size", t.ffn),
        rope_theta=talker_cfg.get("rope_theta", t.rope_theta),
        rms_eps=talker_cfg.get("rms_norm_eps", t.rms_eps),
        codec_vocab=_first(talker_cfg, "codec_vocab_size", "codec_vocab",
                           default=t.codec_vocab),
        codec_bos=_first(talker_cfg, "codec_bos_token_id", "codec_bos_id",
                         default=t.codec_bos),
        codec_eos=_first(talker_cfg, "codec_eos_token_id", "codec_eos_id",
                         default=t.codec_eos),
        codec_pad=_first(talker_cfg, "codec_pad_token_id", "codec_pad_id",
                         default=t.codec_pad),
        **_prompt_head_ids(talker_cfg),
        # speaker-name -> codec-token map (talker_config.speaker_id)
        speaker_tokens=tuple(
            sorted((str(k).lower(), int(v))
                   for k, v in talker_cfg["speaker_id"].items())
        ) if isinstance(talker_cfg.get("speaker_id"), dict) else None,
        n_speakers=_first(talker_cfg, "num_speakers", "n_speakers",
                          default=t.n_speakers),
        frames_per_step=_first(talker_cfg, "frames_per_step",
                               default=t.frames_per_step),
        # trailing-text control ids; import_hf_checkpoint switches the
        # protocol only when the whole evidence set is present
        tts_pad_id=_first(hf, "tts_pad_token_id",
                          default=_first(talker_cfg, "tts_pad_token_id",
                                         default=None)),
        tts_bos_id=_first(hf, "tts_bos_token_id",
                          default=_first(talker_cfg, "tts_bos_token_id",
                                         default=None)),
        tts_eos_id=_first(hf, "tts_eos_token_id",
                          default=_first(talker_cfg, "tts_eos_token_id",
                                         default=None)),
    )

    cp = base.code_predictor
    cp_cfg = _first(hf, "code_predictor_config", "mtp_config", default={})
    if isinstance(cp_cfg, dict) and cp_cfg:
        cp = dataclasses.replace(
            cp,
            hidden=cp_cfg.get("hidden_size", cp.hidden),
            n_layers=cp_cfg.get("num_hidden_layers", cp.n_layers),
            n_heads=cp_cfg.get("num_attention_heads", cp.n_heads),
            head_dim=cp_cfg.get("head_dim", cp.head_dim),
            ffn=cp_cfg.get("intermediate_size", cp.ffn),
            rms_eps=cp_cfg.get("rms_norm_eps", cp.rms_eps),
            rope_theta=cp_cfg.get("rope_theta", cp.rope_theta),
        )

    cc = base.codec
    # code2wav_config is not read here: a checkpoint carrying it switches
    # to the code2wav decoder below (configs.with_code2wav derives this
    # section from its geometry)
    cc_cfg = _first(hf, "codec_config", "speech_tokenizer_config", default={})
    if isinstance(cc_cfg, dict) and cc_cfg:
        cc = dataclasses.replace(
            cc,
            sample_rate=_first(cc_cfg, "sample_rate", "sampling_rate",
                               default=cc.sample_rate),
            frame_rate=_first(cc_cfg, "frame_rate", default=cc.frame_rate),
            num_codebooks=_first(cc_cfg, "num_codebooks", "num_quantizers",
                                 default=cc.num_codebooks),
            codebook_size=cc_cfg.get("codebook_size", cc.codebook_size),
            residual_codebook_size=_first(
                cc_cfg, "residual_codebook_size",
                default=cc.residual_codebook_size),
            latent_dim=_first(cc_cfg, "latent_dim", "codebook_dim",
                              default=cc.latent_dim),
            upsample_rates=tuple(_first(cc_cfg, "upsample_rates",
                                        "upsampling_ratios",
                                        default=cc.upsample_rates)),
            decoder_channels=tuple(cc_cfg.get("decoder_channels",
                                              cc.decoder_channels)),
            decoder_kernel=_first(cc_cfg, "decoder_kernel",
                                  "decoder_kernel_size",
                                  default=cc.decoder_kernel),
            n_transformer_layers=_first(cc_cfg, "n_transformer_layers",
                                        "num_transformer_layers",
                                        default=cc.n_transformer_layers),
            transformer_heads=_first(cc_cfg, "transformer_heads",
                                     "num_transformer_heads",
                                     default=cc.transformer_heads),
        )

    quant = base.quant
    qcfg = hf.get("quantization", hf.get("quantization_config"))
    if isinstance(qcfg, dict):
        quant = QuantConfig(bits=qcfg.get("bits", 8),
                            group_size=qcfg.get("group_size", 64),
                            enabled=True)
    # real checkpoints honor the speed control tag natively
    out = dataclasses.replace(
        base, talker=talker, code_predictor=cp, codec=cc, quant=quant,
        native_speed=True,
        speakers=(tuple(n for n, _ in talker.speaker_tokens)
                  if talker.speaker_tokens else base.speakers),
    )
    c2w_cfg = hf.get("code2wav_config")
    if isinstance(c2w_cfg, dict) and c2w_cfg:
        out = configs.with_code2wav(out, Code2WavConfig.from_hf_dict(c2w_cfg))
    return out


# --------------------------------------------------------------------------
# HF / MLX import: tensor mapping
# --------------------------------------------------------------------------

# Qwen-style per-layer linear bases -> stacked-block tree paths
_BLOCK_LINEARS = {
    "self_attn.q_proj": "attn/q",
    "self_attn.k_proj": "attn/k",
    "self_attn.v_proj": "attn/v",
    "self_attn.o_proj": "attn/o",
    "mlp.gate_proj": "mlp/gate",
    "mlp.up_proj": "mlp/up",
    "mlp.down_proj": "mlp/down",
}
# Qwen-style per-layer norm tensors (exact names) -> stacked-block paths
_BLOCK_NORMS = {
    "self_attn.q_norm.weight": "attn/q_norm",
    "self_attn.k_norm.weight": "attn/k_norm",
    "input_layernorm.weight": "ln1",
    "post_attention_layernorm.weight": "ln2",
}
_TALKER_TOP_MAP = {
    "model.embed_tokens.weight": "text_emb",
    "embed_tokens.weight": "text_emb",
    "model.codec_embed_tokens.weight": "codec_emb",
    "codec_embed_tokens.weight": "codec_emb",
    "codec_embedding.weight": "codec_emb",
    "model.norm.weight": "ln_f",
    "norm.weight": "ln_f",
    # codec_head takes precedence over lm_head (first assignment wins and
    # names are scanned in sorted order); a text-vocab lm_head also fails
    # the shape check against the codec-vocab head slot
    "codec_head": "head",
    "lm_head": "head",
    "speaker_embedding.weight": "spk_emb",
    "spk_embed.weight": "spk_emb",
}
_TALKER_DENSE = frozenset({"text_emb", "codec_emb", "spk_emb", "ln_f"})
_CP_TOP_MAP = {
    "in_proj": "in_proj",
    "hidden_proj": "in_proj",
    "model.in_proj": "in_proj",
    "cb0_embedding.weight": "cb0_emb",
    "codec_embedding.weight": "cb0_emb",
    "embed_tokens.weight": "cb0_emb",
    "res_embedding.weight": "res_emb",     # stacked [Q-1, V_res, H]
    "heads.weight": "heads",               # stacked [Q-1, V_res, H]
    "norm.weight": "ln_f",
    "model.norm.weight": "ln_f",
}
_CP_DENSE = frozenset({"cb0_emb", "res_emb", "heads", "ln_f"})
# per-codebook variants: res_embeddings.3.weight -> res_emb[3]; the
# published layout's lm_head.{i} and model.codec_embedding.{i} ModuleLists
_CP_INDEXED = {"res_embeddings": "res_emb", "res_embs": "res_emb",
               "codec_embedding": "res_emb", "res_embedding": "res_emb",
               "heads": "heads", "lm_heads": "heads", "lm_head": "heads"}
_INDEXED_RE = re.compile(r"^(?:model\.)?([A-Za-z_]+)\.(\d+)\.weight$")
_LAYER_RE = re.compile(r"^(?:model\.)?layers\.(\d+)\.(.+)$")


def _collect_safetensors(path: str) -> dict[str, torch.Tensor]:
    tensors: dict[str, torch.Tensor] = {}
    for fname in sorted(os.listdir(path)):
        if fname.endswith(".safetensors"):
            tensors.update(load_file(os.path.join(path, fname)))
    return tensors


def _strip_prefix(name: str) -> tuple[str, str]:
    """(component, remainder); components talker / codec / cp / spk_enc."""
    for pref, comp in (
        ("code_predictor.", "cp"),
        ("code2wav.", "codec"),
        # the base checkpoint's reference-audio speech tokenizer
        ("speech_tokenizer.", "spk_enc"),
        ("codec.", "codec"),
        ("token2wav.", "codec"),
    ):
        if name.startswith(pref):
            return comp, name[len(pref):]
    for pref in ("talker.", "model.talker.", "thinker."):
        if name.startswith(pref):
            return "talker", name[len(pref):]
    return "talker", name


def _shape(x) -> tuple:
    return tuple(x.shape)


def _gather_quantized(names: dict, base: str, group_size: int,
                      bits: int) -> dict | None:
    """One linear's param dict from the tensors rooted at ``base``:
    MLX-quantized (weight + scales + biases) or a plain weight."""
    w = names.get(f"{base}.weight")
    scales = names.get(f"{base}.scales")
    biases = names.get(f"{base}.biases")
    if w is None:
        return None
    if scales is not None:
        codes = unpack_mlx_uint32(w, bits, scales.shape[-1] * group_size)
        if biases is None:
            biases = torch.zeros_like(scales)
        return {"q": codes.contiguous(), "scale": scales.float(),
                "bias": biases.float()}
    return {"w": w}


def _extract_text_projection(tk: dict, gs: int, bits: int):
    """Pull the talker's text_projection MLP (biased linear_fc1 -> act ->
    biased linear_fc2) out of ``tk``: (its tree or None, tensors
    consumed)."""
    names = [n for n in tk if "text_projection" in n]
    if not names:
        return None, 0
    out: dict = {}
    consumed: list[str] = []
    for fc, key in (("linear_fc1", "fc1"), ("linear_fc2", "fc2")):
        base = next((n[: -len(".weight")] for n in names
                     if fc in n and n.endswith(".weight")), None)
        if base is None:
            raise CheckpointImportError(
                f"text_projection tensors present but {fc}.weight missing "
                f"(found: {sorted(names)[:6]}) — layout unrecognised"
            )
        lin = _gather_quantized(tk, base, gs, bits)
        bias = tk.get(f"{base}.bias")
        if bias is not None:
            lin = dict(lin, b=bias)
            consumed.append(f"{base}.bias")
        out[key] = lin
        for suf in (".weight", ".scales", ".biases"):
            if f"{base}{suf}" in tk:
                consumed.append(f"{base}{suf}")
    for n in consumed:
        tk.pop(n, None)
    return out, len(consumed)


def _match_linear_format(value: dict, slot: dict, gs: int, bits: int) -> dict:
    """A gathered linear in the slot's format (quantized <-> dense)."""
    if ("q" in slot) == ("q" in value):
        return value
    if "q" in slot:  # slot quantized, checkpoint dense
        w = torch.as_tensor(value["w"]).float().numpy()
        return {k: torch.from_numpy(v) for k, v in
                quantize_weights(w, group_size=gs, bits=bits).items()}
    return {"w": dequantize(value).float()}


def _shape_ok(slot, value) -> bool:
    if isinstance(slot, dict):
        return isinstance(value, dict) and set(slot) == set(value) and all(
            _shape(slot[k]) == _shape(value[k]) for k in slot)
    return not isinstance(value, dict) and _shape(slot) == _shape(value)


def _promote(stack: torch.Tensor, value) -> torch.Tensor:
    """Checkpoint precision wins: f32 values written into a bf16 stack
    widen the stack instead of rounding."""
    want = torch.promote_types(stack.dtype, value.dtype)
    return stack if stack.dtype == want else stack.to(want)


def _try_native_path(tree: Any, name: str, arr, filled: set,
                     prefix: tuple = ()) -> bool:
    """Assign a tensor named by a dotted tree path (``dec.stages.0.up.w``),
    shape-checked; False if the path or shape does not match."""
    parts = name.split(".")
    path = []
    node = tree
    for p in parts[:-1]:
        if isinstance(node, dict) and p in node:
            node = node[p]
            path.append(p)
        elif (isinstance(node, (list, tuple)) and p.isdigit()
              and int(p) < len(node)):
            node = node[int(p)]
            path.append(int(p))
        else:
            return False
    leaf = parts[-1]
    if isinstance(node, dict) and leaf in node:
        key = leaf
    elif isinstance(node, list) and leaf.isdigit() and int(leaf) < len(node):
        key = int(leaf)
    else:
        return False
    slot = node[key]
    if isinstance(slot, dict) or _shape(slot) != _shape(arr):
        return False
    node[key] = arr
    filled.add((prefix + tuple(path) + (key,), None))
    return True


def _import_transformer(
    tree: dict,
    tk: dict,
    *,
    n_layers: int,
    top_map: dict[str, str],
    dense_dests: frozenset,
    gs: int,
    bits: int,
    unmapped: list[str],
    comp: str,
    filled: set,
    prefix: tuple = (),
    indexed: dict[str, str] | None = None,
    block_norms: dict[str, str] | None = None,
) -> int:
    """Map Qwen-style transformer tensor names onto a stacked-block tree
    (the talker, the code predictor and the code2wav pre-transformer).
    Every assignment is checked against the slot's shape; failures land in
    ``unmapped`` with a reason, assignments in ``filled`` as (tree path
    under ``prefix``, row or None). Returns the number of mapped
    tensors."""
    count = 0
    consumed: set[str] = set()
    assigned_tops: set[str] = set()
    if block_norms is None:
        block_norms = _BLOCK_NORMS

    def fail(name: str, why: str) -> None:
        unmapped.append(f"{comp}:{name} ({why})")

    def put_top(dest: str, value) -> bool:
        nonlocal count
        if dest in assigned_tops:
            return False
        slot = tree[dest]
        if isinstance(value, dict):
            value = _match_linear_format(value, slot, gs, bits)
        if not _shape_ok(slot, value):
            return False
        # checkpoint precision is kept (f32 tables stay f32)
        tree[dest] = value
        assigned_tops.add(dest)
        filled.add((prefix + (dest,), None))
        count += 1
        return True

    def put_block(rel_path: str, value, layer: int) -> bool:
        nonlocal count
        node = tree["blocks"]
        parts = rel_path.split("/")
        for p in parts[:-1]:
            node = node[p]
        leaf = parts[-1]
        slot = node[leaf]
        if isinstance(value, dict):
            slot_layer = {k: v[layer] for k, v in slot.items()}
            value = _match_linear_format(value, slot_layer, gs, bits)
            if not _shape_ok(slot_layer, value):
                return False
            for k, v in value.items():
                slot[k] = _promote(slot[k], v)
                slot[k][layer] = v
        else:
            if _shape(slot[layer]) != _shape(value):
                return False
            slot = _promote(slot, value)
            slot[layer] = value
            node[leaf] = slot
        filled.add((prefix + ("blocks", *parts), layer))
        count += 1
        return True

    for name in sorted(tk.keys()):
        if name in consumed or name.endswith((".scales", ".biases")):
            continue
        arr = tk[name]
        m = _LAYER_RE.match(name)
        if m:
            layer, rest = int(m.group(1)), m.group(2)
            if layer >= n_layers:
                fail(name, f"layer {layer} >= n_layers {n_layers}")
                continue
            if rest in block_norms:
                if put_block(block_norms[rest], arr, layer):
                    consumed.add(name)
                else:
                    fail(name, "shape mismatch")
                continue
            base = rest[: -len(".weight")] if rest.endswith(".weight") else rest
            if base in _BLOCK_LINEARS:
                base_name = name[: len(name) - len(rest)] + base
                p = _gather_quantized(tk, base_name, gs, bits)
                if p is not None and put_block(_BLOCK_LINEARS[base], p, layer):
                    for suf in (".weight", ".scales", ".biases"):
                        consumed.add(base_name + suf)
                    continue
                fail(name, "shape mismatch")
                continue
            fail(name, "unrecognised block tensor")
            continue

        mi = _INDEXED_RE.match(name) if indexed else None
        if mi and mi.group(1) in indexed:
            dest, idx = indexed[mi.group(1)], int(mi.group(2))
            slot = tree[dest]
            if idx < slot.shape[0] and _shape(slot[idx]) == _shape(arr):
                slot = _promote(slot, arr)
                tree[dest] = slot
                slot[idx] = arr
                filled.add((prefix + (dest,), idx))
                count += 1
                consumed.add(name)
            else:
                fail(name, "index/shape mismatch")
            continue

        hit = False
        for frag, dest in top_map.items():
            if name != frag and name != frag + ".weight":
                continue
            base = frag[: -len(".weight")] if frag.endswith(".weight") else frag
            if dest in dense_dests:
                # embeddings and norms stay dense; MLX-quantized tables are
                # dequantized on import
                if f"{base}.scales" in tk:
                    value = dequantize(_gather_quantized(tk, base, gs, bits)).float()
                else:
                    value = arr
                if put_top(dest, value):
                    for suf in ("", ".weight", ".scales", ".biases"):
                        consumed.add(base + suf)
                    hit = True
            else:
                p = _gather_quantized(tk, base, gs, bits)
                if p is not None and put_top(dest, p):
                    for suf in (".weight", ".scales", ".biases"):
                        consumed.add(base + suf)
                    hit = True
            if hit:
                break
        if hit or name in consumed:
            continue
        if _try_native_path(tree, name, arr, filled, prefix):
            count += 1
            continue
        fail(name, "no mapping")
    return count


# HF code2wav tensor-path fragments (transformers Qwen3OmniMoeCode2Wav)
# -> dotted tree paths of models/code2wav.py
_C2W_CONVNEXT = {
    "dwconv.conv.weight": "cnx.dw.w",
    "dwconv.conv.bias": "cnx.dw.b",
    "norm.weight": "cnx.ln_w",
    "norm.bias": "cnx.ln_b",
    "pwconv1.weight": "cnx.pw1.w",
    "pwconv1.bias": "cnx.pw1.b",
    "pwconv2.weight": "cnx.pw2.w",
    "pwconv2.bias": "cnx.pw2.b",
    "gamma": "cnx.gamma",
}
_C2W_BLOCK_NORMS = {
    "input_layernorm.weight": "ln1",
    "post_attention_layernorm.weight": "ln2",
    "self_attn_layer_scale.scale": "ls_attn",
    "mlp_layer_scale.scale": "ls_mlp",
}
_C2W_RES_UNIT = {
    "act1.alpha": "a1.alpha", "act1.beta": "a1.beta",
    "conv1.conv.weight": "c1.w", "conv1.conv.bias": "c1.b",
    "act2.alpha": "a2.alpha", "act2.beta": "a2.beta",
    "conv2.conv.weight": "c2.w", "conv2.conv.bias": "c2.b",
}


def _c2w_native_name(name: str, n_rates: int) -> str | None:
    """An HF code2wav tensor path (after the ``code2wav.`` prefix) -> the
    dotted tree path; None if unrecognised."""
    def wb(s: str) -> str:
        return "w" if s == "weight" else "b"

    m = re.match(r"^upsample\.(\d+)\.0\.conv\.(weight|bias)$", name)
    if m:
        return f"upsample.{m.group(1)}.tconv." + wb(m.group(2))
    m = re.match(r"^upsample\.(\d+)\.1\.(.+)$", name)
    if m and m.group(2) in _C2W_CONVNEXT:
        return f"upsample.{m.group(1)}." + _C2W_CONVNEXT[m.group(2)]
    m = re.match(r"^decoder\.0\.conv\.(weight|bias)$", name)
    if m:
        return "decoder.conv_in." + wb(m.group(1))
    m = re.match(r"^decoder\.(\d+)\.block\.(\d+)\.(.+)$", name)
    if m:
        blk, j, rest = int(m.group(1)) - 1, int(m.group(2)), m.group(3)
        if not 0 <= blk < n_rates:
            return None
        base = f"decoder.blocks.{blk}"
        if j == 0 and rest in ("alpha", "beta"):
            return f"{base}.snake.{rest}"
        if j == 1 and rest in ("conv.weight", "conv.bias"):
            return f"{base}.tconv." + wb(rest.split(".")[1])
        if 2 <= j <= 4:
            sub = _C2W_RES_UNIT.get(rest)
            return f"{base}.res.{j - 2}.{sub}" if sub else None
        return None
    m = re.match(rf"^decoder\.{n_rates + 1}\.(alpha|beta)$", name)
    if m:
        return f"decoder.snake_out.{m.group(1)}"
    m = re.match(rf"^decoder\.{n_rates + 2}\.conv\.(weight|bias)$", name)
    if m:
        return "decoder.conv_out." + wb(m.group(1))
    return None


def _import_code2wav(tree: dict, c2w_cfg, tensors: dict, gs: int, bits: int,
                     unmapped: list[str], filled: set) -> int:
    """Map HF ``code2wav.*`` tensors onto the ``c2w`` tree: the
    pre-transformer through the stacked-block importer, the conv stacks by
    translated tree path. Returns the number of tensors mapped."""
    count = 0
    pre: dict = {}
    rest: dict = {}
    for name, arr in tensors.items():
        if name.startswith("pre_transformer."):
            pre[name[len("pre_transformer."):]] = arr
        else:
            rest[name] = arr
    if pre:
        count += _import_transformer(
            tree["pre"], pre, n_layers=c2w_cfg.n_layers,
            top_map={"norm.weight": "ln_f"}, dense_dests=frozenset({"ln_f"}),
            gs=gs, bits=bits, unmapped=unmapped, comp="code2wav.pre",
            filled=filled, prefix=("c2w", "pre"),
            block_norms=_C2W_BLOCK_NORMS,
        )
    n_rates = len(c2w_cfg.upsample_rates)
    for name in sorted(rest):
        if name.endswith((".scales", ".biases")):
            continue
        arr = rest[name]
        if name in ("code_embedding.weight", "code_embedding"):
            if "code_embedding.scales" in rest:  # MLX-quantized: dequantize
                arr = dequantize(_gather_quantized(
                    rest, "code_embedding", gs, bits)).float()
            if _shape(tree["code_emb"]) == _shape(arr):
                tree["code_emb"] = arr
                filled.add((("c2w", "code_emb"), None))
                count += 1
            else:
                unmapped.append(f"code2wav:{name} (shape mismatch)")
            continue
        native = _c2w_native_name(name, n_rates)
        if native is not None and _try_native_path(tree, native, arr, filled,
                                                   ("c2w",)):
            count += 1
        else:
            unmapped.append(f"code2wav:{name} (no mapping)")
    return count


def _import_codec(tree: dict, tensors: dict, unmapped: list[str],
                  filled: set) -> int:
    """Map codec tensors named by dotted tree paths (``dec.cb0_emb``,
    ``dec.stages.0.up.w``, ``enc...``, ``spk_proj.w``)."""
    count = 0
    for name in sorted(tensors):
        if _try_native_path(tree, name, tensors[name], filled):
            count += 1
        else:
            unmapped.append(f"codec:{name} (no native path / shape mismatch)")
    return count


def _apply_rename(path: str, tensors: dict) -> dict:
    """Apply an optional ``_tpu_rename.json`` {checkpoint_name: new_name}."""
    p = os.path.join(path, RENAME_FILE)
    if not os.path.exists(p):
        return tensors
    with open(p) as f:
        ren = json.load(f)
    return {ren.get(k, k): v for k, v in tensors.items()}


def _fill_unassigned(tree: Any, filled: set, build) -> int:
    """Give every drawn leaf (or stacked row) that the mapping left
    unfilled the value the JAX importer leaves there: its random init of
    the JAX seed. ``build(plan)`` makes the component's tree from an
    InitPlan; the host draws stop after the last draw needed. Returns the
    number of leaves or rows filled."""
    def covered(path):
        whole, rows = False, set()
        for p, r in filled:
            if path[:len(p)] == p:
                if r is None:
                    whole = True
                else:
                    rows.add(r)
        return whole, rows

    todo: list[tuple[tuple, int | None]] = []
    limits: dict[int, int] = {}

    def need(path, row, draw: int) -> None:
        todo.append((path, row))
        k, i = divmod(draw, 2**32)
        limits[k] = max(limits.get(k, 0), i + 1)

    for path, idx in _leaves(build(InitPlan("index"))):
        whole, rows = covered(path)
        if whole:
            continue
        if idx.dim() == 2:                # stacked: one draw a row
            for r in range(idx.shape[0]):
                if idx[r, 0] >= 0 and r not in rows:
                    need(path, r, int(idx[r, 0]))
        elif idx[0] >= 0:                 # one draw for the whole leaf
            if rows:
                for r in range(_get(tree, path).shape[0]):
                    if r not in rows:
                        need(path, r, int(idx[0]))
            else:
                need(path, None, int(idx[0]))
    if not todo:
        return 0
    host = build(InitPlan("host", limits))
    for path, row in todo:
        src = _get(host, path)
        if row is None:
            _get(tree, path[:-1])[path[-1]] = src
        else:
            _get(tree, path)[row] = src[row]
    return len(todo)


def _import_speech_tokenizer(st_tensors: dict, hf_cfg: dict, cfg,
                             unmapped: list[str], assigned: dict):
    """``speech_tokenizer.*`` (the reference-audio encoder of cloning):
    the Mimi layout maps (``models/speech_tokenizer.py``) when its code
    space is the codec's; anything else is preserved verbatim and
    reported, never dropped. Returns (st_params, st_cfg, st_raw, report)."""
    if not st_tensors:
        return None, None, None, None
    from ..models.speech_tokenizer import (
        import_speech_tokenizer, st_config_from_tensors,
    )

    report = {"tensors": len(st_tensors), "mapped": 0, "family": "unknown",
              "preserved": False, "names": sorted(st_tensors)[:12]}
    try:
        st_cfg = st_config_from_tensors(
            st_tensors, hf_cfg.get("speech_tokenizer_config") or {})
    except ValueError as e:
        report["preserved"] = True
        warnings.warn(
            f"checkpoint ships {len(st_tensors)} speech_tokenizer tensors "
            f"in an unrecognised layout ({e}); cloning uses the synthetic "
            "codec encoder and the raw tensors are preserved in the native "
            "conversion. The rest of the checkpoint imports normally.")
        return None, None, dict(st_tensors), report
    report["family"] = "mimi"
    if (st_cfg.num_quantizers != cfg.codec.num_codebooks
            or st_cfg.codebook_size != cfg.codec.codebook_size):
        report["preserved"] = True
        warnings.warn(
            "speech_tokenizer maps as a Mimi-family encoder but its code "
            f"space (Q={st_cfg.num_quantizers}, size={st_cfg.codebook_size}) "
            f"does not match the codec's (Q={cfg.codec.num_codebooks}, "
            f"size={cfg.codec.codebook_size}); the raw tensors are "
            "preserved and cloning uses the synthetic codec encoder")
        return None, None, dict(st_tensors), report
    st_unmapped: list[str] = []
    st_params, n = import_speech_tokenizer(st_tensors, st_cfg, st_unmapped)
    unmapped.extend(st_unmapped)
    report["mapped"] = assigned["speech_tokenizer"] = n
    if n == 0:
        report["preserved"] = True
        warnings.warn(
            "speech_tokenizer tensors matched the Mimi layout by name but "
            "none fit the derived geometry; the raw tensors are preserved "
            "and cloning uses the synthetic codec encoder")
        return None, None, dict(st_tensors), report
    return st_params, st_cfg, None, report


def import_hf_checkpoint(path: str, mode: str = "custom", *,
                         allow_partial: bool = False, seed: int = 0,
                         **kwargs):
    """Import an HF/MLX snapshot directory -> Qwen3TTSModel with host trees
    and ``import_report``. A component whose tensors are present but none
    recognised raises ``CheckpointImportError``; a component with no
    tensors raises unless ``allow_partial=True`` (it then keeps its random
    init of the JAX seed, with a warning). ``seed`` is the talker's init
    seed (the code predictor's is 1, the codec's 2, as in the JAX
    package)."""
    from ..models.code_predictor import init_code_predictor
    from ..models.codec import init_codec
    from ..models.talker import init_talker
    from ..runtime.prompts import load_prompt_template
    from .api import Qwen3TTSModel
    from .tokenizer import load_tokenizer

    hf_cfg = _read_hf_config(path)
    cfg = _config_from_hf(hf_cfg, mode)
    tensors = _apply_rename(path, _collect_safetensors(path))

    by_comp: dict[str, dict] = {"talker": {}, "codec": {}, "cp": {},
                                "spk_enc": {}}
    for name, arr in tensors.items():
        comp, rest = _strip_prefix(name)
        by_comp[comp][rest] = arr
    if by_comp["spk_enc"] and not by_comp["codec"]:
        # no codec tensors elsewhere: the decoder may live inside the
        # speech-tokenizer module; recognised names map, others fail there
        by_comp["codec"], by_comp["spk_enc"] = by_comp["spk_enc"], {}

    gs, bits = cfg.quant.group_size, cfg.quant.bits
    unmapped: list[str] = []
    assigned: dict[str, int] = {}

    st_params, st_cfg, st_raw, st_report = _import_speech_tokenizer(
        by_comp["spk_enc"], hf_cfg, cfg, unmapped, assigned)

    template = InitPlan("template")
    talker = init_talker(cfg, seed, device=template)
    filled_t: set = set()
    # the text_projection MLP comes out first, so that the generic pass
    # does not report its names unmapped
    text_proj, tp_count = _extract_text_projection(by_comp["talker"], gs, bits)
    assigned["talker"] = _import_transformer(
        talker, by_comp["talker"], n_layers=cfg.talker.n_layers,
        top_map=_TALKER_TOP_MAP, dense_dests=_TALKER_DENSE, gs=gs, bits=bits,
        unmapped=unmapped, comp="talker", filled=filled_t,
    )
    if text_proj is not None:
        talker["text_proj"] = text_proj
        assigned["talker"] += tp_count

    if by_comp["cp"]:
        cp_updates = {}
        if not any("q_norm" in n for n in by_comp["cp"]):
            # the published code predictor has no per-head qk-norm
            cp_updates["qk_norm"] = False
        if not any("in_proj" in n or "hidden_proj" in n for n in by_comp["cp"]):
            # no input projection -> the published two-position layout
            # ([talker hidden, cb0 embedding]): widths must match
            if cfg.code_predictor.hidden != cfg.talker.hidden:
                raise CheckpointImportError(
                    "code-predictor checkpoint has no input projection but "
                    f"cp hidden {cfg.code_predictor.hidden} != talker "
                    f"hidden {cfg.talker.hidden}: layout unrecognised"
                )
            cp_updates["input_layout"] = "hidden_token"
            cp_updates["input_proj"] = False
        if cp_updates:
            cfg = dataclasses.replace(cfg, code_predictor=dataclasses.replace(
                cfg.code_predictor, **cp_updates))
        # the published decode protocol: the two-position code predictor,
        # the think markers and all three tts ids -> residual_sum feedback
        # with the published residual sampling; never half a protocol
        t = cfg.talker
        if (cfg.code_predictor.input_layout == "hidden_token"
                and t.codec_prompt_head):
            if all(i is not None for i in
                   (t.tts_pad_id, t.tts_bos_id, t.tts_eos_id)):
                cfg = dataclasses.replace(
                    cfg,
                    talker=dataclasses.replace(t, feedback="residual_sum"),
                    code_predictor=dataclasses.replace(
                        cfg.code_predictor, top_k=50, top_p=0.8),
                )
            else:
                warnings.warn(
                    "checkpoint matches the published code-predictor "
                    "layout and defines codec think markers, but "
                    "tts_{pad,bos,eos}_token_id are missing from its "
                    "config — running the cb0 feedback protocol (the "
                    "trailing-text loop needs those ids); add them via a "
                    "config override if the checkpoint expects the "
                    "published decode loop"
                )
    cp_params = init_code_predictor(cfg, 1, device=template)
    filled_cp: set = set()
    assigned["code_predictor"] = _import_transformer(
        cp_params, by_comp["cp"], n_layers=cfg.code_predictor.n_layers,
        top_map=_CP_TOP_MAP, dense_dests=_CP_DENSE,
        gs=min(gs, cfg.code_predictor.hidden), bits=bits, unmapped=unmapped,
        comp="code_predictor", filled=filled_cp, indexed=_CP_INDEXED,
    )

    codec_params = init_codec(cfg, 2, device=template, encoder=True)
    filled_c: set = set()
    if cfg.codec_arch == "code2wav":
        assigned["codec"] = _import_code2wav(
            codec_params["c2w"], cfg.code2wav, by_comp["codec"], gs, bits,
            unmapped, filled_c)
    else:
        assigned["codec"] = _import_codec(codec_params, by_comp["codec"],
                                          unmapped, filled_c)

    synthetic: list[str] = []
    for comp, label in (("talker", "talker"), ("cp", "code_predictor"),
                        ("codec", "codec")):
        present = len(by_comp[comp])
        if present and assigned[label] == 0:
            raise CheckpointImportError(
                f"{present} {label} tensors present in {path} but none "
                f"recognised — unrecognised layout (first names: "
                f"{sorted(by_comp[comp])[:6]}). Refusing to substitute "
                f"random weights; add a {RENAME_FILE} map or fix the layout."
            )
        if not present:
            if not allow_partial:
                raise CheckpointImportError(
                    f"checkpoint {path} has no {label} tensors; pass "
                    f"allow_partial=True to fall back to synthetic init "
                    f"for missing components"
                )
            synthetic.append(label)
            warnings.warn(f"checkpoint has no {label} tensors; using "
                          "synthetic init (allow_partial)")
    if unmapped:
        warnings.warn(f"{len(unmapped)} unmapped tensors during import "
                      f"(first 10: {unmapped[:10]})")

    _fill_unassigned(talker, filled_t,
                     lambda plan: init_talker(cfg, seed, device=plan))
    _fill_unassigned(cp_params, filled_cp,
                     lambda plan: init_code_predictor(cfg, 1, device=plan))
    _fill_unassigned(codec_params, filled_c, lambda plan: init_codec(
        cfg, 2, device=plan, encoder=True))

    prompt_template = load_prompt_template(path)
    tpl_report: dict = {"source": prompt_template.source, "samples": {}}
    for m, kw in (("custom", {"instruct": "Speak warmly.", "speed": 1.0}),
                  ("design", {"instruct": "A deep calm narrator."}),
                  ("base", {"ref_text": "Reference transcript."})):
        try:
            tpl_report["samples"][m] = prompt_template.render(
                m, "Sample text.", **kw)
        except Exception as e:  # a broken template must not kill the import
            tpl_report["samples"][m] = f"<render failed: {e}>"

    model = Qwen3TTSModel(
        cfg=cfg,
        params=talker,
        cp_params=cp_params,
        codec_params=codec_params,
        tokenizer=load_tokenizer(path, cfg.talker.vocab_size),
        device=torch.device("cpu"),
        template=prompt_template,
        name=os.path.basename(os.path.normpath(path)),
        sampling=sampling_from_generation_config(path),
        st_params=st_params,
        st_cfg=st_cfg,
        st_raw=st_raw,
    )
    model.import_report = ImportReport(
        assigned=assigned, synthetic=tuple(synthetic), unmapped=unmapped,
        speech_tokenizer=st_report, prompt_template=tpl_report,
    )
    return model


# --------------------------------------------------------------------------
# entry point of api.load_model
# --------------------------------------------------------------------------

def load_checkpoint(model_path: str, *, mode: str = "custom",
                    cache: bool = True, device=None, **kwargs):
    """Load ``model_path`` (native or HF/MLX layout) -> Qwen3TTSModel whose
    trees are moved to ``device`` once, at the end (None: kept on the host).
    HF imports are converted once and cached under ``_tpu_native``; the
    seconds of each step go into ``model.load_times``."""
    times: dict[str, float] = {}
    t0 = time.perf_counter()
    native = os.path.join(model_path, NATIVE_DIR)
    if is_native_dir(model_path):
        model = load_native(model_path)
        times["native_load_s"] = time.perf_counter() - t0
    elif cache and is_native_dir(native):
        model = load_native(native)
        times["native_load_s"] = time.perf_counter() - t0
    else:
        model = import_hf_checkpoint(model_path, mode=mode, **kwargs)
        times["import_s"] = time.perf_counter() - t0
        if model.import_report.synthetic:
            # never persist a conversion holding synthetic stand-ins
            warnings.warn(f"not caching native conversion: synthetic "
                          f"components {model.import_report.synthetic}")
        elif cache:
            t1 = time.perf_counter()
            try:
                save_model(model, native)
            except OSError as e:  # read-only model dirs are fine
                warnings.warn(f"could not cache native conversion: {e}")
            times["cache_write_s"] = time.perf_counter() - t1
    if device is not None:
        t1 = time.perf_counter()
        model.to(device)
        times["to_device_s"] = time.perf_counter() - t1
    model.load_times = times
    return model
