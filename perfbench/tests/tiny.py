"""A tiny checkout for the CPU tests: the benchmark's files copied into a
temporary root, with a float32 miniature of the published protocol as its
one configuration and a four-client mix as its cell."""

from __future__ import annotations

import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for _p in (os.path.join(REPO, "src"), os.path.join(REPO, "perfbench")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness.manifest import Family, Manifest  # noqa: E402

SEED = 2**31 + 12345

TINY = {
    "name": "tiny",
    "source": "https://huggingface.co/Qwen/Qwen3-TTS-12Hz-1.7B-CustomVoice",
    "model": "tiny",
    "mode": "custom",
    "dtype": "float32",
    "weights": {"format": "int8", "bits": 8, "group_size": 16},
    "max_seq_len": 256,
    "speakers": ["ryan", "aiden", "serena", "vivian", "uncle_fu", "dylan",
                 "eric", "ono_anna", "sohee"],
    "talker": {"vocab_size": 256, "hidden": 64, "n_layers": 2, "n_heads": 4,
               "n_kv_heads": 2, "head_dim": 16, "ffn": 128,
               "rope_theta": 1000000.0, "rms_eps": 1e-06, "codec_vocab": 67,
               "codec_bos": 64, "codec_eos": 65, "codec_pad": 66,
               "codec_nothink": 60, "codec_think_bos": 61,
               "codec_think_eos": 62, "n_speakers": 16, "frames_per_step": 1,
               "feedback": "residual_sum", "tts_pad_id": 250,
               "tts_bos_id": 251, "tts_eos_id": 252, "trailing_bucket": 64},
    "code_predictor": {"hidden": 64, "n_layers": 1, "n_heads": 2,
                       "head_dim": 16, "ffn": 64, "rms_eps": 1e-06,
                       "rope_theta": 10000.0, "qk_norm": False,
                       "input_layout": "hidden_token", "input_proj": False,
                       "top_k": 50, "top_p": 0.8},
    "code2wav": {"codebook_size": 64, "num_quantizers": 4, "hidden": 32,
                 "n_layers": 1, "n_heads": 4, "n_kv_heads": 2, "ffn": 64,
                 "rope_theta": 10000.0, "rms_eps": 1e-05, "sliding_window": 8,
                 "layer_scale_init": 0.01, "upsample_rates": [3, 2],
                 "upsampling_ratios": [2], "decoder_dim": 16,
                 "sample_rate": 24000, "max_positions": 512},
    "assumed": [],
}

MIX = {"slots": 4, "clients": 4, "frames": [6, 20], "first_frames_min": None,
       "chars_per_frame": 1.25, "chars_jitter": 0.2, "max_chars": 600,
       "instruct_share": 0.25, "instructs": ["Normal tone", "Angry and shouting"],
       "rounds": 40, "warmup_timeout_s": 120, "drain_timeout_s": 60,
       "warmup_chunks": [4, 32], "slice_after": "mid_window"}

# the same miniature with dense linears, as the bf16 release stores them
TINY_DENSE = {**TINY, "weights": {"format": "bfloat16"}}

LIMITS = {"talker_gap": 1e-4, "predictor_gap": 1e-4, "talker_gap_mean": 1e-5,
          "predictor_gap_mean": 1e-5, "pcm_err": 1e-3, "frames_short": 0}


def family(name: str) -> Family:
    """The repo's model family ``name``, loaded as a run loads it."""
    return Manifest(REPO).family(name)


def make_root(tmp: str, config: dict = TINY) -> str:
    """A checkout under ``tmp`` whose BENCHMARK.json has one cell, ``tiny``,
    on ``config``."""
    root = os.path.join(tmp, "checkout")
    shutil.copytree(os.path.join(REPO, "perfbench"), os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = os.path.join(root, "perfbench")
    with open(os.path.join(pb, "configs", "tiny.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(pb, "traffic", "tiny4.json"), "w") as f:
        json.dump(MIX, f)
    with open(os.path.join(pb, "workloads", "tiny.json"), "w") as f:
        json.dump({"check": {"requests": 3, "limits": LIMITS}}, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny", "source": TINY["source"],
                         "file": "perfbench/configs/tiny.json", "reduced": [],
                         "why": "a CPU miniature"}]
    bench["workloads"] = [{"name": "tiny", "config": "tiny", "traffic": "tiny4",
                           "chips": 1, "why": "the CPU tests' cell"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
