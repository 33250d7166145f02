"""The program under test, built from a configuration file and the raw
weights: the port's ``ModelConfig`` and a ``Qwen3TTSModel`` over the same
tensors the reference reads, decoding greedily."""

from __future__ import annotations


def port_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from qwen3_tts_tpu_torch.engine import configs

    c2w = dict(cfg["code2wav"])
    c2w["upsample_rates"] = tuple(c2w["upsample_rates"])
    c2w["upsampling_ratios"] = tuple(c2w["upsampling_ratios"])
    wf = cfg["weights"]
    base = configs.ModelConfig(
        mode=cfg["mode"],
        talker=configs.TalkerConfig(**cfg["talker"]),
        code_predictor=configs.CodePredictorConfig(**cfg["code_predictor"]),
        quant=configs.QuantConfig(bits=wf.get("bits", 8),
                                  group_size=wf.get("group_size", 64),
                                  enabled=wf["format"] == "int8"),
        dtype=cfg["dtype"],
        max_seq_len=cfg["max_seq_len"],
        speakers=tuple(cfg["speakers"]),
    )
    return configs.with_code2wav(base, configs.Code2WavConfig(**c2w))


def build_model(cfg: dict, model_cfg, raw: dict, device):
    """A ``Qwen3TTSModel`` over ``raw``'s tensors, sampling greedily: the
    engine then serves the argmax codes that the reference judges."""
    from qwen3_tts_tpu_torch.engine.api import Qwen3TTSModel
    from qwen3_tts_tpu_torch.engine.tokenizer import load_tokenizer
    from qwen3_tts_tpu_torch.runtime.sampling import SamplingConfig

    return Qwen3TTSModel(
        cfg=model_cfg, params=raw["talker"], cp_params=raw["predictor"],
        codec_params={"c2w": raw["code2wav"]},
        tokenizer=load_tokenizer(None, model_cfg.talker.vocab_size),
        device=device, name=cfg["name"],
        sampling=SamplingConfig(greedy=True))
