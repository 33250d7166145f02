"""Model architecture configuration dataclasses (copied from the JAX
package's engine/configs.py; the port imports nothing of that package).

The flagship preset encodes the Qwen3-TTS-12Hz-1.7B family (1.7B-param
Qwen3 backbone, 12 Hz multi-codebook neural codec, 24 kHz output); ``tiny``
is a CPU-testable miniature with the same structure. ``*_code2wav`` run
the published code2wav codec decoder (``Code2WavConfig``) in place of the
synthetic rvq codec, and ``*_feedback`` the published residual-sum decode
protocol; ``flagship_feedback_code2wav`` is both, the shape of a real
imported checkpoint.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class TalkerConfig:
    """The autoregressive "talker" transformer (Qwen3-style backbone).

    It consumes a text/conditioning prompt and emits one semantic codec token
    (codebook 0) per 12 Hz frame.
    """

    vocab_size: int = 151_936          # text vocabulary (Qwen3 tokenizer)
    hidden: int = 2048
    n_layers: int = 28
    n_heads: int = 16
    n_kv_heads: int = 8
    head_dim: int = 128
    ffn: int = 6144
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    # codec-side vocabulary: codebook-0 tokens + control tokens (BOS/EOS/PAD)
    codec_vocab: int = 2051            # 2048 codes + bos/eos/pad
    codec_bos: int = 2048
    codec_eos: int = 2049
    codec_pad: int = 2050
    # optional codec prompt-head control ids (the published talker family
    # leads the codec stream with [nothink, think_bos, think_eos] before
    # BOS — Qwen3OmniMoeTalker._get_talker_assistant_parts; see PARITY.md).
    # None = absent: checkpoints that carry these ids in talker_config get
    # the prompt head, synthetic configs stay unchanged.
    codec_nothink: int | None = None
    codec_think_bos: int | None = None
    codec_think_eos: int | None = None
    # checkpoint-defined speaker-name -> codec-token-id map (the published
    # configs carry talker_config.speaker_id; the speaker then conditions
    # as a codec control token in the prompt head instead of the learned
    # spk_emb row). Tuple of (name, id) pairs so the config stays hashable.
    speaker_tokens: tuple[tuple[str, int], ...] | None = None
    n_speakers: int = 16               # built-in speaker embedding table
    tie_embeddings: bool = True
    # multi-token prediction: codec frames emitted per talker weight pass.
    # The decode hot path is HBM-bound streaming the talker weights, so
    # n>1 divides bytes/frame by n: frame 0 of each step comes from the
    # main head, frames 1..n-1 from a small MTP block over the same hidden
    # state (models/talker.py mtp_logits); the talker then consumes a
    # learned merge of the n frame embeddings and advances ONE position
    # (sequence length and KV traffic also shrink by n). n>1 is an
    # architectural extension: real 1-frame checkpoints need an MTP
    # fine-tune (training/loss.py trains it) before enabling it.
    frames_per_step: int = 1
    # decode feedback protocol (PARITY.md item 3):
    #   "cb0"          — the talker autoregresses on codebook-0 embeddings
    #                    alone (residuals predicted per chunk, batched —
    #                    the TPU-fast default for synthetic/MTP models);
    #   "residual_sum" — the published Qwen3OmniMoeTalker generate loop
    #                    (transformers prepare_inputs_for_generation): the
    #                    next talker input is the SUM of ALL Q codebook
    #                    embeddings for the previous frame (cb0 via the
    #                    talker codec_emb, residual d via the code
    #                    predictor's depth-d input table) PLUS a per-step
    #                    trailing-text hidden — the talker re-reads the
    #                    text one token per frame, then a tts_pad
    #                    embedding once the text runs out. Requires the
    #                    three tts_* ids below. Composes with
    #                    frames_per_step > 1 (the MTP fine-tune path for
    #                    real 1-frame checkpoints: each weight pass emits
    #                    n frames, each with its own residual feedback and
    #                    trailing-text row — runtime/generate.py
    #                    make_decode_chunk_fn_feedback).
    feedback: str = "cb0"
    # MTP-chain conditioning under feedback="residual_sum" with
    # frames_per_step > 1:
    #   False — faithful chain: frame j+1's MTP hidden is conditioned on
    #           frame j's FULL feedback embedding (cb0 + residual sum),
    #           which forces the code predictor to run per frame inside
    #           the step (fps sequential cp weight streams per step —
    #           the binding bytes of the fps>1 shapes, TPU v5e log in
    #           PERF.md at commit dae56a7);
    #   True  — batched-cp fine-tune shape: the chain conditions on frame
    #           j's cb0 embedding alone, so all fps frames' residuals are
    #           predicted in ONE batched cp pass per step — cp weight
    #           bytes per frame divide by fps. A different fine-tune
    #           target, same recovery CLI (training/loss.py mirrors the
    #           conditioning exactly; finetune.py --mtp-cp-batch), to be
    #           quality-gated like fps/depth_group. No effect at fps == 1
    #           or under feedback="cb0" (already chunk-batched there).
    mtp_cp_batch: bool = False
    # TEXT-vocab control ids for the trailing-text protocol (the published
    # top-level config's tts_{pad,bos,eos}_token_id). Embedded through
    # text_emb (and text_proj when the checkpoint ships one).
    tts_pad_id: int | None = None
    tts_bos_id: int | None = None
    tts_eos_id: int | None = None
    # per-slot trailing-text buffer capacity in frames (serving keeps the
    # buffer device-resident; text beyond it conditions as tts_pad)
    trailing_bucket: int = 512

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def __post_init__(self) -> None:
        ids = (self.codec_nothink, self.codec_think_bos, self.codec_think_eos)
        defined = [i for i in ids if i is not None]
        if defined and len(defined) != 3:
            raise ValueError(
                "codec prompt head must define all three ids "
                "(nothink/think_bos/think_eos) or none; got "
                f"{ids} — a partial head matches no published layout"
            )
        bad = [i for i in defined if not 0 <= i < self.codec_vocab]
        if bad:
            raise ValueError(
                f"codec prompt-head ids {bad} out of range for "
                f"codec_vocab={self.codec_vocab} (a clamped gather would "
                "silently condition on the wrong embedding row)"
            )
        if self.speaker_tokens:
            bad = [(n, i) for n, i in self.speaker_tokens
                   if not 0 <= i < self.codec_vocab]
            if bad:
                raise ValueError(
                    f"speaker codec-token ids out of range for "
                    f"codec_vocab={self.codec_vocab}: {bad}"
                )
        if self.feedback not in ("cb0", "residual_sum"):
            raise ValueError(f"unknown feedback protocol: {self.feedback!r}")
        if self.feedback == "residual_sum":
            tts = (self.tts_pad_id, self.tts_bos_id, self.tts_eos_id)
            if any(i is None for i in tts):
                raise ValueError(
                    "feedback='residual_sum' needs tts_pad_id/tts_bos_id/"
                    f"tts_eos_id (trailing-text protocol); got {tts}"
                )
            bad = [i for i in tts if not 0 <= i < self.vocab_size]
            if bad:
                raise ValueError(
                    f"tts control ids {bad} out of range for "
                    f"vocab_size={self.vocab_size}"
                )

    @property
    def codec_prompt_head(self) -> tuple[int, ...]:
        """Codec-stream control tokens preceding BOS, () when the
        checkpoint config doesn't define them (see PARITY.md)."""
        ids = (self.codec_nothink, self.codec_think_bos, self.codec_think_eos)
        return tuple(i for i in ids if i is not None)


@dataclass(frozen=True)
class CodePredictorConfig:
    """Small depth transformer predicting residual codebooks 1..Q-1 per frame
    from the talker's last hidden state + codebook-0 embedding (MTP-style)."""

    hidden: int = 1024
    n_layers: int = 4
    n_heads: int = 8
    head_dim: int = 128
    ffn: int = 3072
    rms_eps: float = 1e-6
    rope_theta: float = 10_000.0
    # per-head q/k RMSNorm in the depth transformer. The published code
    # predictor family (transformers Qwen3OmniMoeTalkerCodePredictor) has
    # NO qk-norm; imports auto-set this from whether the checkpoint carries
    # q_norm tensors (a norm applied where the weights expect none — or
    # vice versa — mis-scales every attention read)
    qk_norm: bool = True
    # depth-sequence seeding (PARITY.md):
    #   "sum"          — position 0 = in_proj(talker hidden) + cb0 embedding
    #   "hidden_token" — the published layout: TWO positions,
    #                    [talker hidden, cb0 embedding]; head d scores
    #                    position d+1. Imports auto-detect: a checkpoint
    #                    with code-predictor tensors but no input
    #                    projection uses hidden_token (the hidden feeds in
    #                    raw, so cp hidden must equal talker hidden).
    input_layout: str = "sum"
    input_proj: bool = True            # apply in_proj to the talker hidden
    # residual-code sampling during decode. The published generate loop
    # SAMPLES the depth transformer (cp.generate(do_sample=True, top_k=50,
    # top_p=0.8) in transformers Qwen3OmniMoeTalker
    # prepare_inputs_for_generation); top_k=0 + top_p=1.0 = greedy (the
    # default, and always used when the talker itself samples greedily so
    # the serving==single-stream greedy-parity invariant holds).
    top_k: int = 0
    top_p: float = 1.0
    temperature: float = 1.0
    # Grouped depth prediction: each depth pass scores ``depth_group``
    # consecutive residual codebooks from the same hidden (their heads all
    # read position p), and the next pass's input is the SUM of the
    # group's code embeddings — cutting the depth transformer's sequential
    # weight passes (and so its HBM weight streaming, the cp cost that
    # dominates the published feedback protocol on a TPU v5e, PERF.md at
    # commit dae56a7) by the group
    # factor. Like talker MTP this is an architectural extension of the
    # published 1-per-pass layout — but it adds NO new parameters (the
    # same per-depth heads and embedding tables are re-indexed), so
    # enabling it on an imported checkpoint is config + fine-tune only.
    # (num_codebooks - 1) must divide evenly into groups.
    depth_group: int = 1
    # Speculative depth decode (lossless use of the grouped heads): the
    # grouped pass becomes a DRAFT, verified by teacher-forced full-depth
    # passes. Greedy configs correct the first mismatching depth until
    # the whole frame matches — bit-exact depth_group=1 greedy output
    # (models/code_predictor.py predict_residuals_spec). Sampled configs
    # (the published cp.generate args) run exact speculative SAMPLING —
    # accept with prob min(1, p/q), resample the first rejection from the
    # normalized residual (p-q)+ — identical IN DISTRIBUTION to the
    # sequential dg=1 sampled stream (predict_residuals_spec_sampled).
    # Either way the cost is grouped-draft + verify rounds when the draft
    # agrees. Requires depth_group > 1 (the draft source).
    spec_decode: bool = False


@dataclass(frozen=True)
class CodecConfig:
    """The 12 Hz residual-VQ neural codec (decoder = vocoder to 24 kHz,
    encoder used for voice-cloning acoustic prompts)."""

    sample_rate: int = 24_000
    frame_rate: float = 12.0
    num_codebooks: int = 16            # codebook 0 = semantic + 15 residual
    codebook_size: int = 2048          # entries per codebook (codebook 0)
    residual_codebook_size: int = 1024  # entries per residual codebook
    latent_dim: int = 512
    # decoder upsampling: prod(rates) == sample_rate / frame_rate == 2000
    upsample_rates: tuple[int, ...] = (5, 5, 5, 4, 4)
    decoder_channels: tuple[int, ...] = (512, 512, 256, 128, 96, 64)
    decoder_kernel: int = 7
    n_transformer_layers: int = 6      # pre-upsample latent transformer
    transformer_heads: int = 8

    @property
    def hop(self) -> int:
        hop = self.sample_rate / self.frame_rate
        assert hop == int(hop), "sample_rate must be a multiple of frame_rate"
        return int(hop)

    def __post_init__(self) -> None:
        assert len(self.decoder_channels) == len(self.upsample_rates) + 1
        assert math.prod(self.upsample_rates) == self.hop, (
            f"upsample rates {self.upsample_rates} must multiply to {self.hop}"
        )


@dataclass(frozen=True)
class Code2WavConfig:
    """Geometry of the code2wav decoder (the JAX package's
    ``models/code2wav.py::Code2WavConfig``, which mirrors the HF
    ``Qwen3OmniMoeCode2WavConfig`` field for field; defaults are the
    published Omni values, real values come from the checkpoint)."""

    codebook_size: int = 2048
    num_quantizers: int = 16
    hidden: int = 1024
    n_layers: int = 8
    n_heads: int = 16
    n_kv_heads: int = 16
    ffn: int = 3072
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    sliding_window: int = 72
    layer_scale_init: float = 0.01
    upsample_rates: tuple[int, ...] = (8, 5, 4, 3)
    upsampling_ratios: tuple[int, ...] = (2, 2)
    decoder_dim: int = 1536
    sample_rate: int = 24_000
    max_positions: int = 8000          # pre-transformer RoPE table length

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads

    @property
    def total_upsample(self) -> int:
        return math.prod(self.upsample_rates) * math.prod(self.upsampling_ratios)

    @property
    def frame_rate(self) -> float:
        return self.sample_rate / self.total_upsample

    @property
    def startup_samples(self) -> int:
        """Length of the stream's edge run-in: each decoder block's
        transposed conv contributes its (kernel - stride) = rate head
        samples, scaled by the rates below it. The one-shot decode trims
        exactly these; the stream drops them once per utterance."""
        return sum(r * math.prod(self.upsample_rates[i + 1:])
                   for i, r in enumerate(self.upsample_rates))

    @classmethod
    def from_hf_dict(cls, d: dict) -> "Code2WavConfig":
        """Build from a checkpoint's ``code2wav_config`` JSON section."""
        return cls(
            codebook_size=d.get("codebook_size", 2048),
            num_quantizers=d.get("num_quantizers", 16),
            hidden=d.get("hidden_size", 1024),
            n_layers=d.get("num_hidden_layers", 8),
            n_heads=d.get("num_attention_heads", 16),
            n_kv_heads=d.get("num_key_value_heads",
                             d.get("num_attention_heads", 16)),
            ffn=d.get("intermediate_size", 3072),
            rope_theta=d.get("rope_theta", 10_000.0),
            rms_eps=d.get("rms_norm_eps", 1e-5),
            sliding_window=d.get("sliding_window", 72),
            layer_scale_init=d.get("layer_scale_initial_scale", 0.01),
            upsample_rates=tuple(d.get("upsample_rates", (8, 5, 4, 3))),
            upsampling_ratios=tuple(d.get("upsampling_ratios", (2, 2))),
            decoder_dim=d.get("decoder_dim", 1536),
            sample_rate=d.get("sample_rate", 24_000),
            max_positions=d.get("max_position_embeddings", 8000),
        )


@dataclass(frozen=True)
class QuantConfig:
    """Weight-only affine quantization (MLX-compatible layout: per-group
    scale+bias along the input dimension, uint8 codes)."""

    bits: int = 8
    group_size: int = 64
    enabled: bool = True


@dataclass(frozen=True)
class ModelConfig:
    """Everything needed to build one Qwen3-TTS model variant."""

    mode: str = "custom"               # custom | design | base (cloning)
    talker: TalkerConfig = field(default_factory=TalkerConfig)
    code_predictor: CodePredictorConfig = field(default_factory=CodePredictorConfig)
    codec: CodecConfig = field(default_factory=CodecConfig)
    quant: QuantConfig = field(default_factory=QuantConfig)
    # which codec decoder architecture `codec_params` carries:
    #   "rvq"      — the synthetic RVQ codec (models/codec.py)
    #   "code2wav" — the published family (models/code2wav.py); `code2wav`
    #                holds its geometry, and `codec` is derived to match
    #                (frame rate, codebook counts) so the talker and
    #                code-predictor plumbing is arch-agnostic
    codec_arch: str = "rvq"
    code2wav: Code2WavConfig | None = None
    dtype: str = "bfloat16"
    max_seq_len: int = 3072            # prompt + generated frames budget
    # whether the checkpoint natively honors the speed control tag; when
    # False the engine applies host-side WSOLA time-stretching so the
    # generate_audio(speed=...) contract holds for any weights
    native_speed: bool = False
    speakers: tuple[str, ...] = (
        "ryan", "aiden", "serena", "vivian", "uncle_fu",
        "dylan", "eric", "ono_anna", "sohee",
    )

    def __post_init__(self) -> None:
        if self.talker.feedback == "residual_sum":
            if self.code_predictor.hidden != self.talker.hidden:
                raise ValueError(
                    "feedback='residual_sum' feeds the code predictor's "
                    "depth-table embeddings back into the talker, so their "
                    f"widths must match: cp.hidden={self.code_predictor.hidden}"
                    f" vs talker.hidden={self.talker.hidden}"
                )
        k = self.code_predictor.depth_group
        n_res = self.codec.num_codebooks - 1
        if k < 1 or n_res % k != 0:
            raise ValueError(
                f"depth_group={k} must divide the residual codebook count "
                f"({n_res}) evenly"
            )

    @property
    def frames_per_second(self) -> float:
        return self.codec.frame_rate


def flagship(mode: str = "custom", *, frames_per_step: int = 1) -> ModelConfig:
    """The 1.7B production configuration (one per reference model registry
    entry, reference config.py:14-42). ``frames_per_step=2`` enables the
    MTP decode head (see TalkerConfig.frames_per_step)."""
    cfg = ModelConfig(mode=mode)
    if frames_per_step != 1:
        cfg = replace(
            cfg, talker=replace(cfg.talker, frames_per_step=frames_per_step)
        )
    return cfg


def with_frames_per_step(cfg: ModelConfig, n: int) -> ModelConfig:
    return replace(cfg, talker=replace(cfg.talker, frames_per_step=n))


def with_code2wav(cfg: ModelConfig, c2w: Code2WavConfig) -> ModelConfig:
    """Switch ``cfg`` to the code2wav decoder (models/code2wav.py).

    The ``codec`` section is re-derived so every arch-agnostic consumer
    (talker codebook sizes, code-predictor depth, frame-rate and hop
    arithmetic) sees consistent numbers: code2wav quantizers are uniform,
    so codebook and residual sizes coincide."""
    n_stages = len(c2w.upsample_rates) + len(c2w.upsampling_ratios)
    channels = cfg.codec.decoder_channels
    codec = replace(
        cfg.codec,
        sample_rate=c2w.sample_rate,
        frame_rate=c2w.sample_rate / c2w.total_upsample,
        num_codebooks=c2w.num_quantizers,
        codebook_size=c2w.codebook_size,
        residual_codebook_size=c2w.codebook_size,
        latent_dim=c2w.hidden,
        # the fields below only shape the synthetic rvq tree (and the
        # cloning feature encoder); kept consistent with the hop
        upsample_rates=tuple(c2w.upsample_rates) + tuple(c2w.upsampling_ratios),
        decoder_channels=(tuple(channels[:n_stages + 1])
                          if len(channels) >= n_stages + 1
                          else (channels[0],) * (n_stages + 1)),
    )
    return replace(cfg, codec_arch="code2wav", code2wav=c2w, codec=codec)


def flagship_code2wav(mode: str = "custom") -> ModelConfig:
    """The flagship talker driving the code2wav decoder at the published
    geometry, at the 12 Hz frame rate of the TTS checkpoints (upsample
    10*5*5*4*2 = 2000 samples a frame at 24 kHz)."""
    base = flagship(mode)
    return with_code2wav(base, Code2WavConfig(
        codebook_size=base.codec.codebook_size,
        num_quantizers=base.codec.num_codebooks,
        upsample_rates=(10, 5, 5, 4),
        upsampling_ratios=(2,),
        sample_rate=base.codec.sample_rate,
    ))


def tiny_code2wav(mode: str = "custom") -> ModelConfig:
    """The tiny config running the code2wav decoder (hop 3*2*2 = 12
    samples a frame)."""
    base = tiny(mode, quant=False)
    return with_code2wav(base, Code2WavConfig(
        codebook_size=base.codec.codebook_size,
        num_quantizers=base.codec.num_codebooks,
        hidden=32,
        n_layers=1,
        n_heads=4,
        n_kv_heads=2,
        ffn=64,
        sliding_window=8,
        upsample_rates=(3, 2),
        upsampling_ratios=(2,),
        decoder_dim=16,
        sample_rate=base.codec.sample_rate,
        max_positions=512,
    ))


def _published_protocol(base: ModelConfig, talker_ids: dict, *,
                        frames_per_step: int = 1, depth_group: int = 1,
                        spec_decode: bool = False, mtp_cp_batch: bool = False,
                        **cp_changes) -> ModelConfig:
    """``base`` under the published decode protocol: residual-sum feedback
    with trailing text, and the two-position (hidden_token) code predictor
    at talker width with no input projection and no qk-norm; with the
    decode extensions asked for (MTP frames per step, the batched-cp MTP
    chain, grouped and speculative depth decode)."""
    return replace(
        base,
        talker=replace(base.talker, feedback="residual_sum",
                       frames_per_step=frames_per_step,
                       mtp_cp_batch=mtp_cp_batch, **talker_ids),
        code_predictor=replace(
            base.code_predictor, hidden=base.talker.hidden,
            input_layout="hidden_token", input_proj=False, qk_norm=False,
            depth_group=depth_group, spec_decode=spec_decode, **cp_changes),
    )


def flagship_feedback(mode: str = "custom", **ext) -> ModelConfig:
    """The flagship under the published decode protocol: the cost model of
    a real imported checkpoint (the code predictor runs per frame inside
    the talker loop, at talker width, sampling with the published top_k=50,
    top_p=0.8). Synthetic ids stand in for the checkpoint's tts and think
    markers. ``ext``: ``frames_per_step``, ``depth_group``,
    ``spec_decode``, ``mtp_cp_batch`` (``_published_protocol``), the
    protocol after the MTP / depth-group fine-tune."""
    return _published_protocol(
        flagship(mode),
        dict(tts_pad_id=151_000, tts_bos_id=151_001, tts_eos_id=151_002,
             codec_nothink=2_045, codec_think_bos=2_046,
             codec_think_eos=2_047),
        top_k=50, top_p=0.8, **ext)


def flagship_feedback_code2wav(mode: str = "custom", **ext) -> ModelConfig:
    """The real-checkpoint cost model: the published decode protocol
    (flagship_feedback, with its ``ext``) driving the code2wav decoder at
    12 Hz geometry (flagship_code2wav)."""
    base = flagship_feedback(mode, **ext)
    return with_code2wav(base, Code2WavConfig(
        codebook_size=base.codec.codebook_size,
        num_quantizers=base.codec.num_codebooks,
        upsample_rates=(10, 5, 5, 4),
        upsampling_ratios=(2,),
        sample_rate=base.codec.sample_rate,
    ))


def tiny_feedback(mode: str = "custom", **ext) -> ModelConfig:
    """The tiny config under the published decode protocol (residual-sum
    feedback, trailing text, the hidden_token code-predictor layout);
    ``ext`` as flagship_feedback's."""
    return _published_protocol(
        tiny(mode),
        dict(tts_pad_id=250, tts_bos_id=251, tts_eos_id=252,
             codec_nothink=60, codec_think_bos=61, codec_think_eos=62,
             trailing_bucket=64), **ext)


def torch_dtype(cfg: ModelConfig):
    """The torch dtype of a config's weights and activations."""
    import torch

    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def tiny(mode: str = "custom", *, quant: bool = False) -> ModelConfig:
    """A CPU-testable miniature with the same structure as the flagship.

    Small enough for fast jit on one CPU core, but exercises every code path:
    GQA (heads != kv_heads), multi-codebook RVQ, upsampling vocoder, quant.
    """
    return ModelConfig(
        mode=mode,
        talker=TalkerConfig(
            vocab_size=256,
            hidden=64,
            n_layers=2,
            n_heads=4,
            n_kv_heads=2,
            head_dim=16,
            ffn=128,
            codec_vocab=67,
            codec_bos=64,
            codec_eos=65,
            codec_pad=66,
            n_speakers=4,
        ),
        code_predictor=CodePredictorConfig(
            hidden=32, n_layers=1, n_heads=2, head_dim=16, ffn=64
        ),
        codec=CodecConfig(
            sample_rate=24_000,
            frame_rate=12.0,
            num_codebooks=4,
            codebook_size=64,
            residual_codebook_size=32,
            latent_dim=32,
            upsample_rates=(5, 5, 5, 4, 4),
            decoder_channels=(32, 24, 16, 12, 8, 8),
            decoder_kernel=3,
            n_transformer_layers=1,
            transformer_heads=2,
        ),
        quant=QuantConfig(bits=8, group_size=16, enabled=quant),
        max_seq_len=256,
    )


def with_quant(cfg: ModelConfig, enabled: bool) -> ModelConfig:
    return replace(cfg, quant=replace(cfg.quant, enabled=enabled))
