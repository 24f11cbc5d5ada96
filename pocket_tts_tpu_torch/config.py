"""Model / runtime configuration (port of ``pocket_tts_tpu/config.py``).

The same frozen dataclasses as the JAX package, framework-free and without
YAML: the one supported variant, ``b6369a24``, is written out as Python
literals equal to ``pocket_tts_tpu/assets/b6369a24.yaml``.
"""

from __future__ import annotations

import dataclasses
import math

# Generation defaults (the reference's default_parameters).
DEFAULT_VARIANT = "b6369a24"
DEFAULT_TEMPERATURE = 0.7
DEFAULT_LSD_DECODE_STEPS = 1
DEFAULT_NOISE_CLAMP: float | None = None
DEFAULT_EOS_THRESHOLD = -4.0
DEFAULT_AUDIO_PROMPT = "alba"


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    dim: int = 512
    depth: int = 6


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    d_model: int = 1024
    num_heads: int = 16
    num_layers: int = 6
    hidden_scale: int = 4
    max_period: float = 10000.0

    @property
    def dim_feedforward(self) -> int:
        return int(self.d_model * self.hidden_scale)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


@dataclasses.dataclass(frozen=True)
class LookupTableConfig:
    dim: int = 1024
    n_bins: int = 4000
    tokenizer: str = "sentencepiece"
    tokenizer_path: str = ""


@dataclasses.dataclass(frozen=True)
class FlowLMConfig:
    dtype: str = "float32"
    flow: FlowConfig = dataclasses.field(default_factory=FlowConfig)
    transformer: TransformerConfig = dataclasses.field(default_factory=TransformerConfig)
    lookup_table: LookupTableConfig = dataclasses.field(default_factory=LookupTableConfig)
    weights_path: str | None = None


@dataclasses.dataclass(frozen=True)
class SEANetConfig:
    dimension: int = 512
    channels: int = 1
    n_filters: int = 64
    n_residual_layers: int = 1
    ratios: tuple[int, ...] = (6, 5, 4)
    kernel_size: int = 7
    residual_kernel_size: int = 3
    last_kernel_size: int = 3
    dilation_base: int = 2
    pad_mode: str = "constant"
    compress: int = 2

    @property
    def hop_length(self) -> int:
        return int(math.prod(self.ratios))


@dataclasses.dataclass(frozen=True)
class MimiTransformerConfig:
    d_model: int = 512
    input_dimension: int = 512
    output_dimensions: tuple[int, ...] = (512,)
    num_heads: int = 8
    num_layers: int = 2
    layer_scale: float = 0.01
    context: int = 250
    max_period: float = 10000.0
    dim_feedforward: int = 2048

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


@dataclasses.dataclass(frozen=True)
class QuantizerConfig:
    dimension: int = 32
    output_dimension: int = 512


@dataclasses.dataclass(frozen=True)
class MimiConfig:
    dtype: str = "float32"
    sample_rate: int = 24000
    channels: int = 1
    frame_rate: float = 12.5
    seanet: SEANetConfig = dataclasses.field(default_factory=SEANetConfig)
    transformer: MimiTransformerConfig = dataclasses.field(
        default_factory=MimiTransformerConfig
    )
    quantizer: QuantizerConfig = dataclasses.field(default_factory=QuantizerConfig)
    weights_path: str | None = None

    @property
    def frame_size(self) -> int:
        # samples of audio per 12.5 Hz latent frame (1920 @ 24 kHz).
        return int(self.sample_rate / self.frame_rate)

    @property
    def encoder_frame_rate(self) -> float:
        return self.sample_rate / self.seanet.hop_length

    @property
    def resample_stride(self) -> int:
        # 200 Hz codec rate -> 12.5 Hz latent rate.
        stride = self.encoder_frame_rate / self.frame_rate
        if stride != int(stride):
            raise ValueError(f"codec rate / frame rate = {stride} is not an integer")
        return int(stride)


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Runtime knobs, field for field those of the JAX package so one Config
    describes both.  The port reads ``compute_dtype``, ``max_seq``,
    ``text_buckets``, ``decode_chunks``, ``pipeline_depth``,
    ``transport_format`` and ``kv_dtype``; the others belong to paths not
    ported yet."""

    # "auto" = bfloat16 backbone on CUDA, float32 on the CPU.  Norms, softmax,
    # the flow net and (in the port) the codec always run in float32.
    compute_dtype: str = "auto"
    # FlowLM KV-cache capacity: voice-prompt frames + text tokens + latent frames.
    max_seq: int = 1024
    # Bucket sizes for text prefill (token counts).
    text_buckets: tuple[int, ...] = (8, 16, 32, 64)
    # Bucket sizes for voice-prompt conditioning prefill (12.5 Hz frames).
    prompt_buckets: tuple[int, ...] = (64, 128, 256, 512)
    # Decode chunk schedule: frames generated per chunk; each chunk ends in one
    # grouped codec decode and one device->host fetch.
    decode_chunks: tuple[int, ...] = (2, 16, 64, 256)
    # How many decode chunks are enqueued ahead of the host reading results.
    pipeline_depth: int = 3
    # Query block for banded batch attention in the Mimi encoder.
    encoder_block: int = 256
    # Audio-sample bucket sizes for the Mimi encoder (voice cloning), seconds.
    encode_seconds_buckets: tuple[float, ...] = (2.5, 5.0, 10.0, 20.0, 30.0)
    # Fused kernels switch of the JAX package ("auto" = on TPU backends only).
    use_pallas: str = "auto"
    # Attention-window buckets for decode: frames attend over the smallest
    # bucket covering max(pos) + K instead of the whole max_seq cache.
    window_buckets: tuple[int, ...] = (256, 512, 768)
    # "auto" = one-dispatch fused segment decode where possible; "chunked"
    # forces the chunk schedule.
    segment_dispatch: str = "auto"
    # Fused-segment capacity buckets (frames).
    segment_buckets: tuple[int, ...] = (128, 256, 448, 704)
    # Chunk size (12.5 Hz frames) of the streaming voice-prompt encoder.
    voice_prompt_chunk_frames: int = 240
    # Device->host audio wire format: "int16" (exact PCM) or "mulaw".
    transport_format: str = "int16"
    # Storage dtype of the FlowLM dense KV cache ("auto" = compute dtype).
    kv_dtype: str = "auto"

    def __post_init__(self):
        if self.segment_dispatch not in ("auto", "chunked"):
            raise ValueError(
                f"runtime.segment_dispatch must be 'auto' or 'chunked', "
                f"got {self.segment_dispatch!r}")
        if self.compute_dtype not in ("auto", "bfloat16", "float32"):
            raise ValueError(
                f"runtime.compute_dtype must be 'auto', 'bfloat16' or "
                f"'float32', got {self.compute_dtype!r}")
        if self.transport_format not in ("int16", "mulaw"):
            raise ValueError(
                f"runtime.transport_format must be 'int16' or 'mulaw', "
                f"got {self.transport_format!r}")
        if self.kv_dtype not in ("auto", "bfloat16", "float32",
                                 "float8_e4m3", "float8_e5m2"):
            raise ValueError(
                f"runtime.kv_dtype must be 'auto', 'bfloat16', 'float32', "
                f"'float8_e4m3' or 'float8_e5m2', got {self.kv_dtype!r}")


@dataclasses.dataclass(frozen=True)
class Config:
    flow_lm: FlowLMConfig = dataclasses.field(default_factory=FlowLMConfig)
    mimi: MimiConfig = dataclasses.field(default_factory=MimiConfig)
    weights_path: str | None = None
    weights_path_without_voice_cloning: str | None = None
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)


def _b6369a24() -> Config:
    return Config(
        weights_path="hf://kyutai/pocket-tts/tts_b6369a24.safetensors"
                     "@427e3d61b276ed69fdd03de0d185fa8a8d97fc5b",
        weights_path_without_voice_cloning=(
            "hf://kyutai/pocket-tts-without-voice-cloning/tts_b6369a24.safetensors"
            "@d4fdd22ae8c8e1cb3634e150ebeff1dab2d16df3"),
        flow_lm=FlowLMConfig(
            dtype="float32",
            flow=FlowConfig(depth=6, dim=512),
            transformer=TransformerConfig(d_model=1024, hidden_scale=4, max_period=10000,
                                          num_heads=16, num_layers=6),
            lookup_table=LookupTableConfig(
                dim=1024, n_bins=4000, tokenizer="sentencepiece",
                tokenizer_path=("hf://kyutai/pocket-tts-without-voice-cloning/"
                                "tokenizer.model@d4fdd22ae8c8e1cb3634e150ebeff1dab2d16df3")),
        ),
        mimi=MimiConfig(
            dtype="float32", sample_rate=24000, channels=1, frame_rate=12.5,
            seanet=SEANetConfig(dimension=512, channels=1, n_filters=64, n_residual_layers=1,
                                ratios=(6, 5, 4), kernel_size=7, residual_kernel_size=3,
                                last_kernel_size=3, dilation_base=2, pad_mode="constant",
                                compress=2),
            transformer=MimiTransformerConfig(d_model=512, num_heads=8, num_layers=2,
                                              layer_scale=0.01, context=250,
                                              dim_feedforward=2048, input_dimension=512,
                                              output_dimensions=(512,)),
            quantizer=QuantizerConfig(dimension=32, output_dimension=512),
        ),
    )


_VARIANTS = {"b6369a24": _b6369a24}

_NESTED = {"flow": FlowConfig, "lookup_table": LookupTableConfig, "seanet": SEANetConfig,
           "quantizer": QuantizerConfig, "flow_lm": FlowLMConfig, "mimi": MimiConfig,
           "runtime": RuntimeConfig}


def config_from_dict(data: dict, cls=Config):
    """Nested dict (e.g. ``dataclasses.asdict`` of a Config, or the variant
    YAML's structure) -> config dataclass; unknown keys are ignored and lists
    become tuples."""
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for name, value in data.items():
        if name not in names:
            continue
        if name == "transformer":
            sub = TransformerConfig if cls is FlowLMConfig else MimiTransformerConfig
            value = config_from_dict(value, sub)
        elif name in _NESTED and isinstance(value, dict):
            value = config_from_dict(value, _NESTED[name])
        elif isinstance(value, list):
            value = tuple(value)
        kwargs[name] = value
    return cls(**kwargs)


def load_variant(variant: str = DEFAULT_VARIANT) -> Config:
    if variant not in _VARIANTS:
        raise FileNotFoundError(
            f"No config for variant {variant!r}; known: {sorted(_VARIANTS)}")
    return _VARIANTS[variant]()
