"""Model / runtime configuration (port of ``pocket_tts_tpu/config.py``).

The same frozen dataclasses as the JAX package, framework-free.  The flagship
variant, ``b6369a24``, is written out as Python literals equal to
``pocket_tts_tpu/assets/b6369a24.yaml``.  Any other variant is a YAML file
found as the JAX package finds it (its assets folder, then ``./``, then
``./config/``) and read by ``parse_yaml``, a reader of the YAML subset the
variant files use (no ``pyyaml`` needed).
"""

from __future__ import annotations

import dataclasses
import math
import re
from pathlib import Path

# Generation defaults (the reference's default_parameters).
DEFAULT_VARIANT = "b6369a24"
DEFAULT_TEMPERATURE = 0.7
DEFAULT_LSD_DECODE_STEPS = 1
DEFAULT_NOISE_CLAMP: float | None = None
DEFAULT_EOS_THRESHOLD = -4.0
DEFAULT_AUDIO_PROMPT = "alba"

# the JAX package's variant YAMLs (data, read by file path)
_CONFIG_DIR = Path(__file__).resolve().parent.parent / "pocket_tts_tpu" / "assets"


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


LFM2_LAYER_KINDS = ("conv", "full_attention")


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """A hybrid FlowLM backbone in place of Pocket's transformer; the one
    kind is ``lfm2_moe`` (LiquidAI's LFM2-MoE, ``models/lfm2.py``), its
    fields named as in that model's ``config.json`` and its defaults those
    of LFM2-8B-A1B.  ``layer_types`` gives each layer's mixer: a gated short
    convolution of ``conv_L_cache`` taps (``conv``) or GQA attention with
    RMSNorm on q and k and RoPE of base ``rope_theta`` (``full_attention``);
    the first ``num_dense_layers`` layers have a SwiGLU FFN of
    ``intermediate_size``, the others ``num_experts`` SwiGLU experts of
    ``moe_intermediate_size``, ``num_experts_per_tok`` a token, chosen on
    sigmoid scores plus ``expert_bias``."""

    kind: str = "lfm2_moe"
    hidden_size: int = 2048
    num_hidden_layers: int = 24
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    layer_types: tuple[str, ...] = tuple(
        "full_attention" if i in (2, 6, 10, 14, 18, 21) else "conv" for i in range(24))
    conv_L_cache: int = 3
    conv_bias: bool = False
    intermediate_size: int = 7168
    moe_intermediate_size: int = 1792
    num_experts: int = 32
    num_experts_per_tok: int = 4
    num_dense_layers: int = 2
    norm_eps: float = 1e-5
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    use_expert_bias: bool = True
    rope_theta: float = 1000000.0

    def __post_init__(self):
        if self.kind != "lfm2_moe":
            raise ValueError(f"flow_lm.backbone.kind must be 'lfm2_moe', got {self.kind!r}")
        if len(self.layer_types) != self.num_hidden_layers or not set(
                self.layer_types) <= set(LFM2_LAYER_KINDS):
            raise ValueError(f"flow_lm.backbone.layer_types: {self.num_hidden_layers} entries "
                             f"of {LFM2_LAYER_KINDS}, got {self.layer_types!r}")
        if self.conv_bias:
            raise ValueError("flow_lm.backbone: conv_bias is not supported (LFM2's is False)")
        if self.num_attention_heads % self.num_key_value_heads or \
                self.hidden_size % self.num_attention_heads:
            raise ValueError("flow_lm.backbone: heads must divide hidden_size and kv heads the "
                             "query heads")
        if not 0 < self.num_dense_layers < self.num_hidden_layers or len(
                set(self.layer_types)) < 2 or not 1 <= self.num_experts_per_tok <= self.num_experts:
            raise ValueError("flow_lm.backbone: the port takes at least one layer of each kind "
                             "(conv and attention mixers, dense and MoE FFNs) and 1 <= "
                             "num_experts_per_tok <= num_experts")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def attn_layers(self) -> tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types) if t == "full_attention")

    @property
    def conv_layers(self) -> tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types) if t == "conv")

    @property
    def moe_layers(self) -> int:
        return self.num_hidden_layers - self.num_dense_layers


@dataclasses.dataclass(frozen=True)
class FlowLMConfig:
    dtype: str = "float32"
    flow: FlowConfig = dataclasses.field(default_factory=FlowConfig)
    transformer: TransformerConfig = dataclasses.field(default_factory=TransformerConfig)
    lookup_table: LookupTableConfig = dataclasses.field(default_factory=LookupTableConfig)
    weights_path: str | None = None
    backbone = None  # Pocket's transformer; see HybridFlowLMConfig (not a field here)

    @property
    def d_model(self) -> int:
        return self.backbone.hidden_size if self.backbone else self.transformer.d_model


@dataclasses.dataclass(frozen=True)
class HybridFlowLMConfig(FlowLMConfig):
    """A FlowLM whose backbone is ``backbone`` in place of ``transformer``
    (which it leaves unread).  A subclass, so that the flagship's
    ``FlowLMConfig`` keeps the JAX package's fields, one for one."""

    backbone: BackboneConfig | None = None


def refuse_hybrid(cfg, what: str) -> None:
    """ValueError naming the backbone kind when ``cfg`` has a hybrid backbone,
    which ``what`` does not support."""
    if cfg.flow_lm.backbone is not None:
        raise ValueError(f"{what} does not support the {cfg.flow_lm.backbone.kind} FlowLM "
                         "backbone (Pocket's transformer only)")


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
           "runtime": RuntimeConfig, "backbone": BackboneConfig}


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
            sub = TransformerConfig if issubclass(cls, FlowLMConfig) else MimiTransformerConfig
            value = config_from_dict(value, sub)
        elif name == "flow_lm" and isinstance(value, dict) and value.get("backbone"):
            value = config_from_dict(value, HybridFlowLMConfig)
        elif name in _NESTED and isinstance(value, dict):
            value = config_from_dict(value, _NESTED[name])
        elif isinstance(value, list):
            value = tuple(value)
        kwargs[name] = value
    return cls(**kwargs)


def load_config(path: str | Path) -> Config:
    """A variant YAML file -> Config."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Config file not found: {path}")
    data = parse_yaml(path.read_text(encoding="utf-8"), str(path))
    if not isinstance(data, dict):
        raise ValueError(f"{path}: a variant file is a mapping, got {type(data).__name__}")
    return config_from_dict(data)


def find_config_path(variant: str) -> Path:
    """``<variant>.yaml`` from the JAX package's assets, then the working
    directory, then its ``config/`` folder (the JAX package's order)."""
    candidates = [_CONFIG_DIR / f"{variant}.yaml", Path.cwd() / f"{variant}.yaml",
                  Path.cwd() / "config" / f"{variant}.yaml"]
    for c in candidates:
        if c.exists():
            return c
    raise FileNotFoundError(
        f"No config found for variant {variant!r}; searched {[str(c) for c in candidates]}")


def load_variant(variant: str = DEFAULT_VARIANT) -> Config:
    """The flagship from its literals; any other variant from its YAML."""
    if variant in _VARIANTS:
        return _VARIANTS[variant]()
    return load_config(find_config_path(variant))


# ---------------------------------------------------------------------------
# the YAML subset of the variant files
# ---------------------------------------------------------------------------

# yaml.safe_load's implicit scalar types (YAML 1.1, PyYAML's resolver)
_BOOLS = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
          **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"),
                          False)}
_NULLS = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|0|[1-9][0-9_]*|0x[0-9a-fA-F_]+)")
_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
# what PyYAML resolves to other types (sexagesimal numbers, dates) or treats
# specially (merge keys): refused, not guessed
_OTHER = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Refused(ValueError):
    pass


def _resolve(s: str):
    """A plain scalar -> None, bool, int, float or str, as yaml.safe_load."""
    if s in _NULLS:
        return None
    if s in _BOOLS:
        return _BOOLS[s]
    if _INT.fullmatch(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith(("0b", "0x")):
            return sign * int(v[2:], 2 if v[1] == "b" else 16)
        return sign * int(v, 8 if len(v) > 1 and v[0] == "0" else 10)
    if _FLOAT.fullmatch(s):
        v = s.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".nan":
            return math.nan
        return sign * (math.inf if v == ".inf" else float(v))
    if _OTHER.fullmatch(s):
        raise _Refused(f"plain scalar {s!r} (a YAML number, date or merge key of another kind)")
    return s


def _quoted(s: str, at: int) -> tuple[str, int]:
    """The quoted scalar starting at ``s[at]`` -> (value, index past it)."""
    quote, out, i = s[at], [], at + 1
    while i < len(s):
        c = s[i]
        if c == quote:
            if quote == "'" and s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if c == "\\" and quote == '"':
            code = s[i + 1:i + 2]
            if code in _ESCAPES:
                out.append(_ESCAPES[code])
                i += 2
                continue
            width = _HEX_ESCAPES.get(code)
            digits = s[i + 2:i + 2 + width] if width else ""
            if not width or len(digits) != width or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                raise _Refused(f"escape {s[i:i + 2]!r}")
            out.append(chr(int(digits, 16)))
            i += 2 + width
            continue
        out.append(c)
        i += 1
    raise _Refused("a quoted scalar that does not end on its line")


def _rest_is_comment(s: str) -> None:
    if s.strip() and not re.match(r"\s+#", s):
        raise _Refused(f"text after a value: {s.strip()!r}")


def _value(s: str):
    """The value text after ``key:`` -> a scalar or a list (flow sequence)."""
    if s[0] in "'\"":
        value, end = _quoted(s, 0)
        _rest_is_comment(s[end:])
        return value
    if s[0] == "[":
        items, i = [], 1
        while True:
            while i < len(s) and s[i] == " ":
                i += 1
            if i < len(s) and s[i] == "]":
                _rest_is_comment(s[i + 1:])
                return items
            if i < len(s) and s[i] in "'\"":
                item, i = _quoted(s, i)
            else:
                m = re.match(r"[^,\[\]{}#'\"]*", s[i:])
                text = m.group().strip()
                if not text or text[0] in "&*!|>%@`-?:" or ": " in text:
                    raise _Refused(f"flow sequence item {s[i:].strip()!r}")
                item, i = _resolve(text), i + m.end()
            items.append(item)
            while i < len(s) and s[i] == " ":
                i += 1
            if i < len(s) and s[i] == ",":
                i += 1
            elif not (i < len(s) and s[i] == "]"):
                raise _Refused(f"flow sequence {s.strip()!r}")
    if s[0] in "{&*!|>%@`?" or s[0] == "-" and s[1:2] in ("", " "):
        raise _Refused(f"value {s.strip()!r}")
    plain = re.split(r"\s#", s, maxsplit=1)[0].strip()
    if ": " in plain or plain.endswith(":"):
        raise _Refused(f"a mapping inside the value {plain!r}")
    return _resolve(plain)


def parse_yaml(text: str, source: str = "<yaml>"):
    """Read the YAML subset of the variant files, as ``yaml.safe_load`` does:
    nested block mappings by indentation (spaces), ``#`` comments, plain and
    quoted scalars resolved to None, bool, int, float or str, and one-line
    flow sequences of scalars (``[6, 5, 4]``).  Anything else (block
    sequences, flow mappings, anchors, tags, block scalars, multi-line
    scalars, several documents, duplicate keys, sexagesimal numbers, dates)
    raises ValueError naming the line.  An empty document is None."""
    root: dict | None = None
    stack: list[tuple[int, dict]] = []  # (indent of the mapping's keys, mapping)
    open_key = None  # (indent, mapping, key) of a key whose value is on the lines below
    started = False
    for lineno, raw in enumerate(text.splitlines(), 1):
        try:
            body = raw.lstrip(" ")
            if not body.strip() or body.startswith("#"):
                continue
            if body[0] == "\t" or raw[:len(raw) - len(body)].count("\t"):
                raise _Refused("a tab in the indentation")
            indent = len(raw) - len(body)
            body = body.rstrip()
            if body == "---" and not started and indent == 0:
                started = True
                continue
            started = True
            if open_key is not None:
                key_indent, mapping, key = open_key
                open_key = None
                if indent > key_indent:
                    mapping[key] = {}
                    stack.append((indent, mapping[key]))
                else:
                    mapping[key] = None
            if root is None:
                root = {}
                stack.append((indent, root))
            while stack and stack[-1][0] > indent:
                stack.pop()
            if not stack or stack[-1][0] != indent:
                raise _Refused("an indentation that opens no mapping")
            m = re.match(r"([^\s'\"#\[\]{},&*!|>%@`?-][^\s:]*(?:[ ]+[^\s:]+)*|-[^\s:]+)"
                         r"[ ]*:(?:[ ]+(.*))?$", body)
            if not m:
                raise _Refused(f"line {body!r} (expected 'key: value')")
            key, value = m.group(1), (m.group(2) or "").strip()
            if not isinstance(_resolve(key), str):
                raise _Refused(f"key {key!r} (not a string)")
            mapping = stack[-1][1]
            if key in mapping:
                raise _Refused(f"duplicate key {key!r}")
            if not value or value.startswith("#"):
                mapping[key] = None
                open_key = (indent, mapping, key)
            else:
                mapping[key] = _value(value)
        except _Refused as e:
            raise ValueError(f"{source}:{lineno}: {e} is outside the YAML subset this reader "
                             "takes") from None
    return root
