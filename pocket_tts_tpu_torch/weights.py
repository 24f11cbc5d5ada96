"""Checkpoint loading (port of ``pocket_tts_tpu/weights.py``).

Reads the released combined checkpoint layout (the reference
``TTSModel.state_dict()`` key names, which ``pocket_tts_tpu.weights.
export_state_dict`` also writes) into the port's parameter dicts of torch
tensors, and writes them back (``export_state_dict`` / ``save_checkpoint``).  A small numpy safetensors reader and writer replace the
``safetensors`` package; without a checkpoint the loader falls back to a
deterministic random init at full width (numpy only), with the same keys,
shapes and init families as the JAX package's ``random_params``.
``hf://owner/repo/file@rev`` URIs resolve through the local Hugging Face
cache, read by path; nothing is downloaded.
"""

from __future__ import annotations

import json
import logging
import os
import re
import struct
from pathlib import Path

import numpy as np
import torch

from pocket_tts_tpu_torch.config import Config
from pocket_tts_tpu_torch.models.mimi import MimiPlans

logger = logging.getLogger(__name__)

_ST_DTYPES = {"F32": np.float32, "F16": np.float16}
_ST_INTS = {"I8": np.int8, "U8": np.uint8}
_HF_RE = re.compile(r"^hf://(?P<owner>[^/]+)/(?P<repo>[^/]+)/(?P<file>.+?)(@(?P<rev>[^@]+))?$")


def _hf_cache_dir() -> Path:
    """The hub cache: $HF_HUB_CACHE, else $HF_HOME/hub, else
    ~/.cache/huggingface/hub (the ``huggingface_hub`` defaults)."""
    if os.environ.get("HF_HUB_CACHE"):
        return Path(os.environ["HF_HUB_CACHE"])
    home = os.environ.get("HF_HOME") or Path.home() / ".cache" / "huggingface"
    return Path(home) / "hub"


def resolve_uri(uri: str | Path) -> Path:
    """``hf://owner/repo/file@rev`` -> the file in the local Hugging Face
    cache (``models--owner--repo/snapshots/<commit>/file``; a branch or tag
    revision, or none for ``main``, is read from ``refs/``).  Any other string
    is a local path.  With no cached file it raises ``FileNotFoundError``, as
    the JAX package does offline: downloading is not ported."""
    if isinstance(uri, Path) or not str(uri).startswith("hf://"):
        return Path(uri)
    m = _HF_RE.match(str(uri))
    if not m:
        raise ValueError(f"Bad hf:// URI: {uri}")
    repo_dir = _hf_cache_dir() / f"models--{m['owner']}--{m['repo']}"
    rev = m["rev"] or "main"
    ref = repo_dir / "refs" / rev
    commit = ref.read_text().strip() if ref.is_file() else rev
    path = repo_dir / "snapshots" / commit / m["file"]
    if not path.is_file():
        raise FileNotFoundError(
            f"{uri} is not in the local Hugging Face cache (looked for {path}); "
            "downloading is not supported: place the file there")
    return path


def read_safetensors(path: str | Path, *, with_metadata: bool = False):
    """safetensors file -> {name: array} (see ``read_safetensors_bytes``)."""
    return read_safetensors_bytes(Path(path).read_bytes(), str(path),
                                  with_metadata=with_metadata)


def read_safetensors_header(path: str | Path) -> tuple[list[str], dict]:
    """(tensor names, ``__metadata__``) of a safetensors file, from its
    header alone."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
    meta = dict(header.pop("__metadata__", None) or {})
    return list(header), meta


def read_safetensors_bytes(data: bytes, name: str = "<bytes>", *, with_metadata: bool = False):
    """safetensors bytes -> {name: array} (8-byte little-endian header
    length, JSON header, packed data): F32, F16 and BF16 tensors widened to
    float32, I8 and U8 tensors as stored.  ``with_metadata`` returns
    ``(tensors, metadata)``, the header's ``__metadata__`` dict (or {})."""
    (header_len,) = struct.unpack_from("<Q", data, 0)
    header = json.loads(data[8:8 + header_len])
    base = 8 + header_len
    out = {}
    for key, meta in header.items():
        if key == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        raw = data[base + start:base + end]
        dtype = meta["dtype"]
        if dtype == "BF16":
            arr = (np.frombuffer(raw, np.uint16).astype(np.uint32) << 16).view(np.float32)
        elif dtype in _ST_DTYPES:
            arr = np.frombuffer(raw, _ST_DTYPES[dtype]).astype(np.float32)
        elif dtype in _ST_INTS:
            arr = np.frombuffer(raw, _ST_INTS[dtype]).copy()
        else:
            raise ValueError(f"{name}: tensor {key} has unsupported dtype {dtype}")
        out[key] = arr.reshape(meta["shape"])
    if with_metadata:
        return out, dict(header.get("__metadata__") or {})
    return out


def write_safetensors(tensors: dict[str, np.ndarray], path: str | Path,
                      metadata: dict[str, str] | None = None) -> None:
    """{name: array} -> safetensors file: int8 and uint8 arrays as I8 / U8,
    every other array as F32; 8-byte little-endian header length, JSON
    header (``dtype``, ``shape``, ``data_offsets``, and ``metadata`` as
    ``__metadata__``) padded with spaces to a multiple of 8 bytes, then the
    packed data."""
    header: dict = {"__metadata__": dict(metadata)} if metadata else {}
    blobs, offset = [], 0
    for key, arr in tensors.items():
        kind = {np.dtype(np.int8): ("I8", "i1"), np.dtype(np.uint8): ("U8", "u1")}.get(
            np.asarray(arr).dtype, ("F32", "<f4"))
        raw = np.ascontiguousarray(arr, dtype=kind[1]).tobytes()
        header[key] = {"dtype": kind[0], "shape": list(np.shape(arr)),
                       "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def remap_split_flow_lm(sd: dict) -> dict:
    """Key remap for the standalone flow-lm checkpoint -> ``flow_lm.``-prefixed keys."""
    out = {}
    for key, value in sd.items():
        if key.startswith("flow.w_s_t.") or key in (
            "condition_provider.conditioners.transcript_in_segment.learnt_padding",
            "condition_provider.conditioners.speaker_wavs.learnt_padding",
        ):
            continue
        new = key
        if key == "condition_provider.conditioners.transcript_in_segment.embed.weight":
            new = "conditioner.embed.weight"
        if key == "condition_provider.conditioners.speaker_wavs.output_proj.weight":
            new = "speaker_proj_weight"
        out[f"flow_lm.{new}"] = value
    return out


def remap_split_mimi(sd: dict) -> dict:
    """Key remap for the standalone mimi checkpoint -> ``mimi.``-prefixed keys."""
    out = {}
    for key, value in sd.items():
        if key.startswith("model.quantizer.vq.") or key == "model.quantizer.logvar_proj.weight":
            continue
        out["mimi." + key.removeprefix("model.")] = value
    return out


def load_state_dict_any(path_spec: str | Path) -> dict:
    """A combined checkpoint, or an os.pathsep-separated list of split
    flow-lm/mimi files (layouts detected, remapped and merged)."""
    merged: dict = {}
    for part in str(path_spec).split(os.pathsep):
        path = Path(part)
        if not path.exists():
            raise FileNotFoundError(f"checkpoint {part} does not exist")
        sd = read_safetensors(path)
        if any(k.startswith("model.") for k in sd):
            sd = remap_split_mimi(sd)
        elif not any(k.startswith(("flow_lm.", "mimi.")) for k in sd):
            sd = remap_split_flow_lm(sd)
        merged.update(sd)
    return merged


# ---------------------------------------------------------------------------
# reference layout -> port params
# ---------------------------------------------------------------------------


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _stack(sd: dict, prefix: str, n: int, suffix: str) -> torch.Tensor:
    return torch.stack([_t(sd[f"{prefix}.{i}.{suffix}"]) for i in range(n)])


# the reference layout's key suffixes, by port parameter name: read by the
# convert_* functions and written by the export_* ones
_TF_KEYS = {"out_proj": "self_attn.out_proj.weight", "norm1_w": "norm1.weight",
            "norm1_b": "norm1.bias", "norm2_w": "norm2.weight", "norm2_b": "norm2.bias",
            "ff1": "linear1.weight", "ff2": "linear2.weight"}
_LAYER_SCALE_KEYS = {"ls1": "layer_scale_1.scale", "ls2": "layer_scale_2.scale"}
_TE_KEYS = {"w1": "mlp.0.weight", "b1": "mlp.0.bias", "w2": "mlp.2.weight", "b2": "mlp.2.bias",
            "alpha": "mlp.3.alpha"}
_FLOW_KEYS = {"cond_w": "cond_embed.weight", "cond_b": "cond_embed.bias",
              "in_w": "input_proj.weight", "in_b": "input_proj.bias",
              "final_ada_w": "final_layer.adaLN_modulation.1.weight",
              "final_ada_b": "final_layer.adaLN_modulation.1.bias",
              "final_w": "final_layer.linear.weight", "final_b": "final_layer.linear.bias"}
_FLOW_BLOCK_KEYS = {"ln_w": "in_ln.weight", "ln_b": "in_ln.bias",
                    "mlp1_w": "mlp.0.weight", "mlp1_b": "mlp.0.bias",
                    "mlp2_w": "mlp.2.weight", "mlp2_b": "mlp.2.bias",
                    "ada_w": "adaLN_modulation.1.weight", "ada_b": "adaLN_modulation.1.bias"}
_FLOW_LM_KEYS = {"input_w": "input_linear.weight", "out_norm_w": "out_norm.weight",
                 "out_norm_b": "out_norm.bias", "out_eos_w": "out_eos.weight",
                 "out_eos_b": "out_eos.bias", "bos_emb": "bos_emb", "emb_std": "emb_std",
                 "emb_mean": "emb_mean", "text_embed": "conditioner.embed.weight",
                 "speaker_proj": "speaker_proj_weight"}
_MIMI_KEYS = {"quantizer_w": "quantizer.output_proj.weight",
              "downsample_w": "downsample.conv.conv.weight",
              "upsample_w": "upsample.convtr.convtr.weight"}
_RES_CONVS = (("conv0", 1), ("conv1", 3))  # a SEANet residual block's convs, by torch index


def convert_transformer(sd: dict, prefix: str, n_layers: int, layer_scale: bool) -> dict:
    """Per-layer torch keys -> stacked [L, ...] tensors; in_proj [L, 3E, E] is
    viewed as [L, 3, E, E] (torch rows are qkv-major)."""
    lp = f"{prefix}.layers"
    in_proj = _stack(sd, lp, n_layers, "self_attn.in_proj.weight")
    L, three_e, e = in_proj.shape
    keys = {**_TF_KEYS, **(_LAYER_SCALE_KEYS if layer_scale else {})}
    return {"in_proj": in_proj.reshape(L, 3, three_e // 3, e),
            **{name: _stack(sd, lp, n_layers, suffix) for name, suffix in keys.items()}}


def _te(sd: dict, prefix: str) -> dict:
    return {name: _t(sd[f"{prefix}.{suffix}"]) for name, suffix in _TE_KEYS.items()}


def convert_flow_mlp(sd: dict, prefix: str, depth: int) -> dict:
    return {
        "time_embed_0": _te(sd, f"{prefix}.time_embed.0"),
        "time_embed_1": _te(sd, f"{prefix}.time_embed.1"),
        **{name: _t(sd[f"{prefix}.{suffix}"]) for name, suffix in _FLOW_KEYS.items()},
        "blocks": {name: _stack(sd, f"{prefix}.res_blocks", depth, suffix)
                   for name, suffix in _FLOW_BLOCK_KEYS.items()},
    }


def convert_flow_lm(sd: dict, cfg: Config, prefix: str = "flow_lm") -> dict:
    tcfg = cfg.flow_lm.transformer
    return {
        "tf": convert_transformer(sd, f"{prefix}.transformer", tcfg.num_layers, False),
        "flow": convert_flow_mlp(sd, f"{prefix}.flow_net", cfg.flow_lm.flow.depth),
        **{name: _t(sd[f"{prefix}.{suffix}"]) for name, suffix in _FLOW_LM_KEYS.items()},
    }


def _conv(sd: dict, name: str) -> dict:
    p = {"w": _t(sd[f"{name}.weight"])}
    if f"{name}.bias" in sd:
        p["b"] = _t(sd[f"{name}.bias"])
    return p


def convert_seanet(sd: dict, prefix: str, plan) -> list:
    params = []
    for layer in plan:
        base = f"{prefix}.model.{layer.index}"
        if layer.kind in ("conv", "convtr"):
            p = _conv(sd, f"{base}.{layer.kind}")
        elif layer.kind == "res":
            p = {name: _conv(sd, f"{base}.block.{tidx}.conv") for name, tidx in _RES_CONVS}
        else:
            p = {}
        params.append(p)
    return params


def convert_mimi(sd: dict, plans: MimiPlans, prefix: str = "mimi") -> dict:
    """Decoder-side weights drive decode; encoder, encoder transformer and
    downsample weights drive voice cloning."""
    n = plans.cfg.transformer.num_layers
    return {
        "encoder": convert_seanet(sd, f"{prefix}.encoder", plans.encoder),
        "decoder": convert_seanet(sd, f"{prefix}.decoder", plans.decoder),
        "enc_tf": {"layers": convert_transformer(
            sd, f"{prefix}.encoder_transformer.transformer", n, True)},
        "dec_tf": {"layers": convert_transformer(
            sd, f"{prefix}.decoder_transformer.transformer", n, True)},
        **{name: _t(sd[f"{prefix}.{suffix}"]) for name, suffix in _MIMI_KEYS.items()},
    }


def from_state_dict(sd: dict, cfg: Config) -> dict:
    """Reference-layout numpy state dict -> port params {"flow_lm", "mimi"}
    (float32 CPU tensors)."""
    return {"flow_lm": convert_flow_lm(sd, cfg), "mimi": convert_mimi(sd, MimiPlans(cfg.mimi))}


# ---------------------------------------------------------------------------
# port params -> reference layout
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    """A float tensor leaf -> float32 numpy.  A QTensor leaf raises, as the
    JAX package's export does: quantized weights ship through
    ``runtime.quantize.save_quantized``."""
    if not torch.is_tensor(t):
        raise TypeError(f"export_state_dict takes float tensors, got {type(t).__name__}; "
                        "save quantized params with runtime.quantize.save_quantized")
    return t.detach().to("cpu", torch.float32).numpy().copy()


def export_transformer(p: dict, prefix: str, layer_scale: bool) -> dict:
    """Inverse of ``convert_transformer``: in_proj [L, 3, E, E] folds back to
    per-layer [3E, E] rows."""
    keys = {**_TF_KEYS, **(_LAYER_SCALE_KEYS if layer_scale else {})}
    stacks = {name: _np(p[name]) for name in ("in_proj", *keys)}
    in_proj = stacks.pop("in_proj")
    out = {}
    for i in range(in_proj.shape[0]):
        out[f"{prefix}.layers.{i}.self_attn.in_proj.weight"] = \
            in_proj[i].reshape(-1, in_proj.shape[-1])
        for name, suffix in keys.items():
            out[f"{prefix}.layers.{i}.{suffix}"] = stacks[name][i]
    return out


def _export(p: dict, prefix: str, keys: dict) -> dict:
    return {f"{prefix}.{suffix}": _np(p[name]) for name, suffix in keys.items()}


def export_flow_mlp(p: dict, prefix: str) -> dict:
    """Inverse of ``convert_flow_mlp``."""
    out = {**_export(p["time_embed_0"], f"{prefix}.time_embed.0", _TE_KEYS),
           **_export(p["time_embed_1"], f"{prefix}.time_embed.1", _TE_KEYS),
           **_export(p, prefix, _FLOW_KEYS)}
    for name, suffix in _FLOW_BLOCK_KEYS.items():
        for i, w in enumerate(_np(p["blocks"][name])):
            out[f"{prefix}.res_blocks.{i}.{suffix}"] = w
    return out


def export_seanet(params: list, prefix: str, plan) -> dict:
    """Inverse of ``convert_seanet``."""
    out = {}
    for p, layer in zip(params, plan):
        base = f"{prefix}.model.{layer.index}"
        if layer.kind in ("conv", "convtr"):
            convs = {f"{base}.{layer.kind}": p}
        elif layer.kind == "res":
            convs = {f"{base}.block.{tidx}.conv": p[name] for name, tidx in _RES_CONVS}
        else:
            convs = {}
        for name, conv in convs.items():
            out |= _export(conv, name, {"w": "weight", **({"b": "bias"} if "b" in conv else {})})
    return out


def export_state_dict(params: dict, cfg: Config) -> dict[str, np.ndarray]:
    """Port params -> the released combined-checkpoint layout, float32 numpy
    in torch ``[out, in]`` layout: the exact inverse of ``from_state_dict``,
    with the keys of the JAX package's ``export_state_dict``.  Float params
    only (a QTensor leaf raises TypeError)."""
    fl, mm = params["flow_lm"], params["mimi"]
    plans = MimiPlans(cfg.mimi)
    return {**export_transformer(fl["tf"], "flow_lm.transformer", False),
            **export_flow_mlp(fl["flow"], "flow_lm.flow_net"),
            **_export(fl, "flow_lm", _FLOW_LM_KEYS),
            **export_seanet(mm["encoder"], "mimi.encoder", plans.encoder),
            **export_seanet(mm["decoder"], "mimi.decoder", plans.decoder),
            **export_transformer(mm["enc_tf"]["layers"], "mimi.encoder_transformer.transformer",
                                 True),
            **export_transformer(mm["dec_tf"]["layers"], "mimi.decoder_transformer.transformer",
                                 True),
            **_export(mm, "mimi", _MIMI_KEYS)}


def save_checkpoint(params: dict, cfg: Config, path: str | Path) -> None:
    """Write float ``params`` as a combined safetensors checkpoint in the
    reference layout, readable by ``load_params`` (``POCKET_TTS_WEIGHTS``),
    ``TTSModel.load_from_bytes`` and the JAX package's loader."""
    write_safetensors(export_state_dict(params, cfg), path)


# ---------------------------------------------------------------------------
# deterministic random init, in the reference layout
# ---------------------------------------------------------------------------


def _linear_init(rng, shape) -> np.ndarray:
    """torch nn.Linear-style uniform(+-1/sqrt(fan_in)) weights [out, in]."""
    bound = 1.0 / np.sqrt(shape[-1])
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def _random_transformer(rng, out: dict, prefix: str, n_layers: int, d: int, d_ff: int,
                        layer_scale: float | None) -> None:
    def lin(shape):
        return _linear_init(rng, shape)

    for i in range(n_layers):
        lp = f"{prefix}.layers.{i}"
        out[f"{lp}.self_attn.in_proj.weight"] = lin((3 * d, d))
        out[f"{lp}.self_attn.out_proj.weight"] = lin((d, d))
        out[f"{lp}.linear1.weight"] = lin((d_ff, d))
        out[f"{lp}.linear2.weight"] = lin((d, d_ff))
        for n in ("norm1", "norm2"):
            out[f"{lp}.{n}.weight"] = np.ones(d, np.float32)
            out[f"{lp}.{n}.bias"] = np.zeros(d, np.float32)
        if layer_scale is not None:
            out[f"{lp}.layer_scale_1.scale"] = np.full(d, layer_scale, np.float32)
            out[f"{lp}.layer_scale_2.scale"] = np.full(d, layer_scale, np.float32)


def _random_conv(rng, out: dict, name: str, spec, transposed: bool = False) -> None:
    if transposed:
        fan_in = spec.out_channels // spec.groups * spec.kernel_size
        shape = (spec.in_channels, spec.out_channels // spec.groups, spec.kernel_size)
    else:
        fan_in = spec.in_channels // spec.groups * spec.kernel_size
        shape = (spec.out_channels, spec.in_channels // spec.groups, spec.kernel_size)
    bound = 1.0 / np.sqrt(fan_in)
    out[f"{name}.weight"] = rng.uniform(-bound, bound, shape).astype(np.float32)
    if spec.bias:
        out[f"{name}.bias"] = rng.uniform(-bound, bound, spec.out_channels).astype(np.float32)


def _random_seanet(rng, out: dict, prefix: str, plan) -> None:
    for layer in plan:
        base = f"{prefix}.model.{layer.index}"
        if layer.kind == "conv":
            _random_conv(rng, out, f"{base}.conv", layer.spec)
        elif layer.kind == "convtr":
            _random_conv(rng, out, f"{base}.convtr", layer.spec, transposed=True)
        elif layer.kind == "res":
            _random_conv(rng, out, f"{base}.block.1.conv", layer.res_specs[0])
            _random_conv(rng, out, f"{base}.block.3.conv", layer.res_specs[1])


def random_state_dict(cfg: Config, seed: int = 0) -> dict[str, np.ndarray]:
    """Deterministic random weights (numpy only) in the reference layout, with
    the keys, shapes and init families of the JAX package's
    ``export_state_dict(random_params(...))`` (torch nn.Linear-style uniform
    bounds, unit norms, zero biases, normal embeddings)."""
    rng = np.random.default_rng(seed)
    tcfg = cfg.flow_lm.transformer
    d, ldim = tcfg.d_model, cfg.mimi.quantizer.dimension
    fdim, depth = cfg.flow_lm.flow.dim, cfg.flow_lm.flow.depth

    def lin(shape):
        return _linear_init(rng, shape)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    out: dict[str, np.ndarray] = {}
    _random_transformer(rng, out, "flow_lm.transformer", tcfg.num_layers, d,
                        tcfg.dim_feedforward, None)
    fp = "flow_lm.flow_net"
    for j in (0, 1):
        te = f"{fp}.time_embed.{j}.mlp"
        out |= {f"{te}.0.weight": lin((fdim, 256)), f"{te}.0.bias": zeros(fdim),
                f"{te}.2.weight": lin((fdim, fdim)), f"{te}.2.bias": zeros(fdim),
                f"{te}.3.alpha": ones(fdim)}
    out |= {f"{fp}.cond_embed.weight": lin((fdim, d)), f"{fp}.cond_embed.bias": zeros(fdim),
            f"{fp}.input_proj.weight": lin((fdim, ldim)), f"{fp}.input_proj.bias": zeros(fdim),
            f"{fp}.final_layer.adaLN_modulation.1.weight": lin((2 * fdim, fdim)),
            f"{fp}.final_layer.adaLN_modulation.1.bias": zeros(2 * fdim),
            f"{fp}.final_layer.linear.weight": lin((ldim, fdim)),
            f"{fp}.final_layer.linear.bias": zeros(ldim)}
    for i in range(depth):
        rb = f"{fp}.res_blocks.{i}"
        out |= {f"{rb}.in_ln.weight": ones(fdim), f"{rb}.in_ln.bias": zeros(fdim),
                f"{rb}.mlp.0.weight": lin((fdim, fdim)), f"{rb}.mlp.0.bias": zeros(fdim),
                f"{rb}.mlp.2.weight": lin((fdim, fdim)), f"{rb}.mlp.2.bias": zeros(fdim),
                f"{rb}.adaLN_modulation.1.weight": lin((3 * fdim, fdim)),
                f"{rb}.adaLN_modulation.1.bias": zeros(3 * fdim)}
    lt = cfg.flow_lm.lookup_table
    out |= {"flow_lm.input_linear.weight": lin((d, ldim)),
            "flow_lm.out_norm.weight": ones(d), "flow_lm.out_norm.bias": zeros(d),
            "flow_lm.out_eos.weight": lin((1, d)), "flow_lm.out_eos.bias": zeros(1),
            "flow_lm.bos_emb": rng.standard_normal(ldim).astype(np.float32),
            "flow_lm.emb_std": ones(ldim), "flow_lm.emb_mean": zeros(ldim),
            "flow_lm.conditioner.embed.weight":
                rng.standard_normal((lt.n_bins + 1, lt.dim)).astype(np.float32),
            "flow_lm.speaker_proj_weight": lin((d, cfg.mimi.transformer.d_model))}

    plans = MimiPlans(cfg.mimi)
    mt = cfg.mimi.transformer
    _random_seanet(rng, out, "mimi.encoder", plans.encoder)
    _random_seanet(rng, out, "mimi.decoder", plans.decoder)
    for name in ("encoder_transformer", "decoder_transformer"):
        _random_transformer(rng, out, f"mimi.{name}.transformer", mt.num_layers, mt.d_model,
                            mt.dim_feedforward, mt.layer_scale)
    sp = plans.specs
    _random_conv(rng, out, "mimi.quantizer.output_proj", sp["quantizer"])
    _random_conv(rng, out, "mimi.downsample.conv.conv", sp["downsample"])
    _random_conv(rng, out, "mimi.upsample.convtr.convtr", sp["upsample"], transposed=True)
    return out


def load_params(cfg: Config, *, variant: str = "b6369a24", seed: int = 0,
                allow_random: bool = True) -> tuple[dict, bool]:
    """(params, is_real_weights).  Checkpoint search order: $POCKET_TTS_WEIGHTS
    (a combined file, or split flow-lm/mimi files joined by os.pathsep), then
    ./tts_<variant>.safetensors, then (if allowed) deterministic random init.
    An explicitly set POCKET_TTS_WEIGHTS that fails to load raises."""
    env_spec = os.environ.get("POCKET_TTS_WEIGHTS")
    if env_spec:
        try:
            sd = load_state_dict_any(env_spec)
        except FileNotFoundError as e:
            raise FileNotFoundError(f"POCKET_TTS_WEIGHTS={env_spec} does not exist") from e
        return from_state_dict(sd, cfg), True
    local = Path.cwd() / f"tts_{variant}.safetensors"
    if local.exists():
        logger.info("Loading weights from %s", local)
        return from_state_dict(load_state_dict_any(local), cfg), True
    if not allow_random:
        raise FileNotFoundError(
            f"No checkpoint found (tried $POCKET_TTS_WEIGHTS and {local})")
    logger.warning("No checkpoint found: using deterministic random init (seed %d)", seed)
    return from_state_dict(random_state_dict(cfg, seed), cfg), False
