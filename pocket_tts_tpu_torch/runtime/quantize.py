"""Model-level weight quantization (port of
``pocket_tts_tpu/runtime/quantize.py``): the ``--quantized`` CLI path, the
``quantize`` artifact, and its loader.

The artifact is the JAX package's, so either package reads the other's:
safetensors with metadata ``format: pocket-tts-tpu-int8`` and ``bits``, each
quantized leaf stored as ``<path>.q`` (int8, or uint8 packed int4) and
``<path>.scale`` (float32), every other leaf as float32 under its path
(``flow_lm/tf/ff1``, ``mimi/decoder/3/w``, ...).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from pocket_tts_tpu_torch import weights as weights_mod
from pocket_tts_tpu_torch.ops.qtensor import STACKED_WEIGHTS, QTensor, map_with_path, quantize_tree
from pocket_tts_tpu_torch.runtime.engine import Engine
from pocket_tts_tpu_torch.tts import TTSModel

logger = logging.getLogger(__name__)

FORMAT = "pocket-tts-tpu-int8"


def quantize_params(params: dict, bits: int = 8) -> dict:
    """Quantize a float32 param tree by the policy of ``ops.qtensor``; the
    ``q`` and ``scale`` are bit-equal to the JAX package's jitted
    ``quantize_params`` on the same weights."""
    return quantize_tree(params, stacked_names=STACKED_WEIGHTS, bits=bits)


def _keystr(path: str) -> str:
    """"mimi/decoder/3/w" -> "['mimi']['decoder'][3]['w']" (``jax.tree_util.keystr``)."""
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in path.split("/"))


def snr_report(params: dict, qparams: dict) -> dict[str, float]:
    """Round-trip SNR (dB) of every quantized leaf, keyed as the JAX
    package's report keys them (``jax.tree_util.keystr``)."""
    flat = dict(_flatten_paths(params))
    out = {}
    for path, leaf in _flatten_paths(qparams):
        if isinstance(leaf, QTensor):
            w = flat[path].double()
            noise = max(float((w - leaf.dequant().double()).square().sum()), 1e-30)
            out[_keystr(path)] = float(10.0 * np.log10(float(w.square().sum()) / noise))
    return out


def _flatten_paths(params: dict) -> list[tuple[str, object]]:
    items: list[tuple[str, object]] = []

    def visit(path, leaf):
        items.append((path, leaf))
        return leaf

    map_with_path(params, visit)
    return items


def _unflatten_paths(items: dict[str, object]) -> dict:
    """Rebuild the nested tree from path/leaf pairs; all-digit path segments
    become list indices (the SEANet layer lists)."""
    root: dict = {}
    for path, leaf in items.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            # index gaps are parameterless layers (SEANet ELU entries hold {}
            # and have no path); both plans end with a conv, so the largest
            # index bounds the list
            top = max(int(k) for k in node)
            return [node.get(str(i), {}) for i in range(top + 1)]
        return node

    return listify(root)


def save_quantized(params: dict, path: str | Path) -> None:
    """Write a quantized param tree as the artifact: QTensor leaves as
    ``<path>.q`` + ``<path>.scale`` (float32), plain leaves as float32;
    ``bits`` records the narrowest width (4 if any leaf is packed)."""
    bits = 8
    tensors = {}
    for name, leaf in _flatten_paths(params):
        if isinstance(leaf, QTensor):
            if leaf.packed:
                bits = 4
            tensors[name + ".q"] = leaf.q.cpu().numpy()
            tensors[name + ".scale"] = leaf.scale.float().cpu().numpy()
        else:
            tensors[name] = leaf.float().cpu().numpy()
    weights_mod.write_safetensors(tensors, path, metadata={"format": FORMAT, "bits": str(bits)})


def load_quantized(path: str | Path) -> dict:
    """Read a :func:`save_quantized` artifact (this package's or the JAX
    package's) into a param tree of CPU tensors and QTensors.  A plain
    safetensors file raises ValueError."""
    tensors, meta = weights_mod.read_safetensors(path, with_metadata=True)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path} is not a pocket-tts-tpu int8 checkpoint")
    items: dict[str, object] = {}
    qparts: dict[str, dict] = {}
    for key, arr in tensors.items():
        if key.endswith((".q", ".scale")):
            base, kind = key.rsplit(".", 1)
            qparts.setdefault(base, {})[kind] = arr
        else:
            items[key] = torch.from_numpy(np.asarray(arr, np.float32))
    for base, parts in qparts.items():
        # the dtype selects the layout: int8 plain, uint8 packed int4
        items[base] = QTensor(torch.from_numpy(parts["q"]), torch.from_numpy(parts["scale"]))
    return _unflatten_paths(items)


def quantize_model(model: TTSModel, bits: int = 8) -> TTSModel:
    """A clone of ``model`` on int8 (or int4) weights, with its own
    ``Engine``: the float32 ``model.params`` are quantized (never the
    engine's bf16 copy, which would give other levels)."""
    qparams = quantize_params(model.params, bits=bits)
    n_q = sum(isinstance(leaf, QTensor) for _, leaf in _flatten_paths(qparams))
    logger.info("quantized %d weight tensors to int%d", n_q, bits)
    clone = object.__new__(TTSModel)
    clone.__dict__.update(model.__dict__)
    clone.params = qparams
    clone.engine = Engine(model.config, qparams, model.device, batch_size=model.engine.batch)
    if model.engine._codec_device is not None:  # the source model's staged codec
        clone.engine.enable_staged_codec(model.engine._codec_device)
    clone._rng = torch.Generator().set_state(model._rng.get_state())
    clone.is_quantized = True
    return clone
