"""Weight-only int8 / int4 quantization (port of ``pocket_tts_tpu/ops/qtensor.py``).

Weights are stored as int8, or as nibble-packed int4 in ``uint8``, with one
scale per output channel.  The JAX package leaves the dequantize to XLA,
which fuses it into the consuming matmul's weight read; eager PyTorch fuses
nothing, so the port's linear layers take a ``QTensor`` through the
hand-written GEMV ``kernels.qlinear`` (small M on CUDA) and everything else
through :func:`mat`, the identity for plain tensors.
"""

from __future__ import annotations

import torch


class QTensor:
    """Quantized values ``q`` + per-channel scales ``scale`` (axis 0 of the
    non-stacked weight).  A plain class: the param dicts hold it as a leaf.

    Two storage layouts, told apart by ``q.dtype``:

    * int8: one value per byte;
    * uint8: packed int4, split-half along the last axis: byte ``j`` of a row
      holds element ``j`` in its low nibble and element ``j + d/2`` in its
      high nibble, each offset by 8.

    ``scale``'s dtype is the dequantization target: the engine's dtype policy
    casts scales only, never ``q``.
    """

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def packed(self) -> bool:
        return self.q.dtype == torch.uint8

    @property
    def shape(self) -> tuple[int, ...]:
        """The logical (unpacked) shape."""
        if self.packed:
            return (*self.q.shape[:-1], self.q.shape[-1] * 2)
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return self.q.dim()

    @property
    def dtype(self) -> torch.dtype:
        return self.scale.dtype

    @property
    def device(self) -> torch.device:
        return self.q.device

    def __getitem__(self, idx) -> "QTensor":
        """Index the leading (layer / qkv) axes of a stacked weight."""
        return QTensor(self.q[idx], self.scale[idx])

    def dequant(self) -> torch.Tensor:
        scale = self.scale
        while scale.dim() < self.q.dim():
            scale = scale[..., None]
        if self.packed:
            lo = (self.q & 0xF).to(torch.int8) - 8
            hi = (self.q >> 4).to(torch.int8) - 8
            return torch.cat([lo, hi], dim=-1).to(scale.dtype) * scale
        return self.q.to(scale.dtype) * scale

    def astype(self, dtype: torch.dtype) -> "QTensor":
        return QTensor(self.q, self.scale.to(dtype))

    def to(self, device=None, dtype: torch.dtype | None = None) -> "QTensor":
        """``to(device)`` moves both tensors; ``to(dtype)`` (or ``dtype=``)
        casts the scale only."""
        if isinstance(device, torch.dtype):
            device, dtype = None, device
        q, scale = self.q, self.scale
        if device is not None:
            q, scale = q.to(device), scale.to(device)
        if dtype is not None:
            scale = scale.to(dtype)
        return QTensor(q, scale)

    def __repr__(self) -> str:
        kind = "int4-packed" if self.packed else "int8"
        return f"QTensor({kind} {self.shape}, scale {tuple(self.scale.shape)} {self.dtype})"


def mat(w):
    """Resolve a weight operand: dequantize a QTensor, pass tensors through."""
    return w.dequant() if isinstance(w, QTensor) else w


def quantize_array(w: torch.Tensor, channel_axes: int = 1, bits: int = 8) -> QTensor:
    """Symmetric per-channel quantization: scales over the leading
    ``channel_axes`` dims (1 for [out, in], all but the last for stacked
    weights).  ``bits``: 8 (int8) or 4 (packed int4; an odd last dim keeps
    int8 storage at the int4 levels)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qmax = (1 << (bits - 1)) - 1
    w32 = w.float()
    absmax = w32.abs().amax(dim=tuple(range(channel_axes, w.dim())))
    # jax.jit of the JAX package's `absmax / qmax` multiplies by the f32
    # reciprocal (XLA's rewrite); dividing here would differ in the last bit
    # of most scales, and by one level in a few q values per million
    scale = absmax.clamp_min(1e-12) * torch.tensor(1.0 / qmax, dtype=torch.float32)
    s = scale.reshape(*scale.shape, *([1] * (w.dim() - scale.dim())))
    q = torch.round(w32 / s).clamp(-qmax, qmax)
    if bits == 4 and w.shape[-1] % 2 == 0:
        vals = (q.to(torch.int8) + 8).to(torch.uint8)  # nibbles 1..15
        half = w.shape[-1] // 2
        return QTensor(vals[..., :half] | (vals[..., half:] << 4), scale.to(w.dtype))
    return QTensor(q.to(torch.int8), scale.to(w.dtype))


def quantization_snr_db(w: torch.Tensor, qt: QTensor) -> float:
    """Signal-to-noise ratio (dB) of the round trip."""
    w = w.double()
    err = w - qt.dequant().double()
    noise = max(float(err.square().sum()), 1e-30)
    return float(10.0 * torch.log10(w.square().sum() / noise))


# Quantization policy (the JAX package's): embeddings, LUTs, attention
# out_proj, the EOS head, norms and scales stay full precision; tensors
# smaller than MIN_SIZE are not worth it.
SKIP_SUBSTRINGS = ("embed", "lut", "out_proj", "out_eos", "speaker_proj",
                   "norm", "alpha", "scale", "bos", "emb_", "ls1", "ls2",
                   "ln_w", "ln_b")
MIN_SIZE = 1024
STACKED_WEIGHTS = ("in_proj", "ff1", "ff2", "mlp1_w", "mlp2_w", "ada_w")


def should_quantize(name: str, leaf) -> bool:
    if not torch.is_tensor(leaf) or leaf.numel() < MIN_SIZE:
        return False
    if leaf.dim() < 2 or leaf.dtype not in (torch.float32, torch.bfloat16):
        return False
    lname = name.lower()
    # biases are 1-D, or 2-D once layer-stacked ([L, dim]): never quantized
    last = lname.rsplit("/", 1)[-1]
    if last.endswith("_b") or last in ("b", "b1", "b2", "bias"):
        return False
    return not any(s in lname for s in SKIP_SUBSTRINGS)


def map_with_path(tree, fn, path: str = ""):
    """``fn("a/b/0/w", leaf)`` over a tree of dicts and lists (QTensors are
    leaves), with the JAX package's path names."""
    if isinstance(tree, dict):
        return {k: map_with_path(v, fn, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(v, fn, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def quantize_tree(params: dict, *, stacked_names: tuple[str, ...] = (), bits: int = 8) -> dict:
    """Quantize the eligible leaves of a param tree.  ``stacked_names``:
    leaf names whose weights carry leading layer (and qkv) axes, so their
    scales run over every axis but the last."""

    def visit(name, leaf):
        if not should_quantize(name, leaf):
            return leaf
        axes = leaf.dim() - 1 if name.rsplit("/", 1)[-1] in stacked_names else 1
        return quantize_array(leaf, channel_axes=axes, bits=bits)

    return map_with_path(params, visit)
