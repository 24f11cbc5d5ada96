"""Weight-only int8 / int4 linear layers: the hand-written Hopper GEMV
``csrc/qlinear.cu`` (it replaces XLA's fusion of ``QTensor.dequant`` into
the consuming matmul, ``pocket_tts_tpu/ops/qtensor.py:61-93``; there is no
Pallas kernel behind it).

``qlinear(x, w, b)`` computes ``x @ mat(w).T (+ b)`` in ``w``'s dtype (its
scale's), as the JAX package does, for ``x`` [..., K] and a QTensor ``w``
[N, K] or a stacked in_proj [3, E, E] (one [3E, E] product, [..., 3E] out).

* CPU tensors run :func:`qlinear_reference`, the plain version.
* CUDA tensors with at most :data:`MAX_ROWS` rows of x (the decode frame at
  B <= 32) launch the kernel; ``qlinear.launches`` counts the launches.
* CUDA tensors with more rows (prefill, conditioning, the codec's transformer
  over 16 positions per frame) go through ``mat()`` and one ``torch.matmul``
  by this shape rule, never as a fall back; ``qlinear.large_m`` counts them.
* On CUDA a scale dtype other than bfloat16 / float32, a bias of another
  dtype, a row over 4096 bytes or a non-contiguous weight raises.

:func:`linear` is the one entry the models call for every linear layer: a
plain tensor takes ``x.to(w.dtype) @ w.T (+ b)``, a QTensor :func:`qlinear`.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from pocket_tts_tpu_torch.kernels import build as build_mod
from pocket_tts_tpu_torch.ops.qtensor import QTensor, mat

SOURCE = build_mod.PKG / "csrc" / "qlinear.cu"
MAX_ROWS = 32  # rows of x the kernel takes (kMaxRows)
MAX_ROW_BYTES = 4096  # bytes of q per output row (kMaxChunks * 512)

_lock = threading.Lock()
_lib = None


def build():
    """Compile ``csrc/qlinear.cu`` (see :func:`kernels.build.build`)."""
    return build_mod.build(SOURCE, "qlinear")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.pt_qlinear
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def as_matrix(w: QTensor) -> QTensor:
    """A 2-D view [N, row] of ``w`` (a stacked [3, E, E] in_proj is [3E, E],
    its [3, E] scale flattened); no copy."""
    if w.ndim == 2:
        return w
    return QTensor(w.q.reshape(-1, w.q.shape[-1]), w.scale.reshape(-1))


def qlinear_reference(x: torch.Tensor, w: QTensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: ``x @ mat(w).T (+ b)`` in ``w``'s dtype."""
    w2 = as_matrix(w)
    y = x.to(w2.dtype) @ mat(w2).T
    return y if b is None else y + b


def _check(x2: torch.Tensor, w2: QTensor, b: torch.Tensor | None) -> None:
    if w2.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qlinear: scale dtype {w2.dtype}; the kernel takes bfloat16 or float32")
    if b is not None and (b.dtype != w2.dtype or b.device != x2.device or b.numel() != w2.shape[0]
                          or not b.is_contiguous()):
        raise TypeError(f"qlinear: bias {b.dtype} {tuple(b.shape)} on {b.device}; the kernel "
                        f"takes a contiguous [{w2.shape[0]}] {w2.dtype} bias on {x2.device}")
    for name, t in (("q", w2.q), ("scale", w2.scale)):
        if t.device != x2.device:
            raise ValueError(f"qlinear: {name} on {t.device}, x on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"qlinear: {name} must be contiguous")
    if w2.q.shape[-1] > MAX_ROW_BYTES:
        raise ValueError(f"qlinear: rows of {w2.q.shape[-1]} bytes; the kernel takes at most "
                         f"{MAX_ROW_BYTES}")


def qlinear(x: torch.Tensor, w: QTensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` [..., K] @ ``w``ᵀ (+ ``b``) -> [..., N] in ``w``'s dtype."""
    if x.device.type == "cpu":
        return qlinear_reference(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"qlinear: unsupported device {x.device}")
    w2 = as_matrix(w)
    n, k = w2.shape
    if x.shape[-1] != k:
        raise ValueError(f"qlinear: x has {x.shape[-1]} features, the weight {k}")
    x2 = x.reshape(-1, k).to(w2.dtype).contiguous()
    m = x2.shape[0]
    if m > MAX_ROWS or m == 0:
        qlinear.large_m += 1
        y = x2 @ mat(w2).T
        if b is not None:
            y = y + b
        return y.reshape(*x.shape[:-1], n)
    _check(x2, w2, b)
    lib = _load()
    y = torch.empty((m, n), dtype=w2.dtype, device=x.device)
    row_bytes = w2.q.shape[-1]
    aligned = int(row_bytes % 16 == 0 and w2.q.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pt_qlinear(x2.data_ptr(), w2.q.data_ptr(), w2.scale.data_ptr(),
                             None if b is None else b.data_ptr(), y.data_ptr(), m, n, k,
                             row_bytes, int(w2.packed), int(w2.dtype == torch.bfloat16), aligned,
                             stream)
    if err != 0:
        raise RuntimeError(f"qlinear: CUDA launch failed with error {err} (M={m} N={n} K={k} "
                           f"{'int4' if w2.packed else 'int8'} {w2.dtype})")
    qlinear.launches += 1
    return y.reshape(*x.shape[:-1], n)


qlinear.launches = 0
qlinear.large_m = 0


def linear(x: torch.Tensor, w, b: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ w.T (+ b)`` for a plain weight (computed in ``w``'s dtype) or a
    QTensor (:func:`qlinear`)."""
    if isinstance(w, QTensor):
        return qlinear(x, w, b)
    y = x.to(w.dtype) @ w.T
    return y if b is None else y + b
