"""Weight-only int8 / int4 linear layers: the hand-written Hopper kernels of
``csrc/qlinear.cu`` (they replace XLA's fusion of ``QTensor.dequant`` into
the consuming matmul, ``pocket_tts_tpu/ops/qtensor.py:61-93``; there is no
Pallas kernel behind it).

``qlinear(x, w, b)`` computes ``x @ mat(w).T (+ b)`` in ``w``'s dtype (its
scale's), as the JAX package does, for ``x`` [..., K] and a QTensor ``w``
[N, K] or a stacked in_proj [3, E, E] (one [3E, E] product, [..., 3E] out).

* CPU tensors run :func:`qlinear_reference`, the plain version.
* CUDA tensors with at most :data:`MAX_ROWS` rows of x (the decode frame at
  B <= 32) launch a kernel; ``qlinear.launches`` counts the launches.  A
  bfloat16 weight takes the tensor-core route, sized by :func:`launch_plan`;
  a float32 one the CUDA-core route, sized by :func:`launch_plan_f32`.
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
import dataclasses
import functools
import threading

import torch

from pocket_tts_tpu_torch.kernels import build as build_mod
from pocket_tts_tpu_torch.ops.qtensor import QTensor, mat

SOURCE = build_mod.PKG / "csrc" / "qlinear.cu"
MAX_ROWS = 32  # rows of x the kernels take (kMaxRows)
MAX_ROW_BYTES = 4096  # bytes of q per output row, both routes
WARPS = 8  # warps per CTA (kWarps)
CHUNK = 64  # bytes of a row per MMA chunk: 4 lanes x 16 (kMmaChunk)
MAX_CHUNKS_WARP = 4  # chunks a warp loads at once (kMaxChunksWarp)
MAX_CLUSTER = 8  # the portable cluster size (kMaxCluster)
MAX_X_EXTENT = 2048  # x elements of a row staged per CTA (kMaxXExtent)
TARGET_CTAS = 128  # about one CTA per SM of the H100's 132
MAX_SMEM_BYTES = 232_448  # shared memory one CTA may use on Hopper (227 KB)
F32_WARPS = (8, 4)  # CTA sizes of the f32 route, the larger first
F32_MAX_CHUNKS = 8  # 16-byte slices of a row a lane holds (kF32MaxChunks)
F32_MAX_X_EXTENT = 1024  # x elements of a staged row per K tile (kF32MaxExtent)

_lock = threading.Lock()
_count_lock = threading.Lock()  # launches come from several threads of a server
_lib = None


def build():
    """Compile ``csrc/qlinear.cu`` (see :func:`kernels.build.build`)."""
    return build_mod.build(SOURCE, "qlinear")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f32, bf16 = lib.pt_qlinear_f32, lib.pt_qlinear_bf16
            f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
            bf16.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
            f32.restype = bf16.restype = ctypes.c_int
            _lib = lib
    return _lib


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch of the tensor-core route for an [N, K] weight (bytes of a
    row ``row_bytes`` = K, or K / 2 packed int4).

    The N rows fall in 16-row tiles; a CTA of :data:`WARPS` warps owns
    ``tiles_per_cta`` of them (``rows`` = 16 x that), and warp w takes tile
    ``w % tiles_per_cta`` and K slice ``w // tiles_per_cta`` of
    ``k_warps``.  A cluster of ``cluster`` CTAs splits the bytes of a row:
    CTA rank r of row block b covers bytes ``[r * span, (r + 1) * span)``,
    its warp slice s ``chunks_per_warp`` chunks of :data:`CHUNK` bytes from
    ``r * span + s * chunks_per_warp * CHUNK``.  Rank r finishes output rows
    ``[r * rows / cluster, (r + 1) * rows / cluster)`` of its row block,
    adding the partial sums of every (rank, K slice) in that order, rank 0
    and K slice 0 first.  ``grid`` CTAs in all; ``x_extent`` elements of
    each row of x staged per CTA (both halves of K for int4); ``smem`` bytes
    of dynamic shared memory for ``x_rows`` staged rows of x.  Everything
    but ``x_rows`` and ``smem`` depends on (N, K, format) alone, never on
    M."""

    rows: int
    tiles_per_cta: int
    k_warps: int
    cluster: int
    chunks_per_warp: int
    span: int
    x_extent: int
    row_blocks: int
    grid: int
    x_rows: int
    smem: int


@functools.lru_cache(maxsize=None)
def _tiling(n: int, k: int, packed: bool) -> tuple[int, int, int]:
    """(tiles per CTA, cluster size, chunks per warp) for an [N, K] weight.

    The first choice, in this order, whose grid has at least
    :data:`TARGET_CTAS` CTAs: more tiles per CTA first (every tile of a CTA
    shares its staged x, so fewer row blocks read x from L2 fewer times),
    then the smallest cluster.  Valid: at most :data:`MAX_CHUNKS_WARP` chunks
    a warp (all loaded at once), no warp slice wholly past the row, at most
    :data:`MAX_X_EXTENT` staged x elements a row, cluster <= 8 (the portable
    size: 16 needs a non-portable opt-in and may not be scheduled).  A weight
    too small to fill the grid takes the valid choice with the most CTAs."""
    row_bytes = k // 2 if packed else k
    tiles = -(-n // 16)
    chunks = -(-row_bytes // CHUNK)
    best = None
    for rt in (8, 4, 2, 1):
        kw = WARPS // rt
        for cs in (1, 2, 4, 8):
            splits = kw * cs
            cpw = -(-chunks // splits)
            span = kw * cpw * CHUNK
            if (cpw > MAX_CHUNKS_WARP or (splits - 1) * cpw >= chunks
                    or span * (2 if packed else 1) > MAX_X_EXTENT):
                continue
            ctas = -(-tiles // rt) * cs
            if ctas >= TARGET_CTAS:
                return rt, cs, cpw
            if best is None or ctas > best[0]:
                best = (ctas, (rt, cs, cpw))
    if best is None:
        raise ValueError(f"qlinear: no tensor-core tiling for N={n} K={k}")
    return best[1]


def launch_plan(m: int, n: int, k: int, packed: bool) -> LaunchPlan:
    """The tensor-core route's launch for ``m`` rows of x against an [n, k]
    weight (int8, or split-half int4 if ``packed``); no card needed."""
    if not 1 <= m <= MAX_ROWS:
        raise ValueError(f"qlinear: {m} rows of x; the kernel takes 1-{MAX_ROWS}")
    rt, cs, cpw = _tiling(n, k, packed)
    kw = WARPS // rt
    span = kw * cpw * CHUNK
    extent = span * (2 if packed else 1)
    x_rows = 8 * (1 if m <= 8 else 2 if m <= 16 else 4)
    row_blocks = -(-n // (16 * rt))
    smem = x_rows * (extent + 8) * 2 + kw * x_rows * 16 * rt * 4
    return LaunchPlan(rows=16 * rt, tiles_per_cta=rt, k_warps=kw, cluster=cs,
                      chunks_per_warp=cpw, span=span, x_extent=extent, row_blocks=row_blocks,
                      grid=row_blocks * cs, x_rows=x_rows, smem=smem)


@dataclasses.dataclass(frozen=True)
class LaunchPlanF32:
    """One launch of the f32 (CUDA-core) route for an [N, K] weight (bytes of
    a row ``row_bytes`` = K, or K / 2 packed int4).

    ``grid`` CTAs of ``warps`` warps.  Warp w is K slice ``w % k_warps`` of
    row group ``w // k_warps``; a row takes ``lanes_per_row`` lanes, so a
    warp holds ``rows_per_warp`` = 32 / that rows and a CTA ``rows`` =
    ``warps / k_warps * rows_per_warp``.  Lane l of a row holds, for chunk
    c < ``chunks_per_lane``, the 16 bytes at ``((c * k_warps + ks) *
    lanes_per_row + l) * 16`` of the row.  Its sum runs over its chunks and
    bytes in order; a butterfly over the row's lanes; the K slices added in
    order (slice 0 first).  A CTA takes at most ``x_rows`` rows of x (4 on a
    grid under half of :data:`TARGET_CTAS`, else all 32), more rows more
    CTAs along grid.y; a row's sum is the same in any of them.  x is staged
    per K tile of ``tile_chunks`` chunks,
    a power of two (``x_extent`` elements a staged row, both halves of K for
    int4; every extent a power of two, so the kernel's index arithmetic is
    shifts).  All of
    it depends on (N, K, format) alone, never on M."""

    warps: int
    k_warps: int
    lanes_per_row: int
    rows_per_warp: int
    rows: int
    chunks_per_lane: int
    tile_chunks: int
    x_extent: int
    grid: int
    x_rows: int

    def smem(self, m: int) -> int:
        """Dynamic shared memory of a CTA for ``m`` rows of x: the staged tile
        (rows past ``m`` zero) and the K slices' partial sums when K is
        split, both for the rows a CTA takes (``m`` up to ``x_rows``) rounded
        up as the kernel's row template rounds them (1, 2, 4, 8, 16, 32)."""
        mb = 1 << (min(m, self.x_rows) - 1).bit_length()
        part = self.k_warps * self.rows * mb if self.k_warps > 1 else 0
        return (mb * self.x_extent + part) * 4


@functools.lru_cache(maxsize=None)
def launch_plan_f32(n: int, k: int, packed: bool) -> LaunchPlanF32:
    """The f32 route's launch for an [n, k] weight (int8, or split-half int4
    if ``packed``); no card needed.

    Valid: at most :data:`F32_MAX_CHUNKS` slices a lane, no K slice wholly
    past the row, a step of every K slice within :data:`F32_MAX_X_EXTENT`
    staged x elements.  Chosen, in this order: the most CTAs up to
    :data:`TARGET_CTAS`; then the fewest past it (each CTA stages x); the
    fewest slices a lane; the most rows a warp (they share x's reads); the
    larger CTA; the fewer K slices."""
    row_bytes = k // 2 if packed else k
    if not 1 <= row_bytes <= MAX_ROW_BYTES:
        raise ValueError(f"qlinear: rows of {row_bytes} bytes; the kernel takes 1-{MAX_ROW_BYTES}")
    slices = -(-row_bytes // 16)
    widest = 1 << (slices - 1).bit_length()
    best = None
    for warps in F32_WARPS:
        for kw in (1, 2, 4, 8):
            for lpr in (1, 2, 4, 8, 16, 32):
                steps = -(-slices // lpr)
                cpl = -(-steps // kw)
                step_x = kw * lpr * 16 * (2 if packed else 1)
                if (lpr > widest or kw > min(steps, warps) or cpl > F32_MAX_CHUNKS
                        or step_x > F32_MAX_X_EXTENT):
                    continue
                rows = warps // kw * (32 // lpr)
                grid = -(-n // rows)
                key = (min(grid, TARGET_CTAS), -max(grid, TARGET_CTAS), -cpl, 32 // lpr, warps,
                       -kw)
                if best is None or key > best[0]:
                    tile = 1 << (min(cpl, F32_MAX_X_EXTENT // step_x).bit_length() - 1)
                    best = (key, LaunchPlanF32(warps, kw, lpr, 32 // lpr, rows, cpl, tile,
                                               tile * step_x, grid,
                                               4 if grid < TARGET_CTAS // 2 else MAX_ROWS))
    if best is None:
        raise ValueError(f"qlinear: no f32 tiling for N={n} K={k}")
    return best[1]


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
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, w.q, w.scale, b)):
        # the launch goes through raw pointers: its output has no grad_fn
        raise RuntimeError("qlinear: the CUDA kernel has no backward; under autograd call "
                           "the plain product, kernels.qlinear.qlinear_reference")
    w2 = as_matrix(w)
    n, k = w2.shape
    if x.shape[-1] != k:
        raise ValueError(f"qlinear: x has {x.shape[-1]} features, the weight {k}")
    x2 = x.reshape(-1, k).to(w2.dtype).contiguous()
    m = x2.shape[0]
    if m > MAX_ROWS or m == 0:
        with _count_lock:
            qlinear.large_m += 1
        y = x2 @ mat(w2).T
        if b is not None:
            y = y + b
        return y.reshape(*x.shape[:-1], n)
    _check(x2, w2, b)
    lib = _load()
    y = torch.empty((m, n), dtype=w2.dtype, device=x.device)
    row_bytes = w2.q.shape[-1]
    packed = int(w2.packed)
    aligned = int(row_bytes % 16 == 0 and w2.q.data_ptr() % 16 == 0)
    ptrs = (x2.data_ptr(), w2.q.data_ptr(), w2.scale.data_ptr(),
            None if b is None else b.data_ptr(), y.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if w2.dtype == torch.bfloat16:
            plan = launch_plan(m, n, k, w2.packed)
            xvec = int(k % 8 == 0 and row_bytes % 8 == 0 and x2.data_ptr() % 16 == 0)
            err = lib.pt_qlinear_bf16(*ptrs, m, n, k, row_bytes, packed, aligned, xvec,
                                      plan.tiles_per_cta, plan.cluster, plan.chunks_per_warp,
                                      plan.smem, stream)
        else:
            plan = launch_plan_f32(n, k, w2.packed)
            xvec = int(k % 4 == 0 and row_bytes % 4 == 0 and x2.data_ptr() % 16 == 0)
            err = lib.pt_qlinear_f32(*ptrs, m, n, k, row_bytes, packed, aligned, xvec, plan.warps,
                                     plan.k_warps, plan.lanes_per_row, plan.chunks_per_lane,
                                     plan.tile_chunks, plan.x_rows, stream)
    if err != 0:
        raise RuntimeError(f"qlinear: CUDA launch failed with error {err} (M={m} N={n} K={k} "
                           f"{'int4' if w2.packed else 'int8'} {w2.dtype})")
    with _count_lock:
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
