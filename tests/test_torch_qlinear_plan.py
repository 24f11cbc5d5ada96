"""``kernels.qlinear.launch_plan``: the tensor-core route's launch, checked on
the CPU (the kernel itself runs only on the card, tests/test_torch_cuda.py).

The index arithmetic below is the kernel's (csrc/qlinear.cu,
``qlinear_mma_kernel``): CTA (row block b, cluster rank r), warp w (tile
w % tiles_per_cta, K slice w // tiles_per_cta), chunk c, lane (g, t) reads
16 bytes at ``r * span + (slice * chunks_per_warp + c) * 64 + 16 t`` of rows
``b * rows + tile * 16 + g`` and ``+ 8``; rank r writes output rows
``[r * rows / cluster, (r + 1) * rows / cluster)`` of its row block.
"""

import numpy as np
import pytest
import torch

from pocket_tts_tpu_torch.kernels import qlinear as ql
from pocket_tts_tpu_torch.ops.qtensor import QTensor, quantize_array

# (N, K): the decode frame's in_proj as [3E, E], ff1, ff2, the input linear,
# and an odd shape (rows and K not multiples of 16)
FRAME_NK = [(3072, 1024), (4096, 1024), (1024, 4096), (1024, 32)]
BACKBONE_NK = FRAME_NK[:3]
ODD_NK = (1000, 1002)
FORMATS = {"int8": False, "int4": True}


def _row_bytes(k, packed):
    return k // 2 if packed else k


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("n,k", FRAME_NK + [ODD_NK])
def test_plan_covers_every_row_and_k_once(n, k, fmt):
    packed = FORMATS[fmt]
    p = ql.launch_plan(1, n, k, packed)
    rb = _row_bytes(k, packed)
    assert p.rows == 16 * p.tiles_per_cta and p.tiles_per_cta * p.k_warps == ql.WARPS
    assert p.grid == p.row_blocks * p.cluster and p.row_blocks * p.rows >= n
    assert p.span == p.k_warps * p.chunks_per_warp * ql.CHUNK
    assert p.x_extent == p.span * (2 if packed else 1)
    # every (row, byte) a lane loads, counted
    reads = np.zeros((p.row_blocks * p.rows, p.cluster * p.span + 16), np.int32)
    g, t = np.arange(32) // 4, np.arange(32) % 4
    for b in range(p.row_blocks):
        for r in range(p.cluster):
            for w in range(ql.WARPS):
                tile, ks = w % p.tiles_per_cta, w // p.tiles_per_cta
                for c in range(p.chunks_per_warp):
                    base = r * p.span + (ks * p.chunks_per_warp + c) * ql.CHUNK
                    assert base - r * p.span + ql.CHUNK <= p.span  # inside the staged x
                    rows = b * p.rows + tile * 16 + np.stack([g, g + 8])[:, :, None]
                    cols = (base + 16 * t)[None, :, None] + np.arange(16)[None, None, :]
                    np.add.at(reads, (np.broadcast_to(rows, (2, 32, 16)),
                                      np.broadcast_to(cols, (2, 32, 16))), 1)
    assert (reads[:n, :rb] == 1).all()  # each weight byte once
    assert (reads <= 1).all()
    # every output row written once, by one rank of one cluster
    own = p.rows // p.cluster
    assert own * p.cluster == p.rows
    written = np.zeros(p.row_blocks * p.rows, np.int32)
    for b in range(p.row_blocks):
        for r in range(p.cluster):
            written[b * p.rows + r * own: b * p.rows + (r + 1) * own] += 1
    assert (written == 1).all()


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("n,k", FRAME_NK + [ODD_NK])
def test_plan_split_and_order_do_not_depend_on_m(n, k, fmt):
    """Tiling, K split, cluster and grid (and so the order of every sum) are
    the same at every M in 1..32; only the staged rows of x (8, 16 or 32)
    and the shared memory follow M."""
    packed = FORMATS[fmt]
    fixed = None
    for m in range(1, ql.MAX_ROWS + 1):
        p = ql.launch_plan(m, n, k, packed)
        key = (p.rows, p.tiles_per_cta, p.k_warps, p.cluster, p.chunks_per_warp, p.span,
               p.x_extent, p.grid)
        fixed = fixed or key
        assert key == fixed, m
        assert p.x_rows == (8 if m <= 8 else 16 if m <= 16 else 32)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("n,k", FRAME_NK + [ODD_NK])
def test_plan_shared_memory_fits_a_block(n, k, fmt):
    for m in range(1, ql.MAX_ROWS + 1):
        p = ql.launch_plan(m, n, k, FORMATS[fmt])
        staged = p.x_rows * (p.x_extent + 8) * 2
        partial = p.k_warps * p.x_rows * p.rows * 4
        assert p.smem == staged + partial <= ql.MAX_SMEM_BYTES
        assert p.x_extent <= ql.MAX_X_EXTENT and p.chunks_per_warp <= ql.MAX_CHUNKS_WARP


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("n,k", BACKBONE_NK)
def test_plan_fills_the_card_on_backbone_shapes(n, k, fmt):
    """At least 128 CTAs (about one per SM of the H100's 132) with a portable
    cluster (at most 8 CTAs: 16 needs a non-portable opt-in)."""
    p = ql.launch_plan(16, n, k, FORMATS[fmt])
    assert p.grid >= ql.TARGET_CTAS
    assert p.cluster in (1, 2, 4, 8) and p.cluster <= ql.MAX_CLUSTER


def test_plan_rejects_rows_of_x_it_cannot_take():
    for m in (0, ql.MAX_ROWS + 1):
        with pytest.raises(ValueError, match="rows of x"):
            ql.launch_plan(m, 4096, 1024, False)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("n,k", [(64, 4096), (48, 200), ODD_NK])
def test_kernel_arithmetic_in_the_plans_order_matches_plain(n, k, fmt):
    """The kernel's sum, emulated in float64 in the plan's order (each warp's
    chunks with the in-chunk K permutation, the warps' K slices, the
    cluster's ranks), equals the plain version's product: the permutation
    and the split cover K exactly once, and int4's two halves meet the
    right half of x."""
    packed = FORMATS[fmt]
    g = torch.Generator().manual_seed(n + k)
    w = quantize_array(torch.randn(n, k, generator=g), bits=4 if packed else 8)
    x = torch.randn(3, k, generator=g, dtype=torch.float64)
    rb = _row_bytes(k, packed)
    q = w.q.numpy().astype(np.int64)
    lo = (q & 0xF) - 8 if packed else q
    hi = (q >> 4) - 8 if packed else None
    p = ql.launch_plan(3, n, k, packed)
    acc = np.zeros((p.row_blocks * p.rows, 3))
    xs = x.numpy()
    for r in range(p.cluster):
        for ks in range(p.k_warps):
            for c in range(p.chunks_per_warp):
                base = r * p.span + (ks * p.chunks_per_warp + c) * ql.CHUNK
                for t in range(4):
                    for s in range(4):  # MMA s of the chunk: bytes 16 t + 4 s .. + 3
                        for e in range(4):
                            j = base + 16 * t + 4 * s + e
                            if j >= rb:
                                continue
                            acc[:n] += np.outer(lo[:, j], xs[:, j])
                            if packed:
                                acc[:n] += np.outer(hi[:, j], xs[:, rb + j])
    want = x @ QTensor(w.q, w.scale.double()).dequant().T  # q * scale in float64
    got = acc[:n].T * w.scale.double().numpy()
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-9, atol=1e-9)


# -- the f32 (CUDA-core) route: kernels.qlinear.launch_plan_f32 --------------------
#
# The kernel's index arithmetic (csrc/qlinear.cu, ``qlinear_f32_kernel``):
# CTA c, warp w (K slice ks = w % k_warps, row group w // k_warps), lane
# (rg = lane // lanes_per_row, l = lane % lanes_per_row) owns row c * rows +
# (w // k_warps) * rows_per_warp + rg and, for chunk i < chunks_per_lane, the
# 16 bytes at ((i * k_warps + ks) * lanes_per_row + l) * 16 of it.

# (N, K): the flow net's in_w, final_ada_w, final_w, a backbone shape (the f32
# reference model's ff2), an odd shape, and the widest rows the kernel takes
F32_NK = [(512, 32), (1024, 512), (32, 512), (1024, 4096), ODD_NK, (8, 4096)]


def _f32_slices(p):
    """Arrays (row, first byte, K slice, lane of the row) of every 16-byte
    slice a lane loads, one entry per (CTA, warp, lane, chunk)."""
    c, w, lane, i = np.meshgrid(np.arange(p.grid), np.arange(p.warps), np.arange(32),
                                np.arange(p.chunks_per_lane), indexing="ij")
    ks, group = w % p.k_warps, w // p.k_warps
    rg, lane_l = lane // p.lanes_per_row, lane % p.lanes_per_row
    row = c * p.rows + group * p.rows_per_warp + rg
    off = ((i * p.k_warps + ks) * p.lanes_per_row + lane_l) * 16
    return row.ravel(), off.ravel(), ks.ravel(), lane_l.ravel()


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("n,k", F32_NK)
def test_f32_plan_covers_every_row_and_k_byte_once(n, k, fmt):
    packed = FORMATS[fmt]
    p = ql.launch_plan_f32(n, k, packed)
    rb = _row_bytes(k, packed)
    assert p.rows_per_warp * p.lanes_per_row == 32
    assert p.rows == p.warps // p.k_warps * p.rows_per_warp and p.warps % p.k_warps == 0
    assert p.grid == -(-n // p.rows) and p.warps in ql.F32_WARPS
    reads = np.zeros((p.grid * p.rows, p.chunks_per_lane * p.k_warps * p.lanes_per_row * 16),
                     np.int32)
    row, off, _, _ = _f32_slices(p)
    for b in range(16):
        np.add.at(reads, (row, off + b), 1)
    assert (reads[:n, :rb] == 1).all()  # each weight byte once
    assert (reads <= 1).all()
    # every output row is finished by one CTA (K slice 0 and the combine)
    owners = np.zeros(p.grid * p.rows, np.int32)
    for c in range(p.grid):
        owners[c * p.rows:(c + 1) * p.rows] += 1
    assert (owners == 1).all()
    # every K slice has bytes of the row (none wholly past it)
    assert (p.k_warps - 1) * p.lanes_per_row * 16 < rb


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("n,k", F32_NK + FRAME_NK)
def test_f32_plan_fits_shared_memory_at_every_m(n, k, fmt):
    """The plan takes no M (its split and order are M's for every M); only the
    staged rows of x and the slices' partial sums grow with M, and fit."""
    p = ql.launch_plan_f32(n, k, FORMATS[fmt])
    step_x = p.k_warps * p.lanes_per_row * 16 * (2 if FORMATS[fmt] else 1)
    assert p.x_extent == p.tile_chunks * step_x <= ql.F32_MAX_X_EXTENT
    assert 1 <= p.tile_chunks <= p.chunks_per_lane <= ql.F32_MAX_CHUNKS
    sizes = [p.smem(m) for m in range(1, ql.MAX_ROWS + 1)]
    assert sizes == sorted(sizes) and sizes[-1] <= ql.MAX_SMEM_BYTES


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_f32_plan_spreads_the_flow_net_shapes(fmt):
    """Short rows share a warp and a small N splits K: final_ada_w reaches
    ~128 CTAs, final_w's 32 rows split K across warps (int8: over more than
    the 4 CTAs one warp a row gave), and in_w's rows of 16 / 32 bytes leave
    no lane without a slice."""
    packed = FORMATS[fmt]
    assert ql.launch_plan_f32(1024, 512, packed).grid >= ql.TARGET_CTAS
    final = ql.launch_plan_f32(32, 512, packed)
    assert final.k_warps > 1 and (packed or final.grid > 4)
    p = ql.launch_plan_f32(512, 32, packed)
    assert p.lanes_per_row * p.chunks_per_lane * p.k_warps * 16 == _row_bytes(32, packed)


def test_f32_plan_rejects_rows_it_cannot_take():
    with pytest.raises(ValueError, match="at most|1-4096"):
        ql.launch_plan_f32(8, 8192, False)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("n,k", [(512, 32), (1024, 512), (32, 512), ODD_NK, (1024, 4096)])
def test_f32_kernel_arithmetic_in_the_plans_order_matches_plain(n, k, fmt):
    """The f32 route's sum, emulated in float64 in the plan's order (each
    lane's chunks and bytes, int4's low half against x[:, j] and high half
    against x[:, K/2 + j], the row's lanes, the K slices in order), equals
    the plain product."""
    packed = FORMATS[fmt]
    g = torch.Generator().manual_seed(n + k + 1)
    w = quantize_array(torch.randn(n, k, generator=g), bits=4 if packed else 8)
    x = torch.randn(3, k, generator=g, dtype=torch.float64).numpy()
    rb = _row_bytes(k, packed)
    q = w.q.numpy().astype(np.int64)
    lo = (q & 0xF) - 8 if packed else q
    hi = (q >> 4) - 8 if packed else None
    p = ql.launch_plan_f32(n, k, packed)
    # [row, K slice, lane of the row] partial sums, each over its chunks in order
    part = np.zeros((p.grid * p.rows, p.k_warps, p.lanes_per_row, 3))
    row, off, ks, lane_l = _f32_slices(p)
    for b in range(16):  # the slice's bytes in order
        j = off + b
        keep = (row < n) & (j < rb)
        r, jk, at = row[keep], j[keep], (row[keep], ks[keep], lane_l[keep])
        np.add.at(part, at, lo[r, jk][:, None] * x[:, jk].T)
        if packed:
            np.add.at(part, at, hi[r, jk][:, None] * x[:, rb + jk].T)
    acc = part.sum(axis=2)  # the butterfly over the row's lanes
    total = sum(acc[:, s] for s in range(p.k_warps))  # the K slices, slice 0 first
    got = total[:n].T * w.scale.double().numpy()
    want = x @ QTensor(w.q, w.scale.double()).dequant().T.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
