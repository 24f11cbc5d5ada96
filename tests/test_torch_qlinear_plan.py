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
