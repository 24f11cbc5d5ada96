"""Decode attention (``kernels/decode_attention.py``) on the CPU: the T = 1
route of ``causal_cache_attention`` against the JAX package's on the same
numpy inputs, the kernel's ``launch_plan``, and the kernel's summation order
emulated in float64 against the plain version (the kernel itself runs only
on the card, tests/test_torch_cuda.py).

The index arithmetic below is the kernel's (csrc/decode_attention.cu):
logical rank r taking keys [r n / R, (r + 1) n / R) of the R = min(ranks,
ceil(n / 128)) ranks with work, each by a team of 4 warps: lane (seg, l) of
warp w holds bytes [16 l, 16 l + 16) of the row of key ``j0 + w *
keys_per_warp + seg + m * keys_per_step`` of its rank for the V rows; a
rank's softmax sums run per thread over its keys ``t, t + 128, ...``, the
warps added in order, the ranks' maxima and sums read in rank order; the V
rows per lane over its keys in order, then the warp's segments, the (rank,
warp) rows added in order.  Two schedules run that order: a cluster of one
CTA a rank (ring tiles of ``tile`` keys) and a CTA alone per (b, h) whose
teams take the ranks in turn.
"""

import itertools
import math
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pocket_tts_tpu.ops import attention as jatt
from pocket_tts_tpu_torch.kernels import decode_attention as da
from pocket_tts_tpu_torch.ops import attention as tatt

torch.set_num_threads(1)

# cache dtype -> (torch dtype, JAX dtype, q dtype of the model that stores it)
CACHES = {
    "bfloat16": (torch.bfloat16, jnp.bfloat16, "bfloat16"),
    "float32": (torch.float32, jnp.float32, "float32"),
    "float8_e4m3fn": (torch.float8_e4m3fn, jnp.float8_e4m3fn, "bfloat16"),
    "float8_e5m2": (torch.float8_e5m2, jnp.float8_e5m2, "bfloat16"),
}
NP_DTYPES = {"bfloat16": ml_dtypes.bfloat16, "float32": np.float32,
             "float8_e4m3fn": ml_dtypes.float8_e4m3fn, "float8_e5m2": ml_dtypes.float8_e5m2}


def _case(b, s, h, d, cache, seed):
    """q, k, v as numpy arrays already rounded to their stored dtypes (so both
    packages start from the same values) and per-slot pos: 0, S - 1, S + 3
    (a full cache), then random."""
    rng = np.random.default_rng(seed)
    q_name = CACHES[cache][2]
    q = rng.standard_normal((b, 1, h, d)).astype(NP_DTYPES[q_name])
    k = rng.standard_normal((b, s, h, d)).astype(NP_DTYPES[cache])
    v = rng.standard_normal((b, s, h, d)).astype(NP_DTYPES[cache])
    pos = rng.integers(0, s, b).astype(np.int32)
    pos[:3] = [0, s - 1, s + 3][:b]
    return q, k, v, pos


def _torch(a, name):
    return torch.from_numpy(a.astype(np.float32)).to(CACHES[name][0])




@pytest.mark.parametrize("cache", sorted(CACHES))
def test_decode_route_matches_jax(cache):
    """causal_cache_attention at T = 1 (the route to the kernel; on the CPU
    its plain version) against JAX's, per-slot pos including 0, S - 1 and
    past S."""
    b, s, h, d = 5, 40, 3, 16
    q, k, v, pos = _case(b, s, h, d, cache, seed=len(cache))
    q_name = CACHES[cache][2]
    jdt = CACHES[cache][1]
    ref = jatt.causal_cache_attention(jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                      jnp.asarray(pos))
    ref = np.array(ref, np.float32)
    args = (_torch(q, q_name), _torch(k, cache), _torch(v, cache), torch.from_numpy(pos))
    got = tatt.causal_cache_attention(*args)
    assert got.dtype == CACHES[q_name][0] and got.shape == (b, 1, h, d)
    # each element within the kernel's own bound (da.error_bound): both are
    # f32 evaluations of the function in different orders
    bound = da.error_bound(*args, torch.from_numpy(ref)).numpy()
    assert (np.abs(got.double().numpy() - ref) <= bound).all()


def test_cpu_calls_never_touch_the_launch_counters():
    q, k, v, pos = _case(2, 16, 2, 16, "bfloat16", seed=1)
    launches, large = da.decode_attention.launches, da.decode_attention.large_t
    qt, kt, vt = _torch(q, "bfloat16"), _torch(k, "bfloat16"), _torch(v, "bfloat16")
    tatt.causal_cache_attention(qt, kt, vt, torch.from_numpy(pos))
    tatt.causal_cache_attention(qt.expand(2, 4, 2, 16), kt, vt, torch.from_numpy(pos))
    da.decode_attention(qt, kt, vt, torch.from_numpy(pos))
    assert (da.decode_attention.launches, da.decode_attention.large_t) == (launches, large)


# (B, S, H, D, cache dtype): the flagship's decode at B 1 / 16 / 32, and the
# narrow caches, an odd S, a ring of tiles and a narrow head
PLAN_CASES = [(1, 1024, 16, 64, torch.bfloat16), (16, 1024, 16, 64, torch.float8_e4m3fn),
              (32, 1024, 16, 64, torch.float32), (3, 300, 3, 32, torch.float8_e5m2),
              (2, 8192, 2, 256, torch.bfloat16)]


def _plan(b, s, h, d, kv):
    q_dtype = torch.float32 if kv == torch.float32 else torch.bfloat16
    return da.launch_plan(b, s, h, d, (q_dtype, kv))


@pytest.mark.parametrize("b,s,h,d,kv", PLAN_CASES)
def test_plan_covers_every_lane_and_head_once(b, s, h, d, kv):
    """Cluster b * H + h of ``cluster`` CTAs for each (b, h): one CTA a
    logical rank, or a CTA alone; the lanes of a warp tile its keys'
    rows."""
    p = _plan(b, s, h, d, kv)
    assert p.grid == b * h * p.cluster and p.cluster in (1, p.ranks) and p.ranks <= 8
    seen = np.zeros((b, h, p.cluster), np.int32)
    for cta in range(p.grid):
        bh, rank = divmod(cta, p.cluster)
        seen[bh // h, bh % h, rank] += 1
    assert (seen == 1).all()
    # a key row is lanes_per_key 16-byte slices; the segments tile the warp
    assert p.lanes_per_key * 16 == d * kv.itemsize and 32 % p.lanes_per_key == 0
    assert p.keys_per_warp * p.lanes_per_key == 32
    assert p.keys_per_step == da.WARPS * p.keys_per_warp
    assert p.threads == da.THREADS * p.teams
    assert p.teams == (min(p.ranks, da.SOLO_TEAMS) if p.cluster == 1 else 1)
    assert p.values_per_lane * p.lanes_per_key == d


def _smem(p, s, d, row):
    """A cluster CTA: the ring, the logits of its rank, the (rank, warp)
    partial rows it finishes (room for any number R <= ranks of ranks with
    keys: R x ceil(D / R) columns <= D + ranks - 1), the warps' maxima and
    sums, every rank's max and sum, three 8-byte barriers, or what the
    CTA-alone body takes for a lone rank if more.  A CTA alone: the logits
    of all S keys, every (rank, warp) row, the maxima of up to SOLO_TEAMS
    teams' warps and the ranks' warps' sums."""
    def alone(room, slots):
        return 4 * (-(-room // 4) * 4 + slots * da.WARPS * d
                    + (da.SOLO_TEAMS + da.MAX_CLUSTER) * da.WARPS)

    if p.cluster == 1:
        return alone(s, p.ranks)
    recv = da.recv_floats(d, p.ranks)
    assert all(r * da.WARPS * -(-d // r) <= recv for r in range(1, p.ranks + 1))
    staged = p.stages * p.tile * row + 4 * (-(-p.keys_per_rank // 4) * 4 + recv + 2 * da.WARPS
                                            + 2 * da.MAX_CLUSTER) + 3 * 8
    return max(staged, alone(p.keys_per_rank, 1))


ORDER_FIELDS = ("ranks", "min_keys", "lanes_per_key", "keys_per_warp", "keys_per_step",
                "values_per_lane", "keys_per_rank")


@pytest.mark.parametrize("b,s,h,d,kv", PLAN_CASES)
def test_plan_shared_memory_fits_and_does_not_depend_on_b(b, s, h, d, kv):
    """The ring, the logits, the pushed rows and the reductions within the
    opt-in limit for both schedules; in a cluster a rank's whole share in
    two buffers where its K and V fit in RING_BYTES, else a ring of
    RING_STAGES tiles of whole key steps; a CTA alone stages nothing.  What
    fixes the order (the logical ranks, their largest share, the lanes'
    layout) is the same at every B; only the schedule (a cluster while B x
    H x ranks <= CTA_TARGET, else a CTA alone), the grid and the staging
    follow B."""
    row = d * kv.itemsize
    q_dtype = torch.float32 if kv == torch.float32 else torch.bfloat16
    p = _plan(b, s, h, d, kv)
    for c in (1, p.ranks):
        o = da.launch_plan(b, s, h, d, (q_dtype, kv), cluster=c)
        assert o.smem == _smem(o, s, d, row) <= da.MAX_SMEM_BYTES and o.cluster == c
        if c == 1:
            assert (o.tile, o.stages) == (0, 0)
        elif 2 * o.keys_per_rank * row <= da.RING_BYTES:
            assert (o.tile, o.stages) == (o.keys_per_rank, 2)
        else:
            assert o.stages == da.RING_STAGES and o.tile % o.keys_per_step == 0
            assert o.tile < o.keys_per_rank and o.stages * o.tile * row <= da.RING_BYTES
    for other in (1, 4, 16, 64):
        o = _plan(other, s, h, d, kv)
        assert o.grid == other * h * o.cluster
        assert o.cluster == (o.ranks if other * h * o.ranks <= da.CTA_TARGET else 1)
        assert {f: getattr(o, f) for f in ORDER_FIELDS} == {f: getattr(p, f) for f in ORDER_FIELDS}


@pytest.mark.parametrize("s", [1, 7, 256, 1024, 8192])
def test_rank_split_reads_every_live_key_once(s):
    """For every n in 1..S: the logical ranks' keys tile [0, n) in rank
    order, each share at most keys_per_rank (the logits' room) and within a
    key of the even split; the first min(ranks, ceil(n / 128)) ranks have
    keys, the rest none."""
    for kv in (torch.bfloat16, torch.float32):
        p = _plan(1, s, 16, 64, kv)
        for n in range(1, s + 1):
            split = da.rank_split(n, p.ranks)
            assert len(split) == p.ranks
            busy = min(p.ranks, -(-n // da.MIN_KEYS_PER_RANK))
            ends = [j0 for j0, _ in split] + [n]
            assert ends[0] == 0 and all(a <= b for a, b in zip(ends, ends[1:]))
            assert all(split[r][1] == ends[r + 1] for r in range(p.ranks))
            sizes = [j1 - j0 for j0, j1 in split]
            assert all(size >= 1 for size in sizes[:busy]) and not any(sizes[busy:])
            assert max(sizes) - min(sizes[:busy]) <= 1 and max(sizes) <= p.keys_per_rank


def test_plan_main_path_is_a_cluster_that_fills_the_card():
    """S = 1024, H = 16, D = 64: at B = 1 clusters of 8, so the launch runs
    128 CTAs on the H100's 132 SMs, one rank each, its K and V (128 keys at
    most) in shared memory at once; at the batcher's B = 16 a CTA of 4
    teams (512 threads) alone per (b, h), 256 CTAs."""
    for kv in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2, torch.float32):
        p = _plan(1, 1024, 16, 64, kv)
        assert p.cluster == 8 and p.grid == 128 and p.keys_per_rank == 128 and p.ranks == 8
        assert (p.tile, p.stages) == (128, 2)
        p16 = _plan(16, 1024, 16, 64, kv)
        assert (p16.cluster, p16.grid, p16.teams, p16.threads) == (1, 256, 4, 512)


def test_plan_constants_match_the_kernel_source():
    """The plan's constants are the kernel's: the warps of a CTA, the cluster
    limit, the ring and the limits (the per-call tiling, the cluster and the
    keys a rank takes go to the launch from launch_plan)."""
    src = da.SOURCE.read_text()
    for name, value in (("kWarps", da.WARPS), ("kMaxCluster", da.MAX_CLUSTER),
                        ("kRingStages", da.RING_STAGES),
                        ("kMaxPositions", da.MAX_POSITIONS), ("kMaxDim", da.MAX_DIM)):
        assert f"constexpr int {name} = {value};" in src
    assert f"constexpr int kRingBytes = {da.RING_BYTES // 1024} * 1024;" in src
    assert f"constexpr int kMaxSmem = {da.MAX_SMEM_BYTES // 1024} * 1024;" in src
    assert f"constexpr int kSoloTeams = {da.SOLO_TEAMS};" in src
    assert "int kv_kind, int cs, int vr, int mk, int teams, int lpk,\n" in src
    assert "int kpr, int tile, int stages, int smem, float scale,\n" in src
    assert "cudaLaunchAttributeClusterDimension" in src
    # the same shared-memory layouts on both sides
    assert "  return (kWarps * (D + vr - 1) + 3) & ~3;" in src
    assert ("  return ((room + 3) & ~3) + slots * kWarps * D + (kSoloTeams + kMaxCluster) * "
            "kWarps;") in src


def test_plan_refuses_what_the_kernel_cannot_take():
    bf = (torch.bfloat16, torch.bfloat16)
    with pytest.raises(ValueError, match="positions"):
        da.launch_plan(1, da.MAX_POSITIONS + 1, 16, 64, bf)
    with pytest.raises(ValueError, match="power of two"):
        da.launch_plan(1, 1024, 16, 24, bf)  # 48-byte rows: 3 lanes
    with pytest.raises(ValueError, match="power of two"):
        da.launch_plan(1, 1024, 16, 4, (torch.bfloat16, torch.float8_e4m3fn))  # 4 bytes
    with pytest.raises(ValueError, match="power of two"):
        da.launch_plan(1, 1024, 16, 256, (torch.float32, torch.float32))  # 1024-byte rows
    with pytest.raises(ValueError, match="float16"):
        da.launch_plan(1, 1024, 16, 64, (torch.float16, torch.bfloat16))
    with pytest.raises(ValueError, match="cluster"):
        da.launch_plan(1, 1024, 16, 64, bf, cluster=9)
    with pytest.raises(ValueError, match="cluster"):
        da.launch_plan(1, 64, 16, 64, bf, cluster=4)  # one rank at S = 64
    with pytest.raises(ValueError, match="cluster"):
        da.launch_plan(1, 1024, 16, 64, bf, cluster=2)  # 8 ranks: 8 CTAs or 1
    with pytest.raises(ValueError, match="teams"):
        da.launch_plan(16, 1024, 16, 64, bf, teams=da.SOLO_TEAMS + 1)
    assert da.launch_plan(1, da.MAX_POSITIONS, 16, 64, bf).smem <= da.MAX_SMEM_BYTES


def _bf16(x):
    """float64 -> float32 -> bfloat16 -> float64, as the kernel rounds."""
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(np.float64)


def _rank_keys(p, n):
    """Each logical rank's keys as ``p``'s CTAs take them: for rank r (of
    rank_split), j0, its size and each (warp, seg)'s keys in order,
    relative to j0.  In a cluster CTA r takes rank r through tiles of
    ``p.tile`` keys (lane (seg, l) of warp w: tile key jt0 + w *
    keys_per_warp + seg, for the logits and the V rows alike); a CTA alone
    takes every key for the logits over the warps of all ``p.teams`` teams,
    and each team its ranks (t, t + teams, ...) for the V rows, lane (seg,
    l) of the team's warp w the rank's keys j0 + w * keys_per_warp + seg + m
    * keys_per_step.  Checks every live key is read once for its logit and
    once for its V row."""
    kpw, kps = p.keys_per_warp, p.keys_per_step
    split = [(j0, j1) for j0, j1 in da.rank_split(n, p.ranks, p.min_keys) if j1 > j0]
    logit_visits, v_visits = np.zeros(n, np.int32), np.zeros(n, np.int32)
    out = []
    if p.cluster == 1:
        for jt0 in range(0, n, p.teams * kps):
            for w, seg in itertools.product(range(p.teams * da.WARPS), range(kpw)):
                if jt0 + w * kpw + seg < n:
                    logit_visits[jt0 + w * kpw + seg] += 1
    for j0, j1 in split:
        size = j1 - j0
        assert size <= p.keys_per_rank
        keys = {}
        tile = p.tile if p.cluster > 1 else size
        for first in range(0, size, tile):  # the rank's tiles, K then V alike
            rows = min(tile, size - first)
            assert p.cluster == 1 or first % kps == 0  # a tile starts on a whole step
            for jt0 in range(0, rows, kps):
                for w, seg in itertools.product(range(da.WARPS), range(kpw)):
                    jt = jt0 + w * kpw + seg
                    if jt < rows:
                        keys.setdefault((w, seg), []).append(first + jt)
                        v_visits[j0 + first + jt] += 1
                        if p.cluster > 1:
                            logit_visits[j0 + first + jt] += 1
        out.append((j0, size, keys))
    assert (logit_visits == 1).all() and (v_visits == 1).all()  # every live key once
    return out


def _kernel_order(p, q, k, v, n, round_p=False):
    """One (b, h) of the kernel in float64, in its order: q [D], k/v [S, D];
    ``round_p``: the probabilities rounded to bf16 (a bf16 q).  Each logical
    rank's keys as :func:`_rank_keys` gives them; the logits per key (the
    lanes' slices added); the max over all; each rank's sum (per thread over
    keys t, t + THREADS, ..., the warps in order) added over the ranks in
    rank order; each warp's partial row over its keys in order, the rows
    added over (rank, warp) in order.  The ranks without keys take no
    part."""
    lpk, vpl = p.lanes_per_key, p.values_per_lane
    d = q.size
    ranks = _rank_keys(p, n)
    logits = []
    for j0, size, keys in ranks:
        logit = np.full(size, np.nan)
        for js in keys.values():
            for jl in js:
                parts = [q[l * vpl:(l + 1) * vpl] @ k[j0 + jl, l * vpl:(l + 1) * vpl]
                         for l in range(lpk)]
                logit[jl] = sum(parts) / math.sqrt(d)
        logits.append(logit)

    def block_sum(x):  # per thread, then the warp, then the warps in order
        per_thread = [x[t::da.THREADS].sum() for t in range(da.THREADS)]
        return sum(sum(per_thread[w * 32:(w + 1) * 32]) for w in range(da.WARPS))

    mx = max(logit.max() for logit in logits)
    es = [np.exp(logit - mx) for logit in logits]
    total = 0.0
    for e in es:  # rank order
        total += block_sum(e)
    out = np.zeros(d)
    for (j0, _, keys), e in zip(ranks, es):
        prob = e / total
        if round_p:
            prob = _bf16(prob)
        part = np.zeros((da.WARPS, d))
        for (w, seg), js in keys.items():
            assert js == sorted(js)
            for l in range(lpk):
                sl = slice(l * vpl, (l + 1) * vpl)
                acc = np.zeros(vpl)
                for jl in js:
                    acc += prob[jl] * v[j0 + jl, sl]
                part[w, sl] += acc  # the segments' butterfly
        for w in range(da.WARPS):  # (rank, warp) in order
            out += part[w]
    return out


@pytest.mark.parametrize("s,kv", [(1024, torch.bfloat16), (1024, torch.float32),
                                  (300, torch.float8_e5m2), (8192, torch.bfloat16)])
def test_kernel_order_does_not_depend_on_the_cluster(s, kv):
    """Each rank's keys, and the keys each (warp, seg) takes in order, are
    the same in a cluster (tiles through the ring at S = 8192) and in a CTA
    alone of any number of teams, so every sum runs in the same order at
    any B."""
    q_dtype = torch.float32 if kv == torch.float32 else torch.bfloat16
    base = da.launch_plan(1, s, 2, 64, (q_dtype, kv), cluster=1, teams=1)
    plans = [da.launch_plan(1, s, 2, 64, (q_dtype, kv), cluster=base.ranks)]
    plans += [da.launch_plan(1, s, 2, 64, (q_dtype, kv), cluster=1, teams=t)
              for t in range(2, min(base.ranks, da.SOLO_TEAMS) + 1)]
    for n in sorted({1, 2, 31, 32, 33, 100, 127, 128, 129, 255, 256, 257, s // 2, s - 1, s}):
        if not 1 <= n <= s:
            continue
        want = _rank_keys(base, n)
        for plan in plans:
            assert _rank_keys(plan, n) == want


# pos 0 .. 7, 31 .. 33 and 100 (one rank busy, the others idle), ranks
# joining at 128 keys (pos 127 / 128 / 129), and at 256 and 384 (255 / 256 /
# 257, 383 / 384 / 385), S - 1 and past S
ORDER_POS = [0, 1, 2, 3, 4, 5, 6, 7, 31, 32, 33, 100, 127, 128, 129, 255, 256, 257, 383, 384,
             385, 1023, 1500]


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.float8_e4m3fn, torch.float32])
def test_kernel_order_matches_plain(kv):
    """The kernel's order (the rank split, the CTAs' blocks and ring tiles,
    the key assignment, the cluster's max and sum in rank order, the (rank,
    warp) partial rows), emulated in float64, equals the plain version in float32
    within f32 rounding at pos that leave ranks idle, on a rank edge +- 1,
    255, 1023 and past S."""
    b, s, h, d = len(ORDER_POS), 1024, 2, 64
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pos = np.array(ORDER_POS, np.int32)
    p = da.launch_plan(b, s, h, d, (torch.float32, kv))
    ref = da.decode_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), torch.from_numpy(pos)).numpy()
    for bi in range(b):
        n = min(int(pos[bi]) + 1, s)
        for hi in range(h):
            got = _kernel_order(p, q[bi, 0, hi].astype(np.float64),
                                k[bi, :, hi].astype(np.float64), v[bi, :, hi].astype(np.float64),
                                n)
            np.testing.assert_allclose(got, ref[bi, 0, hi], rtol=0, atol=1e-5)


def test_kernel_order_streams_a_ring_of_tiles():
    """S = 8192: a rank's share (up to 1024 keys) streams through the ring of
    RING_STAGES tiles in a cluster of 8; that order, and a CTA alone's,
    equal the plain version at a full cache and on a rank edge."""
    b, s, h, d = 3, 8192, 1, 64
    rng = np.random.default_rng(8)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pos = np.array([8191, 1000, 255], np.int32)
    ref = da.decode_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), torch.from_numpy(pos)).numpy()
    for c in (8, 1):
        p = da.launch_plan(b, s, h, d, (torch.float32, torch.bfloat16), cluster=c)
        assert c == 1 or (p.stages == da.RING_STAGES and p.keys_per_rank > p.tile)
        for bi in range(b):
            got = _kernel_order(p, q[bi, 0, 0].astype(np.float64),
                                k[bi, :, 0].astype(np.float64), v[bi, :, 0].astype(np.float64),
                                min(int(pos[bi]) + 1, s))
            np.testing.assert_allclose(got, ref[bi, 0, 0], rtol=0, atol=1e-5)


def _bf16_case(b, s, h, d, cache, pos, seed):
    """bf16 q against a cache of ``cache``, torch tensors, from a seed."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d), np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d), np.float32)).to(CACHES[cache][0])
            for _ in range(2))
    return q, k, v, torch.tensor(pos, dtype=torch.int32)


BF16_CACHES = ["bfloat16", "float8_e4m3fn", "float8_e5m2"]


@pytest.mark.parametrize("cache", BF16_CACHES)
def test_kernel_order_in_bf16_within_error_bound(cache):
    """A bf16 q: the kernel's order in float64 with its probabilities and
    output rounded to bf16 stays within error_bound of the plain version,
    element by element, at every pos of ORDER_POS."""
    b, s, h, d = len(ORDER_POS), 1024, 2, 64
    q, k, v, pos = _bf16_case(b, s, h, d, cache, ORDER_POS, seed=11)
    p = da.launch_plan(b, s, h, d, (torch.bfloat16, k.dtype))
    ref = da.decode_attention_reference(q, k, v, pos)
    bound = da.error_bound(q, k, v, pos, ref).numpy()
    qd, kd, vd = (x.double().numpy() for x in (q, k, v))
    for bi in range(b):
        n = min(int(pos[bi]) + 1, s)
        for hi in range(h):
            got = _bf16(_kernel_order(p, qd[bi, 0, hi], kd[bi, :, hi], vd[bi, :, hi], n,
                                      round_p=True))
            assert (np.abs(got - ref[bi, 0, hi].double().numpy()) <= bound[bi, 0, hi]).all()


def _f32_other_order(q, k, v, pos):
    """The function in float32 in another order than the plain version's: the
    dot products from the last dimension down, the softmax sum from the last
    key down, the weighted sum key by key; probabilities and output rounded
    to bf16."""
    b, s, h, d = k.shape
    qf, kf, vf = q[:, 0].float(), k.float(), v.float()
    out = torch.empty(b, 1, h, d)
    for bi in range(b):
        n = min(int(pos[bi]) + 1, s)
        logit = torch.zeros(h, n)
        for i in reversed(range(d)):
            logit = logit + qf[bi, :, i, None] * kf[bi, :n, :, i].T
        logit = logit * (1 / math.sqrt(d))
        e = torch.exp(logit - logit.amax(-1, True))
        total = torch.zeros(h)
        for j in reversed(range(n)):
            total = total + e[:, j]
        prob = (e / total[:, None]).bfloat16().float()
        acc = torch.zeros(h, d)
        for j in range(n):
            acc = acc + prob[:, j, None] * vf[bi, j]
        out[bi, 0] = acc
    return out.bfloat16()


# the main path's S, H and D; pos 0, 1, mid, S - 1 and past S
BOUND_POS = [0, 1, 511, 1023, 1029]


@pytest.mark.parametrize("cache", BF16_CACHES)
def test_error_bound_holds_for_an_f32_evaluation_in_another_order(cache):
    q, k, v, pos = _bf16_case(5, 1024, 16, 64, cache, BOUND_POS, seed=12)
    ref = da.decode_attention_reference(q, k, v, pos)
    bound = da.error_bound(q, k, v, pos, ref)
    got = _f32_other_order(q, k, v, pos)
    assert ((got.double() - ref.double()).abs() <= bound).all()


@pytest.mark.parametrize("cache", BF16_CACHES)
def test_error_bound_rejects_wrong_outputs(cache):
    """The bound has teeth at the main path's shapes: the plain output with
    the query's own key dropped is outside it on every lane with 1 <= pos <
    S, and the output scaled by 0.98 on every lane."""
    q, k, v, pos = _bf16_case(5, 1024, 16, 64, cache, BOUND_POS, seed=13)
    ref = da.decode_attention_reference(q, k, v, pos)
    bound = da.error_bound(q, k, v, pos, ref)

    def rejected(wrong):
        return ((wrong.double() - ref.double()).abs() > bound).flatten(1).any(1).tolist()

    drop = da.decode_attention_reference(q, k, v, (pos - 1).clamp(min=0))
    assert rejected(drop) == [False, True, True, True, False]  # pos 0 and past S: no change
    assert all(rejected((ref.float() * 0.98).bfloat16()))


def test_probe_instruments_every_phase_of_the_kernel():
    """scripts/decode_attention_probe.py reads one clock64 mark per phase
    boundary: the kernel's source has marks 0 .. len(PHASES), each once and
    in order, compiled only under DA_PROBE, and the read-out the probe
    calls."""
    import importlib.util

    path = Path(__file__).resolve().parent.parent / "scripts" / "decode_attention_probe.py"
    spec = importlib.util.spec_from_file_location("decode_attention_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    src = da.SOURCE.read_text()
    body = src[src.index("decode_attention_kernel(const QT*"):src.index("struct Launch {")]
    at = [body.index("DA_ENTRY();")] + [body.index(f"DA_MARK({k});")
                                        for k in range(1, len(probe.PHASES) + 1)]
    assert at == sorted(at) and len(probe.PHASES) + 1 == 11
    assert all(body.count(f"DA_MARK({k});") == 1 for k in range(1, len(at)))
    assert "#ifdef DA_PROBE" in src and 'extern "C" int pt_probe_read' in src
    assert probe.probe_source(da.SOURCE).startswith("#define DA_PROBE 1\n")
