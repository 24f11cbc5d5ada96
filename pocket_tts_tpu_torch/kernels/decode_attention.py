"""Decode attention of the FlowLM backbone: the hand-written Hopper kernel of
``csrc/decode_attention.cu`` (it replaces XLA's fusion of the K/V convert
into the attention dot, ``pocket_tts_tpu/ops/attention.py:28-48``, reached
from ``causal_cache_attention`` at ``:82-100``; there is no Pallas kernel
behind it).

``decode_attention(q, k_cache, v_cache, pos)`` is ``causal_cache_attention``
at T = 1: q [B, 1, H, D] (bfloat16 or float32) at position ``pos[b]``
against the first ``min(pos[b] + 1, S)`` positions of the caches [B, S, H,
D] (float32, bfloat16, float8_e4m3fn or float8_e5m2).

* CPU tensors run :func:`decode_attention_reference`, the plain version
  (``ops.sdpa.sdpa`` with the causal mask, as before the kernel).
* CUDA tensors launch the kernel as :func:`launch_plan` says: the live keys
  split over logical ranks by :func:`rank_split`, taken by a thread-block
  cluster of one CTA a rank (a small B x H) or by one CTA alone per (b, h);
  ``decode_attention.launches`` counts the launches.  A CUDA call the kernel cannot take (another dtype, a head width
  whose rows are not 16 x a power of two bytes, S over
  :data:`MAX_POSITIONS`, strides) raises, as does a call under autograd.

``ops.attention.causal_cache_attention`` sends every T = 1 call here and
counts its T > 1 calls on CUDA (prefills) in ``decode_attention.large_t``.
:func:`error_bound` is the per-element bound within which the kernel must
agree with the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import threading

import torch

from pocket_tts_tpu_torch.kernels import build as build_mod
from pocket_tts_tpu_torch.ops.sdpa import FP8_DTYPES, sdpa

SOURCE = build_mod.PKG / "csrc" / "decode_attention.cu"
WARPS = 4  # warps of a team, which takes one logical rank at a time (kWarps)
THREADS = 32 * WARPS  # threads of a team (kThreads)
SOLO_TEAMS = 4  # teams of a CTA that takes a (b, h) alone (kSoloTeams)
MAX_CLUSTER = 8  # CTAs per (b, h), the portable cluster size, and logical ranks (kMaxCluster)
MIN_KEYS_PER_RANK = 128  # keys a logical rank takes before the next one joins
CTA_TARGET = 256  # the most CTAs a launch of clusters takes (launch_plan)
RING_BYTES = 64 * 1024  # K/V staging of a cluster CTA (kRingBytes)
RING_STAGES = 4  # ring depth where the tiles do not fit at once (kRingStages)
MAX_POSITIONS = 8192  # kMaxPositions
MAX_DIM = 256  # kMaxDim
MAX_SMEM_BYTES = 227 * 1024  # dynamic shared memory a CTA may opt into (kMaxSmem)
Q_KINDS = {torch.float32: 0, torch.bfloat16: 1}
KV_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}

_lock = threading.Lock()
_count_lock = threading.Lock()  # launches come from several threads of a server
_lib = None


def build():
    """Compile ``csrc/decode_attention.cu`` (see :func:`kernels.build.build`)."""
    return build_mod.build(SOURCE, "decode_attention")


def _bind(lib):
    """``lib.pt_decode_attention`` with its C signature."""
    fn = lib.pt_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
    return _lib


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch.  The order: :func:`rank_split` gives each of ``ranks``
    logical ranks its keys (at least ``min_keys`` a rank, at most
    ``keys_per_rank``); a team of :data:`WARPS` warps takes a rank, lane
    (seg, l) of warp w the keys ``j0 + w * keys_per_warp + seg + m *
    keys_per_step`` of rank [j0, j1) in order for its V row,
    ``lanes_per_key`` lanes a key's row, 16 bytes each.

    The schedule: ``cluster`` = ``ranks``: ``grid`` = B x H x ranks CTAs of
    :data:`THREADS` threads in clusters of ``ranks`` (cluster ``b * H + h``
    for lane b, head h; CTA r takes rank r), each rank's keys through tiles
    of ``tile`` keys, K tiles then V tiles, tile i in ring buffer i %
    ``stages``; within a tile lane (seg, l) of warp w takes key ``jt0 + w *
    keys_per_warp + seg``, jt0 in steps of ``keys_per_step``.  ``cluster`` =
    1: ``grid`` = B x H CTAs alone of ``teams`` teams (``threads``), team t
    the ranks t, t + teams, ...; the K and V rows read straight into
    registers (``tile``, ``stages`` 0).  ``smem`` bytes of dynamic shared
    memory.

    ``ranks``, ``min_keys``, ``keys_per_rank`` and the lanes' layout, which
    fix the order of every sum, depend on (S, D, the cache type) alone; the
    schedule follows B x H and never changes a bit of the output."""

    grid: int
    cluster: int
    ranks: int
    min_keys: int
    teams: int
    threads: int
    lanes_per_key: int
    keys_per_warp: int
    keys_per_step: int
    values_per_lane: int
    keys_per_rank: int
    tile: int
    stages: int
    smem: int


def recv_floats(d: int, ranks: int) -> int:
    """Floats of the partial rows pushed to one cluster CTA, for any R <=
    ranks ranks with keys (``recv_floats`` of the ``.cu``)."""
    return -(-WARPS * (d + ranks - 1) // 4) * 4


def solo_bytes(room: int, d: int, slots: int) -> int:
    """Shared bytes of the CTA-alone body (``solo_floats`` of the ``.cu``):
    the logits of ``room`` keys, ``slots`` ranks' (rank, warp) rows, the
    warps' maxima and the ranks' warps' sums."""
    return (-(-room // 4) * 4 + slots * WARPS * d + (SOLO_TEAMS + MAX_CLUSTER) * WARPS) * 4


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, s: int, h: int, d: int, dtypes: tuple, cluster: int | None = None,
                min_keys: int = MIN_KEYS_PER_RANK, teams: int | None = None) -> LaunchPlan:
    """The launch for q [b, 1, h, d] against caches [b, s, h, d]; ``dtypes``
    = (q's dtype, the caches' dtype).  ``cluster``: ``ranks`` (a cluster of
    one CTA a rank) while b x h x ranks <= CTA_TARGET (a short batch:
    latency rules), else 1 (a CTA alone per (b, h): bytes rule); the other
    value gives the same outputs, bit for bit.  ``teams``: teams of the CTA
    alone, by default min(ranks, SOLO_TEAMS) (1 in a cluster).
    ``min_keys``: the keys a logical rank takes before the next joins (a
    change of it changes the order).  No card needed; raises ValueError for
    a call the kernel does not take."""
    q_dtype, kv_dtype = dtypes
    if q_dtype not in Q_KINDS or kv_dtype not in KV_KINDS:
        raise ValueError(f"decode_attention: q {q_dtype} with a {kv_dtype} cache; the kernel "
                         f"takes q {sorted(map(str, Q_KINDS))} and caches "
                         f"{sorted(map(str, KV_KINDS))}")
    if b < 1 or h < 1 or not 1 <= s <= MAX_POSITIONS:
        raise ValueError(f"decode_attention: B={b} H={h} S={s}; the kernel takes 1 <= S <= "
                         f"{MAX_POSITIONS} positions")
    es = kv_dtype.itemsize
    row = d * es
    lanes, rem = divmod(row, 16)
    if rem or not 1 <= lanes <= 32 or lanes & (lanes - 1) or d > MAX_DIM:
        raise ValueError(f"decode_attention: rows of D={d} x {es} bytes; the kernel takes "
                         f"16 x a power of two up to 512 bytes and D <= {MAX_DIM}")
    kpw = 32 // lanes
    kps = WARPS * kpw
    ranks = min(MAX_CLUSTER, -(-s // min_keys))
    if cluster is None:
        cluster = ranks if b * h * ranks <= CTA_TARGET else 1
    if cluster not in (1, ranks):
        raise ValueError(f"decode_attention: a cluster of {cluster} CTAs over {ranks} ranks; "
                         f"the kernel takes one CTA a rank or a CTA alone")
    solo = cluster == 1
    most = min(ranks, SOLO_TEAMS) if solo else 1
    teams = most if teams is None else teams
    if not 1 <= teams <= most:
        raise ValueError(f"decode_attention: {teams} teams a CTA in clusters of {cluster}")
    # the largest share rank_split gives a rank at any n <= s
    kpr = max(min(s, min_keys), -(-s // ranks))
    if solo:  # no staging: the logits, the (rank, warp) rows, the reductions
        tile, stages = 0, 0
        smem = solo_bytes(s, d, ranks)
    else:
        if 2 * kpr * row <= RING_BYTES:  # a rank's K and V: one buffer each
            tile, stages = kpr, 2
        else:  # whole steps of keys a tile, through a ring
            tile, stages = RING_BYTES // (RING_STAGES * row) // kps * kps, RING_STAGES
        smem = stages * tile * row + (-(-kpr // 4) * 4 + recv_floats(d, ranks) + 2 * WARPS
                                      + 2 * MAX_CLUSTER) * 4 + 3 * 8
        # a lone rank (a short cache) goes through the CTA-alone body
        smem = max(smem, solo_bytes(kpr, d, 1))
    return LaunchPlan(grid=b * h * cluster, cluster=cluster, ranks=ranks, min_keys=min_keys,
                      teams=teams, threads=THREADS * teams, lanes_per_key=lanes,
                      keys_per_warp=kpw, keys_per_step=kps, values_per_lane=16 // es,
                      keys_per_rank=kpr, tile=tile, stages=stages, smem=smem)


def rank_split(n: int, ranks: int, min_keys: int = MIN_KEYS_PER_RANK) -> list[tuple[int, int]]:
    """Keys [j0, j1) of each of ``ranks`` logical ranks for n live keys, as
    the kernel splits them: the first R = min(ranks, ceil(n / min_keys))
    take [r n / R, (r + 1) n / R); the others none."""
    busy = min(ranks, -(-n // min_keys))
    return [(r * n // busy, (r + 1) * n // busy) if r < busy else (n, n)
            for r in range(ranks)]


def decode_attention_reference(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                               pos: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``sdpa`` of q [B, 1, H, D] against the whole
    cache with keys ``j <= pos[b]`` visible (every key when pos >= S)."""
    s = k_cache.shape[1]
    mask = torch.arange(s, device=q.device)[None, :] <= pos.long()[:, None]  # [B, S]
    return sdpa(q, k_cache, v_cache, mask[:, None, None, :])


_U = 2.0 ** -24  # unit roundoff of float32


def _gamma(n):
    """Bound on the relative error of an f32 sum of n terms in any order."""
    return n * _U / (1 - n * _U)


def error_bound(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                pos: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per-element bound [B, 1, H, D] on |kernel - plain| for outputs ``ref``
    of the plain version; two f32 evaluations of the function in different
    orders stay within it.

    f32 q: 1e-5 max(1, max|ref|), the sums run in another order.

    bf16 q, derived from the inputs in float64 (n keys visible, u = 2^-24,
    gamma_m = m u / (1 - m u)):

    * each side's f32 probability p_j lies within eta of the exact p^_j,
      eta = 2 gamma_D max_j sum_i |q_i k_ji| / sqrt(D) (the logits' dot
      products, the max shift cancelling) + gamma_n (the softmax sum) + 64 u
      (exp, the scale, the shift, the division);
    * rounding to bf16 is monotone, so both sides' rounded p_j lie in
      [lo_j, hi_j] = bf16(p^_j (1 -+ eta)), nearly always one value;
    * the weighted sums differ by at most A = sum_j (hi_j - lo_j) |v_j|
      plus 2 gamma_n sum_j hi_j |v_j| for their f32 accumulation;
    * each side rounds its output to bf16 once: one bf16 ulp of |ref| (1 +
      2^-7) + A on top.

    A kernel that drops one key of a long row or scales its output is far
    outside it (tests/test_torch_decode_attention.py)."""
    if q.dtype != torch.bfloat16:
        return torch.full_like(ref, 1e-5 * max(1.0, ref.float().abs().max().item()),
                               dtype=torch.float64)
    s, d = k_cache.shape[1], q.shape[-1]

    def widened(c):  # the values the plain version multiplies
        return (c if c.dtype in FP8_DTYPES else c.to(q.dtype)).double()

    k, v, q0 = widened(k_cache), widened(v_cache), q[:, 0].double()
    n = (pos.long() + 1).clamp(max=s).double()  # [B]
    visible = (torch.arange(s, device=q.device)[None, :] < n[:, None])[:, None]  # [B, 1, S]
    logit = torch.einsum("bhd,bshd->bhs", q0, k) / math.sqrt(d)
    p = torch.softmax(logit.masked_fill(~visible, -math.inf), dim=-1)  # [B, H, S]
    mags = torch.einsum("bhd,bshd->bhs", q0.abs(), k.abs()) / math.sqrt(d)
    eta = (2 * _gamma(d) * mags.masked_fill(~visible, 0).amax(-1)
           + _gamma(n)[:, None] + 64 * _U)[..., None]  # [B, H, 1]

    def rounded(x):  # f64 -> f32 -> bf16: each step monotone
        return x.float().to(torch.bfloat16).double()

    lo, hi = rounded(p * (1 - eta)), rounded(p * (1 + eta))
    va = v.abs()
    a = (torch.einsum("bhs,bshd->bhd", hi - lo, va)
         + 2 * _gamma(n)[:, None, None] * torch.einsum("bhs,bshd->bhd", hi, va))
    top = ref[:, 0].double().abs() * (1 + 2.0 ** -7) + a
    ulp = torch.exp2(torch.floor(torch.log2(top.clamp(min=2.0 ** -126))) - 7)
    return (a + ulp)[:, None]


def _check(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           pos: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.shape != v_cache.shape or k_cache.dim() != 4:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches {tuple(k_cache.shape)} "
                         f"/ {tuple(v_cache.shape)}; the kernel takes q [B, 1, H, D] and two "
                         f"caches [B, S, H, D]")
    b, _, h, d = q.shape
    if k_cache.shape[0] != b or k_cache.shape[2:] != (h, d) or tuple(pos.shape) != (b,):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}, pos {tuple(pos.shape)} do not agree")
    if k_cache.dtype != v_cache.dtype or pos.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"decode_attention: caches {k_cache.dtype} / {v_cache.dtype}, pos "
                        f"{pos.dtype}; the kernel takes one cache dtype and int32 / int64 pos")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache), ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {q.device}")
    es = k_cache.dtype.itemsize
    inner = (h * d, d, 1)
    if (k_cache.stride()[1:] != inner or v_cache.stride() != k_cache.stride()
            or q.stride(3) != 1 or (k_cache.stride(0) * es) % 16
            or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16 or not pos.is_contiguous()):
        raise ValueError(f"decode_attention: strides q {q.stride()} k {k_cache.stride()} "
                         f"v {v_cache.stride()}; the kernel takes caches with [S, H, D] "
                         f"contiguous, one 16-byte aligned batch stride, and D contiguous in q")


def _launch(lib, q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            pos: torch.Tensor, plan: LaunchPlan) -> torch.Tensor:
    """One launch of ``lib``'s kernel as ``plan`` (a :func:`launch_plan` of
    these shapes) says, on q's current stream; raises if the launch fails.
    Counts nothing; the tests and scripts/ time and compare plans with it."""
    b, _, h, d = q.shape
    s = k_cache.shape[1]
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
            int(pos.dtype == torch.int64), out.data_ptr(), b, s, h, d, q.stride(0), q.stride(2),
            k_cache.stride(0), Q_KINDS[q.dtype], KV_KINDS[k_cache.dtype], plan.cluster,
            plan.ranks, plan.min_keys, plan.teams, plan.lanes_per_key, plan.keys_per_rank,
            plan.tile, plan.stages, plan.smem, 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention: CUDA launch failed with error {err} (B={b} S={s} "
                           f"H={h} D={d} q {q.dtype} cache {k_cache.dtype}, grid {plan.grid} in "
                           f"clusters of {plan.cluster}, {plan.smem} bytes of shared memory)")
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """Attention of q [B, 1, H, D] at positions ``pos`` [B] against the caches
    [B, S, H, D] -> [B, 1, H, D] in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, pos)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k_cache.requires_grad
                                    or v_cache.requires_grad):
        # the launch goes through raw pointers: its output has no grad_fn
        raise RuntimeError("decode_attention: the CUDA kernel has no backward; under autograd "
                           "call the plain version, "
                           "kernels.decode_attention.decode_attention_reference")
    _check(q, k_cache, v_cache, pos)
    b, _, h, d = q.shape
    plan = launch_plan(b, k_cache.shape[1], h, d, (q.dtype, k_cache.dtype))
    out = _launch(_load(), q, k_cache, v_cache, pos, plan)
    with _count_lock:
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
decode_attention.large_t = 0


def count_large_t() -> None:
    """One more T > 1 call on CUDA, sent to the plain ``sdpa`` by the shape
    rule of ``ops.attention.causal_cache_attention``."""
    with _count_lock:
        decode_attention.large_t += 1
