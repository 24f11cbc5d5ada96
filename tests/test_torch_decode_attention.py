"""Decode attention (``kernels/decode_attention.py``) on the CPU: the T = 1
route of ``causal_cache_attention`` against the JAX package's on the same
numpy inputs, the kernel's ``launch_plan``, and the kernel's summation order
emulated in float64 against the plain version (the kernel itself runs only
on the card, tests/test_torch_cuda.py).

The index arithmetic below is the kernel's (csrc/decode_attention.cu): CTA
b * H + h; lane (seg, l) of warp w holds bytes [16 l, 16 l + 16) of the row
of key ``j0 + u * keys_per_step + w * keys_per_warp + seg``, u < UNROLL, j0
in steps of ``keys_per_pass``; the softmax sums run per thread over keys
``t, t + 256, ...``, the warps added in order; the V rows per lane over its
keys in order, then the warp's segments, then the warps in order.
"""

import math

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
# narrow caches, an odd S and a narrow head
PLAN_CASES = [(1, 1024, 16, 64, torch.bfloat16), (16, 1024, 16, 64, torch.float8_e4m3fn),
              (32, 1024, 16, 64, torch.float32), (3, 300, 3, 32, torch.float8_e5m2),
              (2, 8192, 2, 256, torch.bfloat16)]


@pytest.mark.parametrize("b,s,h,d,kv", PLAN_CASES)
def test_plan_covers_every_lane_and_head_once(b, s, h, d, kv):
    q_dtype = torch.float32 if kv == torch.float32 else torch.bfloat16
    p = da.launch_plan(b, s, h, d, (q_dtype, kv))
    assert p.grid == b * h
    seen = np.zeros((b, h), np.int32)
    for cta in range(p.grid):
        seen[cta // h, cta % h] += 1
    assert (seen == 1).all()
    # a key row is lanes_per_key 16-byte slices; the segments tile the warp
    assert p.lanes_per_key * 16 == d * kv.itemsize and 32 % p.lanes_per_key == 0
    assert p.keys_per_warp * p.lanes_per_key == 32
    assert p.keys_per_step == da.WARPS * p.keys_per_warp
    assert p.keys_per_pass == da.UNROLL * p.keys_per_step
    assert p.values_per_lane * p.lanes_per_key == d


@pytest.mark.parametrize("b,s,h,d,kv", PLAN_CASES)
def test_plan_shared_memory_fits_and_does_not_depend_on_b(b, s, h, d, kv):
    q_dtype = torch.float32 if kv == torch.float32 else torch.bfloat16
    p = da.launch_plan(b, s, h, d, (q_dtype, kv))
    assert p.smem == (s + da.WARPS * d + 2 * da.WARPS) * 4 <= da.MAX_SMEM_BYTES
    for other in (1, 4, 16, 64):
        o = da.launch_plan(other, s, h, d, (q_dtype, kv))
        assert o.grid == other * h
        assert {**vars(o), "grid": 0} == {**vars(p), "grid": 0}


def test_plan_constants_match_the_kernel_source():
    """The plan's constants are the kernel's: the warps of a CTA, the loads in
    flight a lane and the limits (the per-call tiling, lanes a key, keys a
    warp and shared bytes, goes to the launch from launch_plan)."""
    src = da.SOURCE.read_text()
    for name, value in (("kWarps", da.WARPS), ("kUnroll", da.UNROLL),
                        ("kMaxPositions", da.MAX_POSITIONS), ("kMaxDim", da.MAX_DIM)):
        assert f"constexpr int {name} = {value};" in src
    assert f"smem > {da.MAX_SMEM_BYTES // 1024} * 1024" in src
    assert "int lpk, int kpw, int smem, float scale" in src


def test_plan_refuses_what_the_kernel_cannot_take():
    bf = (torch.bfloat16, torch.bfloat16)
    with pytest.raises(ValueError, match="positions"):
        da.launch_plan(1, da.MAX_POSITIONS + 1, 16, 64, bf)
    with pytest.raises(ValueError, match="power of two"):
        da.launch_plan(1, 1024, 16, 24, bf)  # 48-byte rows: 3 lanes
    with pytest.raises(ValueError, match="power of two"):
        da.launch_plan(1, 1024, 16, 4, (torch.bfloat16, torch.float8_e4m3fn))  # 4 bytes
    with pytest.raises(ValueError, match="float16"):
        da.launch_plan(1, 1024, 16, 64, (torch.float16, torch.bfloat16))
    assert da.launch_plan(1, da.MAX_POSITIONS, 16, 64, bf).smem <= da.MAX_SMEM_BYTES


def _bf16(x):
    """float64 -> float32 -> bfloat16 -> float64, as the kernel rounds."""
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(np.float64)


def _kernel_order(p, q, k, v, n, round_p=False):
    """One (b, h) of the kernel in float64, in its order: q [D], k/v [S, D];
    ``round_p``: the probabilities rounded to bf16 (a bf16 q)."""
    lpk, vpl, kpw = p.lanes_per_key, p.values_per_lane, p.keys_per_warp
    logit = np.full(n, np.nan)
    written = np.zeros(n, np.int32)
    keys = {}  # (warp, seg) -> its keys in the order it visits them
    for j0 in range(0, n, p.keys_per_pass):
        for u in range(da.UNROLL):
            for w in range(da.WARPS):
                for seg in range(kpw):
                    j = j0 + u * p.keys_per_step + w * kpw + seg
                    if j >= n:
                        continue
                    keys.setdefault((w, seg), []).append(j)
                    parts = [q[l * vpl:(l + 1) * vpl] @ k[j, l * vpl:(l + 1) * vpl]
                             for l in range(lpk)]
                    logit[j] = sum(parts) / math.sqrt(q.size)
                    written[j] += 1
    assert (written == 1).all()  # every live key once, none past n
    mx = logit.max()
    e = np.exp(logit - mx)
    per_thread = [e[t::da.THREADS].sum() for t in range(da.THREADS)]
    total = sum(sum(per_thread[w * 32:(w + 1) * 32]) for w in range(da.WARPS))
    prob = e / total
    if round_p:
        prob = _bf16(prob)
    part = np.zeros((da.WARPS, q.size))
    for (w, seg), js in keys.items():
        assert js == sorted(js)
        for l in range(lpk):
            sl = slice(l * vpl, (l + 1) * vpl)
            acc = np.zeros(vpl)
            for j in js:
                acc += prob[j] * v[j, sl]
            part[w, sl] += acc  # the segments' butterfly
    return sum(part[w] for w in range(da.WARPS))


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.float8_e4m3fn, torch.float32])
def test_kernel_order_matches_plain(kv):
    """The kernel's order (key assignment, per-thread softmax sums, the warps'
    partial rows and their fixed combine), emulated in float64, equals the
    plain version in float32 within f32 rounding, for pos 0, 1, 255, 1023
    and past S."""
    b, s, h, d = 5, 1024, 2, 64
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pos = np.array([0, 1, 255, 1023, 1500], np.int32)
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
    element by element, for pos 0, 1, 255, 1023 and past S."""
    b, s, h, d = 5, 1024, 2, 64
    q, k, v, pos = _bf16_case(b, s, h, d, cache, [0, 1, 255, 1023, 1500], seed=11)
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
