"""Port ops (pocket_tts_tpu_torch.ops) against the JAX package's ops on the
same numpy inputs, CPU float32.  Tolerance 1e-5 max abs: both sides run the
same float32 algorithm, so only summation order differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu.ops import attention as jatt
from pocket_tts_tpu.ops import conv as jconv
from pocket_tts_tpu.ops import norms as jnorms
from pocket_tts_tpu.ops import rope as jrope
from pocket_tts_tpu_torch.ops import attention as tatt
from pocket_tts_tpu_torch.ops import conv as tconv
from pocket_tts_tpu_torch.ops import norms as tnorms
from pocket_tts_tpu_torch.ops import rope as trope

torch.set_num_threads(1)
TOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, ref, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got.astype(np.float32) - ref.astype(np.float32)).max() <= tol


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm(affine):
    rng = _rng(1)
    x, w, b = _randn(rng, 3, 5, 24) * 3 + 1, _randn(rng, 24), _randn(rng, 24)
    args = (w, b) if affine else (None, None)
    ref = jnorms.layer_norm(jnp.asarray(x), *(None if a is None else jnp.asarray(a) for a in args),
                            eps=1e-6)
    got = tnorms.layer_norm(torch.from_numpy(x),
                            *(None if a is None else torch.from_numpy(a) for a in args), eps=1e-6)
    _close(got, ref)


def test_rms_norm_torchvar():
    rng = _rng(2)
    x, alpha = _randn(rng, 4, 32) + 0.5, _randn(rng, 32)
    ref = jnorms.rms_norm_torchvar(jnp.asarray(x), jnp.asarray(alpha))
    got = tnorms.rms_norm_torchvar(torch.from_numpy(x), torch.from_numpy(alpha))
    _close(got, ref)


def test_rope_per_batch_and_shared_tables():
    rng = _rng(3)
    x = _randn(rng, 2, 5, 3, 8)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    jc, js = jrope.rope_table(jnp.asarray(pos), 8, 10000.0)
    tc, ts = trope.rope_table(torch.from_numpy(pos), 8, 10000.0)
    _close(tc, jc)
    _close(ts, js)
    ref = jrope.apply_rope(jnp.asarray(x), jc[:, :, None, :], js[:, :, None, :])
    _close(trope.apply_rope(torch.from_numpy(x), tc[:, :, None, :], ts[:, :, None, :]), ref)
    # [T, D/2] tables broadcast over batch and heads
    ref = jrope.apply_rope(jnp.asarray(x), jc[1], js[1])
    _close(trope.apply_rope(torch.from_numpy(x), tc[1], ts[1]), ref)


def test_cache_write_clamps_like_dynamic_update_slice():
    rng = _rng(4)
    cache, new = _randn(rng, 2, 16, 2, 4), _randn(rng, 2, 3, 2, 4)
    start = np.array([2, 15], np.int32)  # 15 + 3 overruns: clamped to 13
    ref = jatt.cache_write(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(start))
    got = tatt.cache_write(torch.from_numpy(cache.copy()), torch.from_numpy(new),
                           torch.from_numpy(start))
    _close(got, ref, 0.0)


def test_prefill_write_drops_invalid_positions():
    rng = _rng(5)
    cache, new = _randn(rng, 2, 16, 2, 4), _randn(rng, 2, 5, 2, 4)
    start, t_valid = np.array([1, 12], np.int32), np.array([2, 5], np.int32)
    ref = jatt.prefill_write(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(start),
                             jnp.asarray(t_valid))
    got = tatt.prefill_write(torch.from_numpy(cache.copy()), torch.from_numpy(new),
                             torch.from_numpy(start), torch.from_numpy(t_valid))
    _close(got, ref, 0.0)


def test_causal_cache_attention():
    rng = _rng(6)
    q, kc, vc = _randn(rng, 2, 3, 2, 8), _randn(rng, 2, 12, 2, 8), _randn(rng, 2, 12, 2, 8)
    pos = np.array([0, 6], np.int32)
    ref = jatt.causal_cache_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                      jnp.asarray(pos))
    got = tatt.causal_cache_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                      torch.from_numpy(vc), torch.from_numpy(pos))
    _close(got, ref)


@pytest.mark.parametrize("t", [3, 10], ids=["t_le_block", "t_gt_block_padded"])
def test_tail_attention_both_branches(t):
    rng = _rng(7 + t)
    context, block = 6, 4
    q, k, v = (_randn(rng, 2, t, 2, 8) for _ in range(3))
    kt, vt = _randn(rng, 2, context - 1, 2, 8), _randn(rng, 2, context - 1, 2, 8)
    pos = np.array([0, 9], np.int32)  # slot 0: the whole tail is before position 0
    ref = jatt.tail_attention(*(jnp.asarray(a) for a in (q, k, v, kt, vt, pos)),
                              context, block=block)
    got = tatt.tail_attention(*(torch.from_numpy(a) for a in (q, k, v, kt, vt, pos)),
                              context, block=block)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("spec_kw", [
    dict(in_channels=3, out_channels=4, kernel_size=3, dilation=2),
    dict(in_channels=4, out_channels=6, kernel_size=4, stride=2, pad_mode="replicate",
         bias=False),
    dict(in_channels=4, out_channels=4, kernel_size=3, groups=2),
], ids=["dilated", "strided_replicate", "grouped"])
def test_streaming_conv1d_three_chunks(spec_kw):
    rng = _rng(8)
    jspec, tspec = jconv.ConvSpec(**spec_kw), tconv.ConvSpec(**spec_kw)
    w = _randn(rng, jspec.out_channels, jspec.in_channels // jspec.groups, jspec.kernel_size)
    b = _randn(rng, jspec.out_channels) if jspec.bias else None
    jst, tst = jconv.conv_init_state(jspec, 2), tconv.conv_init_state(tspec, 2)
    for _ in range(3):
        x = _randn(rng, 2, jspec.in_channels, 6)
        ry, jst = jconv.streaming_conv1d(jspec, jnp.asarray(w),
                                         None if b is None else jnp.asarray(b), jst,
                                         jnp.asarray(x))
        gy, tst = tconv.streaming_conv1d(tspec, torch.from_numpy(w),
                                         None if b is None else torch.from_numpy(b), tst,
                                         torch.from_numpy(x))
        _close(gy, ry)
        _close(tst["prev"], jst["prev"])


@pytest.mark.parametrize("groups", [1, 4])
def test_streaming_conv_transpose1d_three_chunks(groups):
    rng = _rng(9)
    kw = dict(in_channels=4, out_channels=4, kernel_size=6, stride=3, groups=groups)
    jspec, tspec = jconv.ConvTrSpec(**kw), tconv.ConvTrSpec(**kw)
    w, b = _randn(rng, 4, 4 // groups, 6), _randn(rng, 4)
    jst, tst = jconv.convtr_init_state(jspec, 2), tconv.convtr_init_state(tspec, 2)
    for _ in range(3):
        x = _randn(rng, 2, 4, 5)
        ry, jst = jconv.streaming_conv_transpose1d(jspec, jnp.asarray(w), jnp.asarray(b), jst,
                                                   jnp.asarray(x))
        gy, tst = tconv.streaming_conv_transpose1d(tspec, torch.from_numpy(w),
                                                   torch.from_numpy(b), tst,
                                                   torch.from_numpy(x))
        _close(gy, ry)
        _close(tst["partial"], jst["partial"])
