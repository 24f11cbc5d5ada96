"""Tests of the LFM2-MoE backbone that run only on an NVIDIA GPU: the routed
expert kernels (``csrc/moe.cu``) against their plain versions at LFM2-8B-A1B's
widths, the grouped-query route of the decode-attention kernel, and one
chunk of ``decode_frames`` on the backbone under
``torch.cuda.set_sync_debug_mode("error")``.  Without a card they skip.

This file imports no JAX, so it runs on the card machine with the
JAX-importing tests/conftest.py left out:

    python -m pytest --noconftest tests/test_torch_lfm2_cuda.py -m cuda -q
"""

import math

import numpy as np
import pytest
import torch

from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.config import config_from_dict
from pocket_tts_tpu_torch.kernels import decode_attention as da
from pocket_tts_tpu_torch.kernels import moe
from pocket_tts_tpu_torch.runtime.engine import GenParams
from pocket_tts_tpu_torch.tts import TTSModel

pytestmark = pytest.mark.cuda

D, F, E, K = 2048, 1792, 32, 4  # LFM2-8B-A1B: hidden, expert width, experts, top-k


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def bank(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(11)
    up = ((torch.rand(E, 2 * F, D, generator=g, device=cuda_device) * 2 - 1) / math.sqrt(D))
    down = ((torch.rand(E, D, F, generator=g, device=cuda_device) * 2 - 1) / math.sqrt(F))
    router = (torch.rand(E, D, generator=g, device=cuda_device) * 2 - 1) / math.sqrt(D)
    bias = (torch.rand(E, generator=g, device=cuda_device) * 2 - 1) * 0.05
    return up.bfloat16(), down.bfloat16(), router, bias, g


def _tokens(g, m, device):
    return torch.randn(m, D, generator=g, device=device).bfloat16()


@pytest.mark.parametrize("m", [1, 3, 40, 700])
def test_moe_kernels_match_plain_on_cuda(cuda_device, bank, m):
    """Router: the same picks and weights within 1e-5 (f32 sums in another
    order; a pick may differ only where two biased scores tie within that).
    Experts: both sum in float32 and round once to bf16, so they differ by at
    most one bf16 ulp where a sum lies near a rounding edge (2^-7 relative at
    most) plus the sum order (1e-4 of the row's scale)."""
    up, down, router, bias, g = bank
    x = _tokens(g, m, cuda_device)
    slots = torch.zeros(E, dtype=torch.int64, device=cuda_device)
    launches = (moe.route.launches, moe.experts.launches)
    ids, w = moe.route(x, router, bias, K, slots=slots)
    pids, pw = moe.route_reference(x, router, bias, K)
    same = (ids.sort(-1).values == pids.sort(-1).values).all(-1)
    assert same.float().mean().item() > 0.99
    assert torch.allclose(w.sort(-1).values[same], pw.sort(-1).values[same], atol=1e-5)
    assert int(slots.sum()) == m * K
    y = moe.experts(x, pids, pw, up, down)
    torch.cuda.synchronize()
    assert moe.route.launches == launches[0] + 1
    assert moe.experts.launches == launches[1] + 2 * math.ceil(m / moe.MAX_TOKENS)
    want = torch.cat([moe.experts_reference(x[i:i + 8], pids[i:i + 8], pw[i:i + 8], up, down)
                      for i in range(0, m, 8)]).float()  # the plain gather, 8 tokens at a time
    scale = want.abs().amax(-1, keepdim=True)
    assert ((y.float() - want).abs() <= want.abs() * 2 ** -7 + 1e-4 * scale).all()


def test_moe_token_alone_equals_the_token_in_a_batch(cuda_device, bank):
    up, down, router, bias, g = bank
    x = _tokens(g, 16, cuda_device)
    ids, w = moe.route(x, router, bias, K)
    batched = moe.experts(x, ids, w, up, down)
    for t in (0, 7, 15):
        alone = moe.experts(x[t:t + 1], ids[t:t + 1].contiguous(), w[t:t + 1].contiguous(),
                            up, down)
        assert torch.equal(alone[0], batched[t])
    assert torch.equal(moe.experts(x, ids, w, up, down), batched)  # run to run


@pytest.mark.parametrize("b", [1, 3])
def test_gqa_decode_attention_matches_plain_on_cuda(cuda_device, b):
    """32 query heads over 8 KV heads, head dim 64, S 1024, within the
    kernel's own bound against the plain version on the widened cache."""
    g = torch.Generator(device=cuda_device).manual_seed(b)
    q = torch.randn(b, 1, 32, 64, generator=g, device=cuda_device).bfloat16()
    kc = torch.randn(b, 1024, 8, 64, generator=g, device=cuda_device).bfloat16()
    vc = torch.randn(b, 1024, 8, 64, generator=g, device=cuda_device).bfloat16()
    for p in (0, 130, 1023):
        pos = torch.full((b,), p, dtype=torch.int32, device=cuda_device)
        got = da.decode_attention_gqa(q, kc, vc, pos)
        ke, ve = da.expand_kv(kc, 32), da.expand_kv(vc, 32)
        want = da.decode_attention_reference(q, ke, ve, pos)
        bound = da.error_bound(q, ke, ve, pos, want)
        assert ((got.double() - want.double()).abs() <= bound).all(), p


def _small_model(device):
    """A 4-layer LFM2-MoE backbone at widths the kernels take (hidden 512,
    8 / 2 heads, experts of width 256), with Pocket's flow net and codec."""
    cfg = config_from_dict({
        "flow_lm": {"lookup_table": {"dim": 512},
                    "backbone": {"hidden_size": 512, "num_hidden_layers": 4,
                                 "num_attention_heads": 8, "num_key_value_heads": 2,
                                 "layer_types": ["conv", "conv", "full_attention", "conv"],
                                 "intermediate_size": 512, "moe_intermediate_size": 256,
                                 "num_experts": 8, "num_experts_per_tok": 2,
                                 "num_dense_layers": 2}},
        "runtime": {"max_seq": 512}})
    params = tweights.from_state_dict(tweights.random_state_dict(cfg, 3), cfg)
    return TTSModel(cfg, params, gen=GenParams(temp=0.7, eos_threshold=float("inf")),
                    has_real_weights=False, device=device, seed=0)


def test_lfm2_frame_step_makes_no_host_sync_on_cuda(cuda_device):
    """A chunk of ``decode_frames`` on the backbone (route, experts, conv
    state, GQA attention, flow net, codec) under sync debug mode "error":
    any device-to-host copy or wait inside it raises."""
    model = _small_model(cuda_device)
    eng = model.engine
    wav = (0.1 * np.random.default_rng(0).standard_normal(24000)).astype(np.float32)
    vs = model.get_voice_state_from_audio(wav)
    state = eng.prefill_tokens(eng.reset_for_segment(vs.as_dict()),
                               np.array([[5, 6, 7]], np.int32), 3)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state, _, _ = eng.decode_frames(state, 2, model.gen, gen)  # builds the kernels
    torch.cuda.synchronize()
    launches = moe.experts.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, audio, is_eos = eng.decode_frames(state, 2, model.gen, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert moe.experts.launches == launches + 2 * 2 * 2  # 2 frames x 2 MoE layers x 2
    assert audio.shape == (1, 2 * 1920) and is_eos.shape == (1, 2)
    assert int(eng.expert_slots.sum()) == 2 * 2 * (vs.length + 3 + 4)
