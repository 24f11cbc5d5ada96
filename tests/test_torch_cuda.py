"""Tests that run only on an NVIDIA GPU: the port's CUDA kernels (sm_90a,
built with nvcc; a CUDA kernel has no CPU mode) and the voice encoder on the
card against its CPU run.  Without a card they skip.

This file imports no JAX (the GPU machine has none), so it runs there with
the JAX-importing tests/conftest.py left out:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from pocket_tts_tpu_torch.kernels import flow_blocks as fb

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _blocks(device, seed, dim=512, depth=6):
    g = torch.Generator().manual_seed(seed)
    bound = dim ** -0.5
    blocks = {
        "ada_w": (torch.rand(depth, 3 * dim, dim, generator=g) * 2 - 1) * bound,
        "ada_b": torch.randn(depth, 3 * dim, generator=g) * 0.1,
        "ln_w": 1 + torch.randn(depth, dim, generator=g) * 0.1,
        "ln_b": torch.randn(depth, dim, generator=g) * 0.1,
        "mlp1_w": (torch.rand(depth, dim, dim, generator=g) * 2 - 1) * bound,
        "mlp1_b": torch.randn(depth, dim, generator=g) * 0.1,
        "mlp2_w": (torch.rand(depth, dim, dim, generator=g) * 2 - 1) * bound,
        "mlp2_b": torch.randn(depth, dim, generator=g) * 0.1,
    }
    return {k: v.to(device) for k, v in blocks.items()}, g


def _inputs(g, batch, dim, device):
    sy = torch.nn.functional.silu(torch.randn(batch, dim, generator=g)).to(device)
    return sy, torch.randn(batch, dim, generator=g).to(device)


# (batch, dim, depth): the flagship at the main path's and the batcher's B,
# B = 3 and the largest B of the earlier multi-launch design (113), the widest dim at depth 1,
# a streamed (ring) shape, and the small test config's width
KERNEL_SHAPES = [(1, 512, 6), (3, 512, 6), (4, 512, 6), (16, 512, 6), (113, 512, 6),
                 (16, 1024, 1), (4, 1024, 6), (1, 64, 3), (16, 64, 3)]


@pytest.mark.parametrize("batch,dim,depth", KERNEL_SHAPES)
def test_flow_blocks_kernel_matches_plain_on_cuda(cuda_device, batch, dim, depth):
    """1e-4: both sides accumulate f32 in different orders over `depth`
    chained dim-wide products."""
    blocks, g = _blocks(cuda_device, batch, dim, depth)
    sy, h0 = _inputs(g, batch, dim, cuda_device)
    launches = fb.flow_blocks.launches
    got = fb.flow_blocks(sy, h0, blocks)
    torch.cuda.synchronize()
    assert fb.flow_blocks.launches == launches + 1
    ref = fb.flow_blocks_reference(sy, h0, blocks)
    assert (got - ref).abs().max().item() <= 1e-4


def test_flow_blocks_lane_is_bit_identical_at_any_batch(cuda_device):
    """A lane's result does not depend on B or on the other lanes: the same
    row alone (B = 1) and at every position of a B = 16 batch, bit for bit."""
    blocks, g = _blocks(cuda_device, 7)
    sy, h0 = _inputs(g, 16, 512, cuda_device)
    batched = fb.flow_blocks(sy, h0, blocks)
    for b in (0, 5, 15):
        alone = fb.flow_blocks(sy[b:b + 1].contiguous(), h0[b:b + 1].contiguous(), blocks)
        assert torch.equal(alone[0], batched[b])
    assert torch.equal(fb.flow_blocks(sy, h0, blocks), batched)  # run to run


def test_flow_blocks_cuda_graph_replays_eager(cuda_device):
    """One call captured in a CUDA graph (a cooperative launch) replays to the
    eager result."""
    blocks, g = _blocks(cuda_device, 8)
    sy, h0 = _inputs(g, 4, 512, cuda_device)
    eager = fb.flow_blocks(sy, h0, blocks)
    fb.flow_blocks(sy, h0, blocks)  # plan and library ready before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fb.flow_blocks(sy, h0, blocks)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_flow_blocks_raises_on_cuda_input_it_cannot_take(cuda_device):
    """On CUDA the wrapper launches the kernel or raises: never the plain path."""
    blocks, g = _blocks(cuda_device, 0)
    sy = torch.randn(1, 512, generator=g).to(cuda_device)
    launches = fb.flow_blocks.launches
    with pytest.raises(TypeError, match="float32"):
        fb.flow_blocks(sy.bfloat16(), sy, blocks)
    with pytest.raises(ValueError, match="on cpu"):
        fb.flow_blocks(sy, sy.cpu(), blocks)
    assert fb.flow_blocks.launches == launches


def _small_config(runtime):
    """The small config of tests/test_tts.py (this file imports no JAX)."""
    from pocket_tts_tpu_torch import config as c

    return c.Config(
        flow_lm=c.FlowLMConfig(
            flow=c.FlowConfig(dim=48, depth=2),
            transformer=c.TransformerConfig(d_model=64, num_heads=4, num_layers=2,
                                            hidden_scale=2),
            lookup_table=c.LookupTableConfig(dim=64, n_bins=4000)),
        mimi=c.MimiConfig(
            seanet=c.SEANetConfig(dimension=32, n_filters=4),
            transformer=c.MimiTransformerConfig(d_model=32, input_dimension=32,
                                                output_dimensions=(32,), num_heads=4,
                                                num_layers=2, context=48, dim_feedforward=64),
            quantizer=c.QuantizerConfig(dimension=16, output_dimension=32)),
        runtime=runtime)


@pytest.mark.parametrize("seconds", [1.5, 3.3])  # one-shot, chunked
def test_voice_encoder_on_cuda_matches_cpu(cuda_device, seconds):
    """The voice encoder (Mimi encoder + speaker projection, float32) on the
    card against the same model on the CPU, at a small config whose encode
    buckets send 3.3 s down the chunked path.  1e-4: f32 on both sides, TF32
    off, sums in another order."""
    import numpy as np

    from pocket_tts_tpu_torch import config as c
    from pocket_tts_tpu_torch import weights
    from pocket_tts_tpu_torch.runtime.engine import Engine

    cfg = _small_config(c.RuntimeConfig(encode_seconds_buckets=(1.0, 2.0),
                                        voice_prompt_chunk_frames=8))
    torch.backends.cudnn.allow_tf32 = False
    params = weights.from_state_dict(weights.random_state_dict(cfg, 0), cfg)
    wav = (np.random.default_rng(1).standard_normal(int(seconds * 24000)) * 0.1
           ).astype(np.float32)
    got, n = Engine(cfg, params, cuda_device).encode_voice(wav)
    ref, n_ref = Engine(cfg, params, "cpu").encode_voice(wav)
    assert got.device.type == "cuda" and n == n_ref == -(-wav.size // 1920)
    assert (got.cpu() - ref).abs().max().item() <= 1e-4


def test_batcher_matches_single_stream_on_cuda(cuda_device):
    """A B = 4 ContinuousBatcher on the card in float32, four concurrent
    requests with their own lsd step count and noise clamp at temp 0, each
    against the port's single stream on the card.  1e-4 in float audio (3.3
    int16 LSB): f32 on both sides, TF32 off, lanes at B = 4 summed in another
    order than at B = 1.  Every flow evaluation is one kernel launch."""
    from pocket_tts_tpu_torch import config as c
    from pocket_tts_tpu_torch import weights
    from pocket_tts_tpu_torch.runtime.batcher import ContinuousBatcher
    from pocket_tts_tpu_torch.runtime.engine import GenParams
    from pocket_tts_tpu_torch.tts import TTSModel

    torch.backends.cudnn.allow_tf32 = False
    cfg = _small_config(c.RuntimeConfig(compute_dtype="float32", decode_chunks=(2, 4, 8)))
    params = weights.from_state_dict(weights.random_state_dict(cfg, 3), cfg)
    base = GenParams(temp=0.0, eos_threshold=float("inf"))
    model = TTSModel(cfg, params, gen=base, has_real_weights=False, device=cuda_device)
    texts = ["First request on the card.", "Second one, two steps.",
             "Third with a noise clamp.", "Fourth [pause:100ms] after a pause."]
    gens = [base, GenParams(temp=0.0, eos_threshold=float("inf"), lsd_decode_steps=2),
            GenParams(temp=0.0, eos_threshold=float("inf"), noise_clamp=0.5), base]
    singles = []
    for text, gen in zip(texts, gens):
        model.gen = gen
        singles.append(model.generate_with_pauses(text))
    model.gen = base
    b = ContinuousBatcher(model, batch_size=4, chunk_frames=4)
    b.start()
    try:
        launches, evals = fb.flow_blocks.launches, b.engine.flow_evals
        results = b.generate_batch(texts, gens=gens)
        assert fb.flow_blocks.launches - launches == b.engine.flow_evals - evals > 0
    finally:
        b.stop()
    for got, want in zip(results, singles):
        assert got.shape == want.shape and got.size > 0
        assert abs(got - want).max() <= 1e-4
