"""Tests of the port's CUDA kernels, which run only on an NVIDIA GPU (sm_90a)
with nvcc: a CUDA kernel has no CPU mode.  Without a card they skip.

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


def _flagship_blocks(device, seed):
    g = torch.Generator().manual_seed(seed)
    dim, depth = 512, 6
    blocks = {
        "ada_w": torch.rand(depth, 3 * dim, dim, generator=g) * 0.088 - 0.044,
        "ada_b": torch.randn(depth, 3 * dim, generator=g) * 0.1,
        "ln_w": 1 + torch.randn(depth, dim, generator=g) * 0.1,
        "ln_b": torch.randn(depth, dim, generator=g) * 0.1,
        "mlp1_w": torch.rand(depth, dim, dim, generator=g) * 0.088 - 0.044,
        "mlp1_b": torch.randn(depth, dim, generator=g) * 0.1,
        "mlp2_w": torch.rand(depth, dim, dim, generator=g) * 0.088 - 0.044,
        "mlp2_b": torch.randn(depth, dim, generator=g) * 0.1,
    }
    return {k: v.to(device) for k, v in blocks.items()}, g


@pytest.mark.parametrize("batch", [1, 16])
def test_flow_blocks_kernel_matches_plain_on_cuda(cuda_device, batch):
    """Flagship dims (dim 512, depth 6).  1e-4: both sides accumulate f32 in
    different orders over 6 chained 512-wide products."""
    blocks, g = _flagship_blocks(cuda_device, batch)
    sy = torch.nn.functional.silu(torch.randn(batch, 512, generator=g)).to(cuda_device)
    h0 = torch.randn(batch, 512, generator=g).to(cuda_device)
    launches = fb.flow_blocks.launches
    got = fb.flow_blocks(sy, h0, blocks)
    torch.cuda.synchronize()
    assert fb.flow_blocks.launches == launches + 1
    ref = fb.flow_blocks_reference(sy, h0, blocks)
    assert (got - ref).abs().max().item() <= 1e-4


def test_flow_blocks_raises_on_cuda_input_it_cannot_take(cuda_device):
    """On CUDA the wrapper launches the kernel or raises: never the plain path."""
    blocks, g = _flagship_blocks(cuda_device, 0)
    sy = torch.randn(1, 512, generator=g).to(cuda_device)
    launches = fb.flow_blocks.launches
    with pytest.raises(TypeError, match="float32"):
        fb.flow_blocks(sy.bfloat16(), sy, blocks)
    with pytest.raises(ValueError, match="on cpu"):
        fb.flow_blocks(sy, sy.cpu(), blocks)
    assert fb.flow_blocks.launches == launches
