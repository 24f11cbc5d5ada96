"""Flow net of the port (kernels.flow_blocks + models.flow_mlp) against the JAX
package: the Pallas kernel in interpret mode and the XLA flow_step, on the
same numpy weights and inputs (dim 64, depth 3, B in {1, 4}).  Tolerance
1e-5, the bound tests/test_pallas.py uses for the Pallas kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu.config import FlowConfig
from pocket_tts_tpu.models import flow_mlp as jflow
from pocket_tts_tpu.ops.pallas.flow_kernel import flow_blocks as jax_flow_blocks
from pocket_tts_tpu.ops.pallas.flow_kernel import flow_step_pallas
from pocket_tts_tpu_torch.kernels import flow_blocks as fb
from pocket_tts_tpu_torch.models import flow_mlp as tflow

torch.set_num_threads(1)
TOL = 1e-5


def _params():
    p = jflow.init_params(jax.random.PRNGKey(0), FlowConfig(dim=64, depth=3), ldim=16,
                          cond_dim=32)
    rng = np.random.default_rng(0)
    # non-trivial norms and biases (the init has ones / zeros there)
    blocks = dict(p["blocks"])
    for k in ("ln_w", "ln_b", "mlp1_b", "mlp2_b", "ada_b"):
        blocks[k] = jnp.asarray(rng.standard_normal(blocks[k].shape).astype(np.float32) * 0.3)
    p = {**p, "blocks": blocks}
    return p, jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), p)


@pytest.fixture(scope="module")
def params():
    return _params()


def _inputs(batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, 64)).astype(np.float32),
            rng.standard_normal((batch, 16)).astype(np.float32))


@pytest.mark.parametrize("batch", [1, 4])
def test_flow_blocks_reference_matches_pallas_interpret(params, batch):
    jp, tp = params
    rng = np.random.default_rng(batch)
    sy = rng.standard_normal((batch, 64)).astype(np.float32)
    h0 = rng.standard_normal((batch, 64)).astype(np.float32)
    ref = jax_flow_blocks(jnp.asarray(sy), jnp.asarray(h0), jp["blocks"], interpret=True)
    got = fb.flow_blocks_reference(torch.from_numpy(sy), torch.from_numpy(h0), tp["blocks"])
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= TOL


@pytest.mark.parametrize("batch", [1, 4])
def test_flow_step_matches_pallas_and_xla(params, batch):
    jp, tp = params
    y, x = _inputs(batch, 10 + batch)
    launches = fb.flow_blocks.launches
    got = tflow.flow_step(tp, torch.from_numpy(y), torch.from_numpy(x)).numpy()
    assert fb.flow_blocks.launches == launches  # CPU tensors never reach the kernel
    for ref in (flow_step_pallas(jp, jnp.asarray(y), jnp.asarray(x), interpret=True),
                jflow.flow_step(jp, jnp.asarray(y), jnp.asarray(x))):
        assert got.shape == ref.shape
        assert np.abs(got - np.asarray(ref)).max() <= TOL


@pytest.mark.parametrize("steps", [1, 2])
def test_lsd_decode_matches(params, steps):
    jp, tp = params
    rng = np.random.default_rng(20 + steps)
    cond = rng.standard_normal((2, 32)).astype(np.float32)
    noise = rng.standard_normal((2, 16)).astype(np.float32)
    jtab = jflow.time_embedding_table(jp, steps)
    ttab = tflow.time_embedding_table(tp, steps)
    assert np.abs(ttab.numpy() - np.asarray(jtab)).max() <= TOL
    ref = jflow.lsd_decode(jp, jflow.embed_condition(jp, jnp.asarray(cond)), jtab,
                           jnp.asarray(noise), steps, use_pallas=False)
    got = tflow.lsd_decode(tp, tflow.embed_condition(tp, torch.from_numpy(cond)), ttab,
                           torch.from_numpy(noise), steps)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= TOL


def test_wrapper_rejects_what_the_kernel_cannot_take(params):
    _, tp = params
    blocks = tp["blocks"]
    sy, h0 = torch.zeros(2, 64), torch.zeros(2, 64)
    assert fb._check(sy, h0, blocks) == (2, 64, 3)
    with pytest.raises(TypeError, match="float32"):
        fb._check(sy.bfloat16(), h0, blocks)
    with pytest.raises(ValueError, match="contiguous"):
        fb._check(sy, h0, {**blocks, "mlp1_w": blocks["mlp1_w"].transpose(1, 2)})
    with pytest.raises(ValueError, match="shape"):
        fb._check(sy, torch.zeros(3, 64), blocks)
    with pytest.raises(ValueError, match="device"):
        fb.flow_blocks(sy.to("meta"), h0, blocks)
