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


SMEM_LIMIT = 232_448  # shared memory one CTA may use on Hopper


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("depth", [1, 3, 6])
@pytest.mark.parametrize("dim", [64, 512, 1024])
@pytest.mark.parametrize("batch", [1, 3, 4, 16, 64, 113])
def test_launch_plan(batch, dim, depth, sms):
    """The cooperative launch's plan, as the kernel reads it: each output row
    of each stage and each modulation row has exactly one CTA, the batch
    tiles cover 0..B once, the shared memory fits, and the weights stay
    resident exactly when all 2 * depth slices fit beside the modulation
    ring and one group of lanes."""
    plan = fb.launch_plan(batch, dim, depth, sms)
    assert 1 <= plan.grid <= sms and plan.stages == 2 * depth
    owners = [0] * dim
    for cta in range(plan.grid):
        for row in range(cta * plan.rows, min((cta + 1) * plan.rows, dim)):
            owners[row] += 1
    assert owners == [1] * dim
    lanes = [0] * batch
    for b0 in range(0, batch, plan.tile):
        for b in range(b0, min(b0 + plan.tile, batch)):
            lanes[b] += 1
    assert lanes == [1] * batch
    assert plan.group == min(8, 1 << (batch - 1).bit_length())
    assert plan.tile % plan.group == 0
    assert plan.group <= plan.tile <= -(-batch // plan.group) * plan.group
    mod_owners = [0] * (3 * dim)  # of each block's modulation rows
    for cta in range(plan.grid):
        for row in range(cta * plan.mrows, min((cta + 1) * plan.mrows, 3 * dim)):
            mod_owners[row] += 1
    assert mod_owners == [1] * (3 * dim)
    assert plan.mrows % 4 == 0  # the bias copies stay 16-byte aligned
    bars = lambda n: (n * 8 + 15) // 16 * 16  # noqa: E731 - one mbarrier per slot
    # a modulation chunk holds 8 rows and their 8 biases
    slice_bytes, chunk_bytes, lane_bytes = plan.rows * dim * 4, 8 * (dim + 1) * 4, 2 * dim * 4
    assert plan.smem == (bars(plan.slots + plan.mslots) + plan.slots * slice_bytes
                         + plan.mslots * chunk_bytes + plan.tile * lane_bytes)
    assert plan.smem <= SMEM_LIMIT
    per_block = -(-plan.mrows // 8)
    ring = min(2, per_block)
    fits = (bars(2 * depth + ring) + 2 * depth * slice_bytes + ring * chunk_bytes
            + plan.group * lane_bytes <= SMEM_LIMIT)
    assert plan.resident == fits
    assert 1 <= plan.mslots <= 2 * per_block
    assert plan.mslots >= ring or not fits
    assert 1 <= plan.slots <= (2 * depth if fits else 4)


def test_launch_plan_takes_every_batch_up_to_113():
    """Every B <= 113 at dim 512 (the earlier multi-launch design's limit) is
    accepted at the flagship depth, with the weights resident."""
    for sms in (114, 132):
        for batch in range(1, 114):
            plan = fb.launch_plan(batch, 512, 6, sms)
            assert plan.resident and plan.smem <= SMEM_LIMIT
