"""Port models (FlowLM prefill + steps, Mimi streaming decode, weights
bridge) against the JAX package on the small config of tests/test_tts.py.
Both sides load the same weights: the port's numpy random_state_dict in
the reference layout, through each package's own converter.  Noise is fed, not
sampled, so the two trajectories see the same inputs.  Bounds: 5e-4 for
latents and EOS logits, 2e-4 for Mimi audio (tests/test_frozen_parity.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu import weights as jweights
from pocket_tts_tpu.models import flow_lm as jflow_lm
from pocket_tts_tpu.models import flow_mlp as jflow_mlp
from pocket_tts_tpu.models import mimi as jmimi
from pocket_tts_tpu.models import transformer as jtf
from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.config import config_from_dict
from pocket_tts_tpu_torch.models import flow_lm as tflow_lm
from pocket_tts_tpu_torch.models import flow_mlp as tflow_mlp
from pocket_tts_tpu_torch.models import mimi as tmimi
from pocket_tts_tpu_torch.models import transformer as ttf
from tests.test_tts import CFG

torch.set_num_threads(1)
PCFG = config_from_dict(dataclasses.asdict(CFG))


@pytest.fixture(scope="module")
def both():
    sd = tweights.random_state_dict(PCFG, seed=5)
    jp = jweights.convert_tts_state_dict(sd, CFG, jmimi.MimiPlans(CFG.mimi))
    return jp, tweights.from_state_dict(sd, PCFG)


def maxdiff(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return float(np.abs(a - np.asarray(b)).max())


def test_port_config_equals_jax_config():
    assert dataclasses.asdict(PCFG) == dataclasses.asdict(CFG)


@pytest.mark.parametrize("lsd_steps", [1, 2])
def test_flow_lm_prefill_and_steps_with_fed_noise(both, lsd_steps):
    jp, tp = both
    jfl, tfl = jp["flow_lm"], tp["flow_lm"]
    tcfg = CFG.flow_lm.transformer
    rng = np.random.default_rng(lsd_steps)
    tokens = np.zeros((1, 8), np.int32)
    tokens[0, :5] = rng.integers(4, 4000, 5)
    jkc, jvc = jtf.init_cache(tcfg.num_layers, 1, 64, tcfg.num_heads, tcfg.head_dim)
    tkc, tvc = ttf.init_cache(tcfg.num_layers, 1, 64, tcfg.num_heads, tcfg.head_dim)
    jpos, tpos = jnp.zeros((1,), jnp.int32), torch.zeros((1,), dtype=torch.int32)
    jkc, jvc, jpos = jflow_lm.prefill(jfl, CFG, jkc, jvc, jpos,
                                      jflow_lm.embed_text(jfl, jnp.asarray(tokens)),
                                      jnp.asarray([5], jnp.int32))
    tkc, tvc, tpos = tflow_lm.prefill(tfl, PCFG, tkc, tvc, tpos,
                                      tflow_lm.embed_text(tfl, torch.from_numpy(tokens)),
                                      torch.tensor([5], dtype=torch.int32))
    assert int(tpos[0]) == int(jpos[0]) == 5
    assert maxdiff(tkc, jkc) < 5e-4

    jtab = jflow_mlp.time_embedding_table(jfl["flow"], lsd_steps)
    ttab = tflow_mlp.time_embedding_table(tfl["flow"], lsd_steps)
    jlat = jnp.broadcast_to(jfl["bos_emb"], (1, 16))
    tlat = tfl["bos_emb"].expand(1, 16)
    jstep = jax.jit(jflow_lm.step, static_argnums=(1, 8, 9))
    for _ in range(8):
        noise = (rng.standard_normal((1, 16)) * 0.7 ** 0.5).astype(np.float32)
        jlat, jeos, jkc, jvc, jpos = jstep(jfl, CFG, jkc, jvc, jpos, jlat,
                                           jnp.asarray(noise), jtab, lsd_steps, -4.0)
        tlat, teos, tkc, tvc, tpos = tflow_lm.step(tfl, PCFG, tkc, tvc, tpos, tlat,
                                                   torch.from_numpy(noise), ttab, lsd_steps)
        assert maxdiff(tlat, jlat) < 5e-4
        assert maxdiff(teos, jeos) < 5e-4
    assert int(tpos[0]) == int(jpos[0]) == 13
    denorm = tflow_lm.denormalize(tfl, tlat)
    assert maxdiff(denorm, jflow_lm.denormalize(jfl, jlat)) < 5e-4


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_mimi_decode_chunks_from_fresh_state(both, chunk):
    jp, tp = both
    jplans, tplans = jmimi.MimiPlans(CFG.mimi), tmimi.MimiPlans(PCFG.mimi)
    rng = np.random.default_rng(chunk)
    latents = rng.standard_normal((1, 16, 8)).astype(np.float32)
    jst = jmimi.init_decode_state(jplans, 1)
    tst = tmimi.init_decode_state(tplans, 1)
    jdecode = jax.jit(jmimi.decode_step, static_argnums=(1,))
    for s in range(0, 8, chunk):
        x = latents[..., s:s + chunk]
        jy, jst = jdecode(jp["mimi"], jplans, jst, jnp.asarray(x))
        ty, tst = tmimi.decode_step(tp["mimi"], tplans, tst, torch.from_numpy(x))
        assert ty.shape == jy.shape == (1, 1, chunk * 1920)
        assert maxdiff(ty, jy) < 2e-4
    assert maxdiff(tst["kc"], jst["kc"]) < 2e-4


def test_sample_noise_temp_zero_and_clamp():
    g = torch.Generator().manual_seed(0)
    assert torch.count_nonzero(tflow_lm.sample_noise(g, (4, 16), 0.0, None, "cpu")) == 0
    assert torch.count_nonzero(tflow_lm.sample_noise(g, (4, 16), 0.0, 0.5, "cpu")) == 0
    n = tflow_lm.sample_noise(g, (64, 64), 1.0, 0.3, "cpu")
    assert n.abs().max() <= 0.3 and n.std() > 0.1
    n = tflow_lm.sample_noise(g, (64, 64), 0.49, None, "cpu")
    assert abs(n.std().item() - 0.7) < 0.05
