"""``Engine.prefill_tokens`` with a per-lane ``n_valid`` vector in the port,
against the JAX package on the small config of tests/test_tts.py (one weight
set, float32 compute, temp 0).

Ports tests/test_drift.py's vector-``n_valid`` B=4 prefill (four texts of
different lengths in one batch; each lane against its own B=1 run, and the
batch against JAX's) and tests/test_batcher.py's ``[0, n, 0]`` prefill
(lanes with no valid token keep their position and their cache).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pocket_tts_tpu import weights as jweights
from pocket_tts_tpu.models.mimi import MimiPlans
from pocket_tts_tpu.runtime.engine import Engine as JaxEngine
from pocket_tts_tpu.runtime.engine import GenParams as JaxGen
from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.config import config_from_dict
from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams
from tests.test_tts import CFG

torch.set_num_threads(1)
PCFG = config_from_dict(dataclasses.asdict(CFG))
TOL = 5e-4  # f32 latents, port against JAX and a lane against its B=1 run
ROWS = [np.array([[11, 402, 1777, 9, 3055, 42]], np.int32),
        np.array([[7, 1201, 33, 940]], np.int32),
        np.array([[2500, 18, 777, 1212, 5, 66]], np.int32),
        np.array([[99, 3001]], np.int32)]
CHUNK, CHUNKS = 4, 2


@pytest.fixture(scope="module")
def exported():
    plans = MimiPlans(CFG.mimi)
    jp = jweights.random_params(CFG, plans, seed=11)
    return jp, tweights.from_state_dict(jweights.export_state_dict(jp, plans), PCFG)


def _batch(rows):
    width = max(r.shape[1] for r in rows)
    tokens = np.zeros((len(rows), width), np.int32)
    for i, r in enumerate(rows):
        tokens[i, : r.shape[1]] = r[0]
    return tokens, np.array([r.shape[1] for r in rows], np.int32)


def _port_latents(eng, state):
    lats, g = [], torch.Generator().manual_seed(0)
    for _ in range(CHUNKS):
        state, _, _ = eng.decode_frames(state, CHUNK, GenParams(temp=0.0), g)
        lats.append(state["latent"].numpy().copy())
    return np.stack(lats, 1)  # [B, chunks, ldim]


def _jax_latents(eng, state):
    lats, key = [], jax.random.PRNGKey(0)
    for _ in range(CHUNKS):
        state, key, _, _ = eng.decode_frames(state, key, CHUNK, JaxGen(temp=0.0))
        lats.append(np.asarray(state["latent"]))
    return np.stack(lats, 1)


def test_vector_n_valid_lanes_match_single_runs_and_jax(exported):
    """tests/test_drift.py:77-81 at the small config: one B=4 prefill with
    n_valid [6, 4, 6, 2]; each lane's latents track its own B=1 prefill and
    decode, and the batch tracks JAX's same batch."""
    jp, tp = exported
    tokens, n_valid = _batch(ROWS)
    e4 = Engine(PCFG, tp, "cpu", batch_size=4)
    st = e4.prefill_tokens(e4.new_state(), tokens, n_valid)
    assert st["pos"].tolist() == n_valid.tolist()
    got = _port_latents(e4, st)

    e1 = Engine(PCFG, tp, "cpu", batch_size=1)
    for i, row in enumerate(ROWS):
        alone = _port_latents(e1, e1.prefill_tokens(e1.new_state(), row, row.shape[1]))
        assert np.abs(got[i] - alone[0]).max() <= TOL, i

    j4 = JaxEngine(CFG, jp, batch_size=4)
    want = _jax_latents(j4, j4.prefill_tokens(j4.new_state(4), tokens, n_valid))
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("as_list", [False, True])
def test_zero_valid_lanes_keep_position_and_cache(exported, as_list):
    """tests/test_batcher.py:534-535: n_valid [0, n, 0] prefills lane 1 only;
    lanes 0 and 2, mid-stream, keep their position and every cache byte;
    lane 1 equals JAX's same prefill.  The vector may be a list."""
    jp, tp = exported
    eng = Engine(PCFG, tp, "cpu", batch_size=3)
    state, _, _ = eng.decode_frames(eng.new_state(), 2, GenParams(temp=0.5),
                                    torch.Generator().manual_seed(1))
    before = {k: state[k].clone() for k in ("kc", "vc", "pos")}
    toks = np.zeros((3, 4), np.int32)
    toks[1] = [5, 9, 2, 7]
    n_valid = [0, 4, 0] if as_list else np.array([0, 4, 0], np.int32)
    st = eng.prefill_tokens(state, toks, n_valid)
    assert st["pos"].tolist() == [int(before["pos"][0]), int(before["pos"][1]) + 4,
                                  int(before["pos"][2])]
    for name in ("kc", "vc"):  # [L, B, S, H, D]
        for lane in (0, 2):
            assert torch.equal(st[name][:, lane], before[name][:, lane]), (name, lane)

    jeng = JaxEngine(CFG, jp, batch_size=3)
    jst = jeng.prefill_tokens(jeng.new_state(3), toks, np.array([0, 4, 0], np.int32))
    fresh = eng.prefill_tokens(eng.new_state(), toks, n_valid)
    assert fresh["pos"].tolist() == np.asarray(jst["pos"]).tolist() == [0, 4, 0]
    for name in ("kc", "vc"):
        assert np.abs(fresh[name][:, 1].numpy() - np.asarray(jst[name])[:, 1]).max() <= 1e-5


def test_n_valid_vector_of_the_wrong_length_raises(exported):
    eng = Engine(PCFG, exported[1], "cpu", batch_size=2)
    with pytest.raises(ValueError, match="n_valid"):
        eng.prefill_tokens(eng.new_state(), np.zeros((2, 3), np.int32), [1, 2, 3])
