"""The mu-law wire (``transport_format="mulaw"``) in the port, after
tests/test_mulaw.py: ``ops.mulaw`` against the JAX package's over every
int16 value, the decode table, and the engine, TTSModel and batcher on the
mu-law wire against the int16 wire (the small config of tests/test_tts.py,
temp 0): within the worst-case companding step, half of 1 << 10 int16 LSB.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pocket_tts_tpu.ops import mulaw as jmulaw
from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.config import config_from_dict
from pocket_tts_tpu_torch.ops import mulaw
from pocket_tts_tpu_torch.runtime.batcher import ContinuousBatcher
from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams
from pocket_tts_tpu_torch.tts import TTSModel
from tests.test_tts import CFG

torch.set_num_threads(1)
PCFG = config_from_dict(dataclasses.asdict(CFG))
MU = dataclasses.replace(PCFG, runtime=dataclasses.replace(PCFG.runtime, transport_format="mulaw"))
_WORST = (1 << 10) / 32767.0  # tests/test_mulaw.py:26
ALL_INT16 = np.arange(-32768, 32768, dtype=np.int16)


@pytest.fixture(scope="module")
def params():
    return tweights.from_state_dict(tweights.random_state_dict(PCFG, 3), PCFG)


def test_encode_exhaustive_equals_jax():
    got = mulaw.encode(torch.from_numpy(ALL_INT16))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(jmulaw.encode)(ALL_INT16)))
    np.testing.assert_array_equal(mulaw.encode_np(ALL_INT16), jmulaw.encode_np(ALL_INT16))


def test_decode_table_and_round_trip():
    np.testing.assert_array_equal(mulaw.DECODE_TABLE, jmulaw.DECODE_TABLE)
    u = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(mulaw.decode(u), jmulaw.decode(u))
    y = mulaw.decode(mulaw.encode_np(ALL_INT16)).astype(np.int32)
    xi = np.clip(ALL_INT16.astype(np.int32), -32635, 32635)
    e = sum(((np.abs(xi) + 132) >= (1 << k)).astype(np.int32) for k in range(8, 15))
    assert (np.abs(y - xi) <= (1 << (e + 3)) // 2).all()


def test_engine_mulaw_matches_int16_within_step(params):
    toks = np.array([[3, 1, 4, 1, 5]], np.int32)
    outs = {}
    for name, cfg in (("int16", PCFG), ("mulaw", MU)):
        eng = Engine(cfg, params, "cpu")
        assert eng.wire_dtype == (torch.uint8 if name == "mulaw" else torch.int16)
        st = eng.prefill_tokens(eng.new_state(1), toks, toks.shape[1])
        _, audio, _ = eng.decode_frames(st, 2, GenParams(temp=0.0), torch.Generator())
        assert audio.dtype == eng.wire_dtype
        outs[name] = eng.wire_to_float(audio[0].numpy())
        if name == "mulaw":
            np.testing.assert_array_equal(audio.numpy(), mulaw.encode_np(pcm16))
        else:
            pcm16 = audio.numpy()
    assert np.abs(outs["mulaw"] - outs["int16"]).max() <= _WORST


def test_tts_model_mulaw_generate(params):
    model16 = TTSModel(PCFG, params, gen=GenParams(temp=0.0), has_real_weights=False, device="cpu")
    model8 = TTSModel(MU, params, gen=GenParams(temp=0.0), has_real_weights=False, device="cpu")
    text = "Wire format check."
    a, b = model16.generate(text), model8.generate(text)
    assert a.shape == b.shape and np.abs(a - b).max() <= _WORST
    c = np.concatenate(list(model8.generate_stream(text)))
    assert np.abs(c - a[: c.size]).max() <= _WORST


def test_batcher_mulaw_stream(params):
    model8 = TTSModel(MU, params, gen=GenParams(temp=0.0), has_real_weights=False, device="cpu")
    model16 = TTSModel(PCFG, params, gen=GenParams(temp=0.0), has_real_weights=False,
                       device="cpu")
    text = "Batched wire format check."
    b = ContinuousBatcher(model8, batch_size=2, chunk_frames=4)
    b.start()
    try:
        got = np.concatenate(list(b.stream(text)))
    finally:
        b.stop()
    ref = model16.generate_with_pauses(text)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= _WORST
