"""The whole slice: the port's TTSModel against the JAX package's on the small
config of tests/test_tts.py, at temp 0 (no noise, so the RNGs do not
matter).  Both load one set of weights: weights.random_params ->
weights.export_state_dict -> the port's from_state_dict.  Bound: equal sample
counts and 1e-4 max abs in float audio (tests/test_tts.py), about 3 int16 LSB.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pocket_tts_tpu import weights as jweights
from pocket_tts_tpu.models.mimi import MimiPlans
from pocket_tts_tpu.runtime.engine import GenParams as JaxGen
from pocket_tts_tpu.tts import TTSModel as JaxTTS
from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.config import config_from_dict
from pocket_tts_tpu_torch.runtime.engine import GenParams
from pocket_tts_tpu_torch.tts import TTSModel
from tests.test_tts import CFG

torch.set_num_threads(1)
PCFG = config_from_dict(dataclasses.asdict(CFG))
TWO_SENTENCES = "This is the first sentence. And here is the second one!"


@pytest.fixture(scope="module")
def exported():
    plans = MimiPlans(CFG.mimi)
    jp = jweights.random_params(CFG, plans, seed=3)
    return jp, jweights.export_state_dict(jp, plans)


@pytest.fixture(scope="module")
def models(exported):
    jp, sd = exported
    jax_model = JaxTTS(CFG, jp, gen=JaxGen(temp=0.0), has_real_weights=False)
    port = TTSModel(PCFG, tweights.from_state_dict(sd, PCFG), gen=GenParams(temp=0.0),
                    has_real_weights=False, device="cpu")
    return jax_model, port


def test_random_state_dict_layout_matches_jax_export(exported):
    _, sd = exported
    ours = tweights.random_state_dict(PCFG, seed=0)
    assert sorted(ours) == sorted(sd)
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in sd.items()}
    assert all(v.dtype == np.float32 for v in ours.values())


def test_generate_matches_jax(models):
    jax_model, port = models
    ref = jax_model.generate("Hello, world!")
    got = port.generate("Hello, world!")
    assert got.dtype == np.float32 and got.size > 0
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-4


def test_generate_stream_two_sentences_matches_jax(models):
    jax_model, port = models
    assert len(port.split_into_best_sentences(TWO_SENTENCES)) == \
        len(jax_model.split_into_best_sentences(TWO_SENTENCES))
    ref = np.concatenate(list(jax_model.generate_stream(TWO_SENTENCES)))
    chunks = list(port.generate_stream(TWO_SENTENCES))
    assert all(c.size % port.frame_size == 0 for c in chunks)
    got = np.concatenate(chunks)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-4
    # the chunk schedule changes only the codec's grouping: rounding-level
    np.testing.assert_allclose(port.generate(TWO_SENTENCES), got, rtol=0, atol=1e-4)


def test_stop_rule_runs_full_budget_without_eos(exported):
    _, sd = exported
    port = TTSModel(PCFG, tweights.from_state_dict(sd, PCFG),
                    gen=GenParams(temp=0.0, eos_threshold=float("inf")),
                    has_real_weights=False, device="cpu")
    wav = port.generate("Hello, world!")
    assert wav.size == port.estimate_generation_steps("Hello, world!") * port.frame_size


def test_empty_voice_state_is_shared_and_never_written(models):
    _, port = models
    vs = port.get_voice_state()
    assert vs is port.get_voice_state()
    port.generate("Hello, world!")
    assert int(vs.pos[0]) == 0 and vs.length == 0
    assert torch.count_nonzero(vs.kc) == 0
    # a voice source yields a prefilled state of its own; the empty one stays empty
    wav = (np.random.default_rng(0).standard_normal(24000) * 0.1).astype(np.float32)
    voiced = port.get_voice_state_from_audio(wav)
    assert voiced is not vs and voiced.length == int(voiced.pos[0]) == 13
    port.generate("Hello, world!", voiced)
    assert int(vs.pos[0]) == 0 and vs.length == 0
    assert torch.count_nonzero(vs.kc) == 0 and torch.count_nonzero(vs.vc) == 0
