"""``TTSModel.load_from_bytes`` and ``TTSModel.with_params`` in the port
against the JAX package, on the small config of tests/test_tts.py with one
weight set (weights.random_params -> export_state_dict).

* ``load_from_bytes`` writes no temporary file and reads no checkpoint file;
  its params equal the file loader's and JAX's ``load_from_bytes``'s, bit
  for bit; ``device`` defaults to ``cuda``.
* A ``with_params`` clone shares the engine, the params, the host generator
  and the empty voice state (the same storage), and advances the one
  generator it shares; ``None`` is "not overridden", ``noise_clamp=-1``
  unclamps, invalid knobs raise.
* A clone's ``generate`` at temp 0 equals JAX's clone's within 1e-4 in float
  audio (tests/test_tts.py).
"""

import dataclasses
import tempfile

import numpy as np
import pytest
import torch
from safetensors.numpy import save as st_save

import pocket_tts_tpu.tts as jtts_mod
import pocket_tts_tpu_torch.tts as tts_mod
from pocket_tts_tpu import weights as jweights
from pocket_tts_tpu.models.mimi import MimiPlans
from pocket_tts_tpu.runtime.engine import GenParams as JaxGen
from pocket_tts_tpu.tts import TTSModel as JaxTTS
from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.config import config_from_dict
from pocket_tts_tpu_torch.runtime.engine import GenParams
from pocket_tts_tpu_torch.tts import TTSModel
from tests.test_torch_quantize import _assert_trees_equal
from tests.test_tts import CFG

torch.set_num_threads(1)
PCFG = config_from_dict(dataclasses.asdict(CFG))
TEXT = "A clone speaks with its own knobs."


@pytest.fixture(scope="module")
def exported():
    plans = MimiPlans(CFG.mimi)
    jp = jweights.random_params(CFG, plans, seed=3)
    sd = jweights.export_state_dict(jp, plans)
    return jp, sd, st_save(sd)


@pytest.fixture(scope="module")
def models(exported):
    jp, sd, _ = exported
    jax_model = JaxTTS(CFG, jp, gen=JaxGen(temp=0.0), has_real_weights=False)
    port = TTSModel(PCFG, tweights.from_state_dict(sd, PCFG), gen=GenParams(temp=0.0),
                    has_real_weights=False, device="cpu")
    return jax_model, port


@pytest.fixture
def small_variant(monkeypatch):
    monkeypatch.setattr(tts_mod, "load_variant", lambda variant: PCFG)
    monkeypatch.setattr(jtts_mod, "load_variant", lambda variant: CFG)


def test_load_from_bytes_never_touches_filesystem(exported, small_variant, monkeypatch):
    _, sd, data = exported

    def boom(*a, **k):
        raise AssertionError("load_from_bytes touched the filesystem")

    for name in ("NamedTemporaryFile", "TemporaryFile", "mkstemp", "mkdtemp"):
        monkeypatch.setattr(tempfile, name, boom)
    for name in ("read_safetensors", "load_state_dict_any", "load_params"):
        monkeypatch.setattr(tweights, name, boom)
    model = TTSModel.load_from_bytes(data, temp=0.0, device="cpu")
    assert model.has_real_weights and model.gen.temp == 0.0 and model.device.type == "cpu"
    _assert_trees_equal(model.params, tweights.from_state_dict(sd, PCFG))


def test_load_from_bytes_params_equal_file_loader_and_jax(exported, small_variant, tmp_path):
    _, _, data = exported
    port = TTSModel.load_from_bytes(data, device="cpu", lsd_decode_steps=2, seed=5)
    ref = JaxTTS.load_from_bytes(data, lsd_decode_steps=2, seed=5)
    _assert_trees_equal(ref.params, port.params)
    path = tmp_path / "tts.safetensors"
    path.write_bytes(data)
    _assert_trees_equal(ref.params, tweights.from_state_dict(tweights.load_state_dict_any(path),
                                                             PCFG))
    assert port.gen == GenParams(lsd_decode_steps=2) and ref.gen.lsd_decode_steps == 2


def test_load_from_bytes_defaults_to_cuda_and_checks_kwargs(exported, small_variant):
    _, _, data = exported
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TTSModel.load_from_bytes(data)
    with pytest.raises(TypeError, match="unknown load kwargs"):
        TTSModel.load_from_bytes(data, device="cpu", tempreature=0.5)


def test_with_params_clone_shares_engine_params_rng_and_empty_voice(models):
    _, port = models
    clone = port.with_params(temp=0.5, lsd_decode_steps=2)
    for name in ("engine", "params", "tokenizer", "_rng", "_empty_voice", "config"):
        assert getattr(clone, name) is getattr(port, name), name
    # the clone builds the empty voice; the base and a second clone get it
    vs = clone.get_voice_state()
    for other in (port, port.with_params(temp=0.1)):
        got = other.get_voice_state()
        assert got is vs
        assert got.kc.data_ptr() == vs.kc.data_ptr() and got.vc.data_ptr() == vs.vc.data_ptr()
    assert port.gen == GenParams(temp=0.0) and clone.gen == GenParams(temp=0.5,
                                                                      lsd_decode_steps=2)


def test_with_params_overrides(models):
    _, port = models
    assert port.with_params(temp=None, lsd_decode_steps=None, noise_clamp=None,
                            eos_threshold=None).gen == port.gen
    assert port.with_params(noise_clamp=0.5).gen.noise_clamp == 0.5
    assert port.with_params(noise_clamp=0.5).with_params(noise_clamp=-1).gen.noise_clamp is None
    assert port.with_params(eos_threshold=-2.0).gen.eos_threshold == -2.0
    with pytest.raises(ValueError, match="lsd_decode_steps"):
        port.with_params(lsd_decode_steps=0)
    with pytest.raises(ValueError, match="temp"):
        port.with_params(temp=-1.0)
    with pytest.raises(TypeError):
        port.with_params(temperature=0.5)


def test_clones_advance_one_generator(models):
    """Two clones at temp 0.7 draw their segment seeds from the base's one
    host generator, in call order: they give what two calls of the base
    give from the same seed."""
    _, port = models
    saved = port.gen
    try:
        port._rng.manual_seed(11)
        a, b = (port.with_params(temp=0.7).generate(TEXT) for _ in range(2))
        port._rng.manual_seed(11)
        port.gen = dataclasses.replace(saved, temp=0.7)
        want_a, want_b = port.generate(TEXT), port.generate(TEXT)
    finally:
        port.gen = saved
    np.testing.assert_array_equal(a, want_a)
    np.testing.assert_array_equal(b, want_b)
    assert a.shape != b.shape or not np.array_equal(a, b)


@pytest.mark.parametrize("overrides", [{"temp": 0.0}, {"temp": 0.0, "lsd_decode_steps": 2},
                                       {"temp": 0.0, "eos_threshold": -2.0}])
def test_clone_generate_matches_jax(models, overrides):
    jax_model, port = models
    got = port.with_params(**overrides).generate(TEXT)
    want = np.asarray(jax_model.with_params(**overrides).generate(TEXT))
    assert got.shape == want.shape and got.size > 0
    assert np.abs(got - want).max() <= 1e-4
