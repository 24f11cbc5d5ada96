"""The port's staged codec (``Engine.enable_staged_codec``) against the
unstaged engine and the JAX package's (ports of tests/test_stages.py).

On the CPU the codec's device is the CPU itself: the split runs (the chunk's
latents handed to the codec's params and state on the codec device), without
a second stream; the CUDA stream of its own is exercised by
tests/test_torch_cuda.py and chip_smoke.py.  One weight set for both
packages (weights.random_params -> export_state_dict -> from_state_dict), the
small config of tests/test_tts.py, temp 0.  Bounds: tests/test_stages.py's
4e-5 in float audio (1 int16 LSB) against the fused segment, bit for bit
against the unstaged chunk schedule, 1e-4 against JAX's staged model (the
port-vs-JAX bound of tests/test_torch_tts.py).  A mesh engine (dp 1 x tp 2
on the repeated CPU device) stages its codec too: bit for bit the unstaged
mesh engine.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pocket_tts_tpu import weights as jweights
from pocket_tts_tpu.models.mimi import MimiPlans
from pocket_tts_tpu.runtime.engine import GenParams as JaxGen
from pocket_tts_tpu.tts import TTSModel as JaxTTS
from pocket_tts_tpu_torch import tts as tts_mod
from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.config import config_from_dict
from pocket_tts_tpu_torch.parallel import mesh as tmesh
from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams
from pocket_tts_tpu_torch.tts import TTSModel
from tests.test_stages import TEXT
from tests.test_tts import CFG

torch.set_num_threads(1)
PCFG = config_from_dict(dataclasses.asdict(CFG))
CPU = torch.device("cpu")
LSB_TOL = 4e-5  # tests/test_stages.py
JAX_TOL = 1e-4


@pytest.fixture(scope="module")
def exported():
    jp = jweights.random_params(CFG, MimiPlans(CFG.mimi), seed=3)
    return jp, tweights.from_state_dict(jweights.export_state_dict(jp, MimiPlans(CFG.mimi)),
                                        PCFG)


def _model(params, staged: bool, cfg=PCFG) -> TTSModel:
    m = TTSModel(cfg, params, gen=GenParams(temp=0.0), has_real_weights=False, device="cpu")
    if staged:
        m.engine.enable_staged_codec(CPU)
    return m


def _chunked(params) -> TTSModel:
    return _model(params, False, dataclasses.replace(
        PCFG, runtime=dataclasses.replace(PCFG.runtime, segment_dispatch="chunked")))


def test_staged_codec_equals_fused(exported):
    jp, params = exported
    fused, staged = _model(params, False), _model(params, True)
    want = fused.generate(TEXT)
    got = staged.generate(TEXT)
    assert got.shape == want.shape
    # the unstaged model takes the fused segment, the staged one the chunk
    # schedule: the codec's grouping may flip an occasional PCM rounding
    np.testing.assert_allclose(got, want, atol=LSB_TOL)
    # op for op the unstaged chunk schedule
    np.testing.assert_array_equal(got, _chunked(params).generate(TEXT))
    # repeat: decoding never writes the shared voice snapshot
    np.testing.assert_array_equal(staged.generate(TEXT), got)
    jstaged = JaxTTS(CFG, jp, gen=JaxGen(temp=0.0), has_real_weights=False)
    jstaged.engine.enable_staged_codec(jax.devices()[1])
    np.testing.assert_allclose(got, jstaged.generate(TEXT), atol=JAX_TOL)


def test_staged_codec_streaming_and_voice(exported):
    """Streaming (the ramp schedule) and a cloned voice through the split."""
    _, params = exported
    fused, staged = _model(params, False), _model(params, True)
    rng = np.random.default_rng(7)
    wav = (rng.normal(size=2 * fused.sample_rate) * 0.1).astype(np.float32)
    vs_f = fused.get_voice_state_from_audio(wav)
    vs_s = staged.get_voice_state_from_audio(wav)
    want = np.concatenate(list(fused.generate_stream("Hello there.", vs_f)))
    got = np.concatenate(list(staged.generate_stream("Hello there.", vs_s)))
    np.testing.assert_allclose(got, want, atol=LSB_TOL)


def _on_mesh(model: TTSModel, staged: bool) -> TTSModel:
    """``model`` running a dp 1 x tp 2 mesh engine (its codec staged on the
    CPU when ``staged``)."""
    model.engine = Engine(model.config, model.params, batch_size=1,
                          mesh=tmesh.make_mesh(2, tp=2, devices=[CPU] * 2))
    if staged:
        model.engine.enable_staged_codec(CPU)
    return model


def test_staged_codec_on_a_mesh_engine(exported):
    """The frames on a dp 1 x tp 2 mesh, the codec staged (its tp ranks on the
    codec's device): generate bit for bit the unstaged mesh engine's chunk
    schedule and within 1e-4 of JAX's staged model; the codec's state lives
    on the codec's mesh, the cache on the engine's; a batch of 2 on a mesh
    raises."""
    jp, params = exported
    staged = _on_mesh(_model(params, False), True)
    plain = _on_mesh(_chunked(params), False)
    got = staged.generate(TEXT)
    assert got.size > 0
    np.testing.assert_array_equal(got, plain.generate(TEXT))
    eng = staged.engine
    st = eng.reset_for_segment(staged.get_voice_state().as_dict())
    assert st["mimi"]["kc"].mesh is eng._codec_mesh and st["kc"].mesh is eng.mesh
    assert eng._codec_mesh.shape == eng.mesh.shape
    jstaged = JaxTTS(CFG, jp, gen=JaxGen(temp=0.0), has_real_weights=False)
    jstaged.engine.enable_staged_codec(jax.devices()[1])
    np.testing.assert_allclose(got, jstaged.generate(TEXT), atol=JAX_TOL)
    wide = Engine(PCFG, params, batch_size=2, mesh=tmesh.make_mesh(2, tp=2, devices=[CPU] * 2))
    with pytest.raises(ValueError, match="batch_size=1"):
        wide.enable_staged_codec(CPU)


def test_staged_codec_rejects_batched_engine(exported):
    _, params = exported
    eng = Engine(PCFG, params, "cpu", batch_size=4)
    with pytest.raises(ValueError, match="batch_size=1"):
        eng.enable_staged_codec(CPU)


def test_staged_outputs_live_on_codec_device(exported):
    """The audio and the Mimi state come from the codec stage (its params,
    on its device); the FlowLM cache stays on the engine's device; the
    fused segment refuses a staged engine."""
    _, params = exported
    staged = _model(params, True)
    eng = staged.engine
    assert eng._codec_device == CPU and eng._codec_stream is None
    assert eng._mimi_params_staged["dec_tf"]["layers"]["in_proj"] is \
        eng.params["mimi"]["dec_tf"]["layers"]["in_proj"]  # one device: shared, not copied
    st = eng.reset_for_segment(staged.get_voice_state().as_dict())
    st, audio, _ = eng.decode_frames(st, 2, staged.gen, torch.Generator())
    assert audio.device == CPU and st["mimi"]["kc"].device == CPU and st["kc"].device == CPU
    assert audio.shape == (1, 2 * staged.frame_size)
    with pytest.raises(ValueError, match="chunk schedule"):
        eng.decode_segment(st, staged.gen, torch.Generator(), max_frames=2,
                           frames_after_eos=1, bucket=4)


def test_codec_stage_device_reads_the_env(monkeypatch):
    """POCKET_TTS_STAGE_CODEC=1 stages a CUDA model's codec onto the first
    other CUDA device when there are two; never a CPU model, never one card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("POCKET_TTS_STAGE_CODEC", raising=False)
    assert tts_mod.codec_stage_device(torch.device("cuda", 0)) is None
    monkeypatch.setenv("POCKET_TTS_STAGE_CODEC", "1")
    assert tts_mod.codec_stage_device(torch.device("cuda", 0)) == torch.device("cuda", 1)
    assert tts_mod.codec_stage_device(torch.device("cuda", 1)) == torch.device("cuda", 0)
    assert tts_mod.codec_stage_device(torch.device("cuda")) == torch.device("cuda", 1)
    assert tts_mod.codec_stage_device(CPU) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tts_mod.codec_stage_device(torch.device("cuda", 0)) is None


def test_stage_codec_env_enables_tts_not_batcher(exported, monkeypatch):
    """The staging TTSModel opts into must not capture a ContinuousBatcher's
    engine (even at batch_size=1): its slot admission writes the Mimi state
    beside the cache, never through reset_for_segment's placement."""
    from pocket_tts_tpu_torch.runtime.batcher import ContinuousBatcher

    _, params = exported
    monkeypatch.setattr(tts_mod, "codec_stage_device", lambda device: CPU)
    m = TTSModel(PCFG, params, gen=GenParams(temp=0.0), has_real_weights=False, device="cpu")
    assert m.engine._codec_device == CPU
    b = ContinuousBatcher(m, batch_size=1, chunk_frames=4)
    assert b.engine._codec_device is None
    b.start()
    try:
        out = b.generate("Short check.")
        assert out.size > 0 and np.isfinite(out).all()
    finally:
        b.stop()


def test_clones_keep_the_staged_codec(exported):
    """A quantized clone and a fine-tuned clone re-apply the source model's
    staging (the JAX package's quantize.py:163-167, trainer.py:226)."""
    from pocket_tts_tpu_torch import training
    from pocket_tts_tpu_torch.runtime.quantize import quantize_model

    _, params = exported
    staged = _model(params, True)
    q8 = quantize_model(staged, bits=8)
    assert q8.engine._codec_device == CPU and q8.engine is not staged.engine
    assert q8.generate("Hi.").size > 0
    tuned = training.finetune(staged, [("Hi there.", np.zeros(3000, np.float32))], steps=1,
                              log_every=0)
    assert tuned.engine._codec_device == CPU
    assert tuned.generate("Hi.").size > 0
