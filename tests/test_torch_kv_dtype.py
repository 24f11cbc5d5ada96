"""The fp8 FlowLM KV cache (``RuntimeConfig.kv_dtype``) in the port, ported
from tests/test_kv_dtype.py and held against the JAX package's fp8 cache (the
small config of tests/test_tts.py, one weight set, float32 compute, temp 0).

Both packages round the same float32 keys and values to e4m3fn (torch's and
ml_dtypes' round-to-nearest-even agree bit for bit), so the caches hold the
same bytes and the latents agree within the f32 bound of 5e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu import weights as jweights
from pocket_tts_tpu.models.mimi import MimiPlans
from pocket_tts_tpu.ops import attention as jattn
from pocket_tts_tpu.runtime.engine import Engine as JaxEngine
from pocket_tts_tpu.runtime.engine import GenParams as JaxGen
from pocket_tts_tpu.tts import TTSModel as JaxTTS
from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.config import RuntimeConfig, config_from_dict
from pocket_tts_tpu_torch.ops import attention as tattn
from pocket_tts_tpu_torch.runtime.batcher import ContinuousBatcher
from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams
from pocket_tts_tpu_torch.runtime.quantize import quantize_model
from pocket_tts_tpu_torch.tts import TTSModel
from tests.test_tts import CFG

torch.set_num_threads(1)
PCFG = config_from_dict(dataclasses.asdict(CFG))
TEXT = "Hello there, this is a float eight cache test with some length."
FP8 = {"float8_e4m3": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def _cfg(cfg, kv_dtype):
    return dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime, kv_dtype=kv_dtype))


@pytest.fixture(scope="module")
def exported():
    plans = MimiPlans(CFG.mimi)
    jp = jweights.random_params(CFG, plans, seed=3)
    return jp, tweights.from_state_dict(jweights.export_state_dict(jp, plans), PCFG)


def _port(tp, kv_dtype=None):
    cfg = PCFG if kv_dtype is None else _cfg(PCFG, kv_dtype)
    return TTSModel(cfg, tp, gen=GenParams(temp=0.0), has_real_weights=False, device="cpu")


@pytest.mark.parametrize("name", sorted(FP8))
def test_kv_dtype_reaches_state(exported, name):
    m = _port(exported[1], name)
    st = m.engine.new_state()
    assert st["kc"].dtype == st["vc"].dtype == FP8[name] == m.engine.kv_dtype
    assert not st["kc"].view(torch.uint8).any()  # zero bytes: 0.0 in both formats
    vs = m.get_voice_state()
    assert vs.kc.dtype == FP8[name]
    assert m.engine.reset_for_segment(vs.as_dict())["kc"].dtype == FP8[name]
    assert _port(exported[1]).engine.new_state()["kc"].dtype == torch.float32  # auto: compute


def test_kv_dtype_validated():
    with pytest.raises(ValueError, match="kv_dtype"):
        RuntimeConfig(kv_dtype="int8")


def test_kv_dtype_override_and_env(monkeypatch):
    """A keyword wins over POCKET_TTS_KV_DTYPE / POCKET_TTS_TRANSPORT, which
    win over the config."""
    monkeypatch.setenv("POCKET_TTS_KV_DTYPE", "float8_e5m2")
    monkeypatch.setenv("POCKET_TTS_TRANSPORT", "mulaw")
    cfg = TTSModel._apply_config_overrides(PCFG)
    assert (cfg.runtime.kv_dtype, cfg.runtime.transport_format) == ("float8_e5m2", "mulaw")
    cfg = TTSModel._apply_config_overrides(PCFG, kv_dtype="float8_e4m3", transport_format="int16")
    assert (cfg.runtime.kv_dtype, cfg.runtime.transport_format) == ("float8_e4m3", "int16")
    monkeypatch.delenv("POCKET_TTS_KV_DTYPE")
    monkeypatch.delenv("POCKET_TTS_TRANSPORT")
    assert TTSModel._apply_config_overrides(PCFG).runtime == PCFG.runtime
    with pytest.raises(ValueError, match="kv_dtype"):
        TTSModel._apply_config_overrides(PCFG, kv_dtype="int8")


@pytest.mark.parametrize("name", sorted(FP8))
def test_cache_write_and_attention_match_jax(name):
    """cache_write / prefill_write into an fp8 cache hold JAX's bytes, and
    attention over it matches JAX's within f32 rounding."""
    rng = np.random.default_rng(0)
    b, t, h, d, s = 2, 3, 4, 16, 12
    new = rng.standard_normal((b, t, h, d)).astype(np.float32)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    start = np.array([2, 7], np.int32)
    t_valid = np.array([3, 1], np.int32)
    jdt = {"float8_e4m3": jnp.float8_e4m3fn, "float8_e5m2": jnp.float8_e5m2}[name]
    jc = jattn.cache_write(jnp.zeros((b, s, h, d), jdt), jnp.asarray(new), jnp.asarray(start))
    tc = tattn.cache_write(torch.zeros((b, s, h, d), dtype=FP8[name]), torch.from_numpy(new),
                           torch.from_numpy(start))
    np.testing.assert_array_equal(tc.float().numpy(), np.asarray(jc, np.float32))
    jc = jattn.prefill_write(jc, jnp.asarray(new[:, ::-1]), jnp.asarray(start + 3),
                             jnp.asarray(t_valid))
    tc = tattn.prefill_write(tc, torch.from_numpy(new[:, ::-1].copy()),
                             torch.from_numpy(start + 3), torch.from_numpy(t_valid))
    np.testing.assert_array_equal(tc.float().numpy(), np.asarray(jc, np.float32))
    pos = np.array([5, 9], np.int32)
    ref = jattn.causal_cache_attention(jnp.asarray(q), jc, jc, jnp.asarray(pos))
    got = tattn.causal_cache_attention(torch.from_numpy(q), tc, tc, torch.from_numpy(pos))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_sdpa_fp8_cache_error_bounded():
    """tests/test_kv_dtype.py:64: attention over the fp8 cache within 5% of
    the f32 cache's (probabilities never rounded to fp8)."""
    g = torch.Generator().manual_seed(0)
    b, h, d, s = 2, 4, 32, 64
    q = torch.randn(b, 1, h, d, generator=g)
    k_new, v_new = torch.randn(b, s, h, d, generator=g), torch.randn(b, s, h, d, generator=g)
    pos = torch.full((b,), s - 1, dtype=torch.int32)

    def run(dtype):
        kc = tattn.cache_write(torch.zeros(b, s, h, d, dtype=dtype), k_new, torch.zeros(b))
        vc = tattn.cache_write(torch.zeros(b, s, h, d, dtype=dtype), v_new, torch.zeros(b))
        return tattn.causal_cache_attention(q, kc, vc, pos)

    ref = run(torch.float32)
    err = ((run(torch.float8_e4m3fn) - ref).abs().max() / ref.abs().max()).item()
    assert err < 0.05, err


@pytest.mark.parametrize("name", sorted(FP8))
def test_fp8_engine_matches_jax(exported, name):
    """decode_frames with an fp8 cache in f32 compute: latents within 5e-4 of
    JAX's fp8 engine, int16 audio within 4 LSB."""
    jp, tp = exported
    jeng = JaxEngine(_cfg(CFG, name), jp, batch_size=1)
    teng = Engine(_cfg(PCFG, name), tp, "cpu")
    toks = np.array([[3, 1, 4, 1, 5, 9, 2]], np.int32)
    jst = jeng.prefill_tokens(jeng.new_state(1), toks, toks.shape[1])
    tst = teng.prefill_tokens(teng.new_state(1), toks, toks.shape[1])
    np.testing.assert_array_equal(tst["kc"].float().numpy(), np.asarray(jst["kc"], np.float32))
    key, g = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    for k in (4, 4):
        jst, key, jaudio, _ = jeng.decode_frames(jst, key, k, JaxGen(temp=0.0))
        tst, taudio, _ = teng.decode_frames(tst, k, GenParams(temp=0.0), g)
        assert np.abs(tst["latent"].numpy() - np.asarray(jst["latent"])).max() <= 5e-4
        assert np.abs(taudio.numpy().astype(np.int64)
                      - np.asarray(jaudio).astype(np.int64)).max() <= 4


def test_fp8_generate_matches_jax(exported):
    jp, tp = exported
    ref = JaxTTS(_cfg(CFG, "float8_e4m3"), jp, gen=JaxGen(temp=0.0),
                 has_real_weights=False).generate(TEXT)
    got = _port(tp, "float8_e4m3").generate(TEXT)
    assert got.shape == ref.shape and got.size > 0
    assert np.abs(got - ref).max() <= 1e-4


def test_kv_fp8_batched_equals_single_stream(exported):
    """tests/test_kv_dtype.py:92: admission copies the voice snapshot's fp8
    bytes into a lane; each batched request equals the fp8 single stream."""
    m = _port(exported[1], "float8_e4m3")
    single = m.generate_with_pauses(TEXT)
    b = ContinuousBatcher(m, batch_size=2, chunk_frames=4)
    b.start()
    try:
        assert b.engine.kv_dtype == torch.float8_e4m3fn
        batched = b.generate(TEXT)
    finally:
        b.stop()
    assert batched.shape == single.shape
    np.testing.assert_allclose(batched, single, atol=1e-4)


def test_kv_fp8_composes_with_int8_weights(exported):
    """tests/test_kv_dtype.py:113: the kv_dtype survives quantize_model, and
    int8 + fp8 tracks the full-precision audio (and equals JAX's combo)."""
    jp, tp = exported
    from pocket_tts_tpu.runtime.quantize import quantize_model as jquantize

    combo = quantize_model(_port(tp, "float8_e4m3"))
    assert combo.engine.new_state()["kc"].dtype == torch.float8_e4m3fn
    a0 = _port(tp).generate(TEXT)
    ac = combo.generate(TEXT)
    assert abs(len(a0) - len(ac)) <= 2 * 1920
    n = min(len(a0), len(ac))
    assert np.corrcoef(a0[:n], ac[:n])[0, 1] > 0.97
    ref = jquantize(JaxTTS(_cfg(CFG, "float8_e4m3"), jp, gen=JaxGen(temp=0.0),
                           has_real_weights=False)).generate(TEXT)
    assert ac.shape == ref.shape and np.abs(ac - ref).max() <= 1e-4


def test_fp8_voice_continuation_matches_jax_and_keeps_the_voice(exported):
    """A cloned voice on a float8_e4m3 cache through ``generate_with_pauses``
    with ``continuation_frames``: each later segment extends a copy of the
    voice state (``_prefill_voice(base=)``, copied as its bytes), so the
    voice's cache bytes are unchanged afterwards, and the float audio is
    within 1e-4 of JAX's same run."""
    jp, tp = exported
    text = "The first part is spoken here. [pause:300ms] And the second part follows."
    wav = (np.random.default_rng(7).standard_normal(24000) * 0.1).astype(np.float32)
    port = _port(tp, "float8_e4m3")
    vs = port.get_voice_state_from_audio(wav)
    assert vs.kc.dtype == torch.float8_e4m3fn
    before = {name: tattn.raw_view(t).clone() for name, t in vs.as_dict().items()}
    extended, extend = [], port.extend_voice_state
    port.extend_voice_state = lambda *a: extended.append(1) or extend(*a)
    got = port.generate_with_pauses(text, vs, continuation_frames=4)
    assert extended  # the second segment extended a copy of the voice
    for name, t in vs.as_dict().items():
        assert torch.equal(tattn.raw_view(t), before[name]), name
    ref_model = JaxTTS(_cfg(CFG, "float8_e4m3"), jp, gen=JaxGen(temp=0.0),
                       has_real_weights=False)
    ref = ref_model.generate_with_pauses(text, ref_model.get_voice_state_from_audio(wav),
                                         continuation_frames=4)
    assert got.shape == ref.shape and got.size > 0
    assert np.abs(got - ref).max() <= 1e-4
