"""Continuous batching in the port against the JAX package, on the small config
of tests/test_tts.py: one weight set (weights.random_params ->
export_state_dict -> the port's from_state_dict), temp 0, ``batch_size=3``,
``chunk_frames=4``.

Module cases: ``sample_noise`` in its per-slot modes, ``time_embedding_tables``
(1e-6), ``lsd_decode_masked`` (1e-5, pre-sampled noise), ``decode_frames``
with per-slot vectors lane by lane against the JAX engine (5e-4 on latents),
and ``admit_prefill_slot`` (other lanes bit-identical).

Batcher cases, ports of tests/test_batcher.py: every batched request equals
the port's own single stream and JAX ``TTSModel.generate_with_pauses``
within 1e-4 in float audio.  Left out: the window-bucket case
(test_batcher.py:125; attention windows are not ported).  The quantized case
(:382) is in tests/test_torch_quantize.py.  The loop's policy,
preemption, cancellation and ``generate_batch`` cases are in
tests/test_torch_batcher_loop.py.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu import weights as jweights
from pocket_tts_tpu.models import flow_mlp as jflow
from pocket_tts_tpu.models.mimi import MimiPlans
from pocket_tts_tpu.runtime.engine import Engine as JaxEngine
from pocket_tts_tpu.runtime.engine import GenParams as JaxGen
from pocket_tts_tpu.tts import TTSModel as JaxTTS
from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.config import config_from_dict
from pocket_tts_tpu_torch.models import flow_lm as tflow_lm
from pocket_tts_tpu_torch.models import flow_mlp as tflow
from pocket_tts_tpu_torch.runtime.batcher import ContinuousBatcher
from pocket_tts_tpu_torch.runtime.engine import Engine, GenParams
from pocket_tts_tpu_torch.tts import TTSModel
from tests.test_tts import CFG

torch.set_num_threads(1)
PCFG = config_from_dict(dataclasses.asdict(CFG))
TOL = 1e-4  # float audio, tests/test_batcher.py


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


@pytest.fixture(scope="module")
def batcher(models):
    b = ContinuousBatcher(models[1], batch_size=3, chunk_frames=4)
    b.start()
    yield b
    b.stop()


def single(port, text, gen=None, voice=None):
    """The port's single-stream ``generate_with_pauses`` under ``gen``."""
    saved = port.gen
    port.gen = gen or saved
    try:
        return port.generate_with_pauses(text, voice)
    finally:
        port.gen = saved


def reference(models, text, gen=None, voices=None):
    """(port single stream, JAX generate_with_pauses) for ``text``; they
    must agree before either is used as the batcher's reference."""
    jax_model, port = models
    gen = gen or port.gen
    jm = jax_model.with_params(temp=gen.temp, lsd_decode_steps=gen.lsd_decode_steps,
                               noise_clamp=-1 if gen.noise_clamp is None else gen.noise_clamp,
                               eos_threshold=gen.eos_threshold)
    ref = jm.generate_with_pauses(text, voices[0] if voices else None)
    got = single(port, text, gen, voices[1] if voices else None)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL
    return got, ref


def assert_matches(got, refs, what=""):
    for ref in refs:
        assert got.shape == ref.shape, what
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL, err_msg=what)


# -- module cases -------------------------------------------------------------


def test_sample_noise_vec_semantics():
    g = torch.Generator().manual_seed(0)
    shape = (4, 4096)
    temps = torch.tensor([0.0, 0.7, 0.7, 0.7])
    clamps = torch.tensor([0.5, 0.0, -1.0, 0.3])
    n = tflow_lm.sample_noise(g, shape, temps, clamps, "cpu", clamped="vec")
    assert torch.count_nonzero(n[0]) == 0  # temp 0: exactly zero, clamped or not
    assert torch.count_nonzero(n[1]) == 0  # clamp 0: a hard zero
    assert n[2].abs().max() > 1.0 and abs(n[2].std().item() - 0.7 ** 0.5) < 0.05  # unclamped
    assert n[3].abs().max() <= 0.3 and n[3].std() > 0.1  # within +-clamp
    # per-slot temperatures with one scalar clamp, and with none
    n = tflow_lm.sample_noise(g, shape, temps, 0.3, "cpu")
    assert torch.count_nonzero(n[0]) == 0 and n.abs().max() <= 0.3 and n[1].std() > 0.1
    n = tflow_lm.sample_noise(g, shape, torch.tensor([0.0, 0.49, 1.0, 1.0]), None, "cpu")
    assert torch.count_nonzero(n[0]) == 0 and abs(n[1].std().item() - 0.7) < 0.05


def _flow_params(exported):
    jp, sd = exported
    return jp["flow_lm"]["flow"], tweights.from_state_dict(sd, PCFG)["flow_lm"]["flow"]


def test_time_embedding_tables_match_jax(exported):
    jfp, tfp = _flow_params(exported)
    ref = np.asarray(jflow.time_embedding_tables(jfp, 3))
    got = tflow.time_embedding_tables(tfp, 3).numpy()
    assert got.shape == ref.shape == (3, 3, PCFG.flow_lm.flow.dim)
    assert np.abs(got - ref).max() <= 1e-6
    assert not got[0, 1:].any() and not got[1, 2:].any()  # zero-padded past each schedule


def test_lsd_decode_masked_matches_jax_and_own_counts(exported):
    jfp, tfp = _flow_params(exported)
    rng = np.random.default_rng(5)
    b, ldim, d = 3, PCFG.mimi.quantizer.dimension, PCFG.flow_lm.transformer.d_model
    cond = rng.standard_normal((b, d)).astype(np.float32)
    noise = rng.standard_normal((b, ldim)).astype(np.float32)
    steps = np.array([1, 3, 2], np.int32)
    jtab = jflow.time_embedding_tables(jfp, 3)[steps - 1].transpose(1, 0, 2)
    ref = jflow.lsd_decode_masked(jfp, jflow.embed_condition(jfp, jnp.asarray(cond)), jtab,
                                  jnp.asarray(noise), jnp.asarray(steps), 3)
    tcond = tflow.embed_condition(tfp, torch.from_numpy(cond))
    ttab = tflow.time_embedding_tables(tfp, 3)[torch.from_numpy(steps).long() - 1].transpose(0, 1)
    got = tflow.lsd_decode_masked(tfp, tcond, ttab, torch.from_numpy(noise),
                                  torch.from_numpy(steps), 3)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-5
    for s, n in enumerate(steps):  # each slot equals lsd_decode at its own count
        own = tflow.lsd_decode(tfp, tcond[s:s + 1], tflow.time_embedding_table(tfp, int(n)),
                               torch.from_numpy(noise[s:s + 1]), int(n))
        assert (got[s:s + 1] - own).abs().max().item() <= 1e-5


def _admitted(eng, voices, texts, tok, put_row):
    """A B-lane state with lane i admitted to voices[i] and texts[i]."""
    from pocket_tts_tpu_torch import text as text_mod

    state = eng.new_state(len(texts))
    for i, (vs, t) in enumerate(zip(voices, texts)):
        prepared, _ = text_mod.prepare_text_prompt(t)
        tokens, n = text_mod.tokens_array(tok, prepared)
        state = eng.admit_prefill_slot(state, i, vs, put_row(tokens), n)
    return state


def test_decode_frames_per_slot_vectors_match_jax(models, exported):
    """Three lanes with their own voice, text, lsd count and clamp, decoded as
    one batch: lane by lane against the JAX engine's vec program."""
    jax_model, port = models
    jp, sd = exported
    jeng = JaxEngine(CFG, jp, batch_size=3)
    teng = Engine(PCFG, port.engine.params, "cpu", batch_size=3)
    wav = (np.random.default_rng(7).standard_normal(24000) * 0.1).astype(np.float32)
    jvoices = [jax_model.get_voice_state().as_dict(),
               jax_model.get_voice_state_from_audio(wav).as_dict(),
               jax_model.get_voice_state().as_dict()]
    tvoices = [port.get_voice_state().as_dict(), port.get_voice_state_from_audio(wav).as_dict(),
               port.get_voice_state().as_dict()]
    texts = ["One lane speaks.", "A cloned voice in lane two.", "Lane three, with a comma."]
    jst = _admitted(jeng, jvoices, texts, jax_model.tokenizer, jeng.pad_token_row)
    tst = _admitted(teng, tvoices, texts, port.tokenizer, teng.pad_token_row)
    temps = np.zeros(3, np.float32)
    eos = np.array([-4.0, 0.0, float("inf")], np.float32)
    lsd = np.array([1, 3, 2], np.int32)
    clamp = np.array([-1.0, 0.0, 0.5], np.float32)
    gen = GenParams(temp=0.0)
    key, g = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    for k in (4, 2):
        jst, key, jaudio, jeos = jeng.decode_frames(jst, key, k, JaxGen(temp=0.0), temps=temps,
                                                    eos_thresholds=eos, lsd_vec=lsd,
                                                    clamp_vec=clamp)
        tst, taudio, teos = teng.decode_frames(tst, k, gen, g, temps=temps,
                                               eos_thresholds=eos, lsd_vec=lsd, clamp_vec=clamp)
        assert taudio.shape == (3, k * 1920) and teos.shape == (3, k)
        np.testing.assert_array_equal(teos.numpy(), np.asarray(jeos))
        for lane in range(3):
            assert np.abs(tst["latent"][lane].numpy()
                          - np.asarray(jst["latent"])[lane]).max() <= 5e-4, lane
            lsb = np.abs(taudio[lane].numpy().astype(np.int64)
                         - np.asarray(jaudio)[lane].astype(np.int64)).max()
            assert lsb <= 4, (lane, lsb)  # 1e-4 in float audio is 3.3 LSB
    np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))
    assert teng.flow_evals == 6 * 3  # frames x the batch's step ceiling


def test_admit_prefill_slot_writes_its_lane_only(models, exported):
    """Fused admission (voice install + this lane's text prefill at B = 1 on
    the lane's view of the cache) against a fresh B = 1 segment state with the
    same prefill, and against JAX's fused admission.  Every other lane must be
    bit-identical: the lane view's boolean-mask prefill write reaches the
    shared buffer and nothing else."""
    jax_model, port = models
    jp, _ = exported
    eng = Engine(PCFG, port.engine.params, "cpu", batch_size=3)
    wav = (np.random.default_rng(3).standard_normal(24000) * 0.1).astype(np.float32)
    voice = port.get_voice_state_from_audio(wav).as_dict()
    toks = np.array([[5, 9, 2, 7]], np.int32)
    state = eng.new_state()
    state, _, _ = eng.decode_frames(state, 2, GenParams(temp=0.5), torch.Generator().manual_seed(1))
    before = jax.tree.map(lambda t: t.clone(), state)

    state = eng.admit_prefill_slot(state, 1, voice, eng.pad_token_row(toks), toks.shape[1])
    one = eng.prefill_tokens(eng.reset_for_segment(voice), toks, toks.shape[1])
    jeng = JaxEngine(CFG, jp, batch_size=3)
    jst = jeng.admit_prefill_slot(jeng.new_state(3), 1,
                                  jax_model.get_voice_state_from_audio(wav).as_dict(),
                                  jeng.pad_token_row(toks), toks.shape[1])
    for name in ("kc", "vc"):
        lane = state[name][:, 1:2]
        assert (lane - one[name]).abs().max().item() <= 1e-6
        assert np.abs(lane[:, 0].numpy() - np.asarray(jst[name])[:, 1]).max() <= 1e-5
    assert int(state["pos"][1]) == int(one["pos"][0]) == int(np.asarray(jst["pos"])[1])
    assert torch.equal(state["latent"][1], one["latent"][0])

    def other_lanes(t, axis):
        return torch.cat([t.narrow(axis, 0, 1), t.narrow(axis, 2, 1)], dim=axis)

    for name, axis in (("kc", 1), ("vc", 1), ("pos", 0), ("latent", 0)):
        assert torch.equal(other_lanes(state[name], axis), other_lanes(before[name], axis)), name
    for name in ("kc", "vc"):
        assert torch.equal(other_lanes(state["mimi"][name], 1),
                           other_lanes(before["mimi"][name], 1))
    for name in ("up", "pos", "dec"):
        jax.tree.map(lambda a, b: torch.testing.assert_close(other_lanes(a, 0), other_lanes(b, 0),
                                                             rtol=0, atol=0),
                     state["mimi"][name], before["mimi"][name])

    # and the admitted lane decodes as its own single stream does
    gen = GenParams(temp=0.0)
    _, audio, _ = eng.decode_frames(state, 2, gen, torch.Generator())
    _, audio1, _ = eng.decode_frames(one, 2, gen, torch.Generator())
    assert (audio[1].long() - audio1[0].long()).abs().max().item() <= 3


def test_batcher_engine_shares_model_params(models, batcher):
    port = models[1]
    ours, theirs = batcher.engine.params, port.engine.params
    assert ours["flow_lm"]["tf"]["ff1"] is theirs["flow_lm"]["tf"]["ff1"]
    assert ours["flow_lm"]["flow"]["blocks"]["mlp1_w"] is theirs["flow_lm"]["flow"]["blocks"]["mlp1_w"]
    assert ours["mimi"]["decoder"][0]["w"] is theirs["mimi"]["decoder"][0]["w"]


def test_adapters_are_not_accepted(models, batcher, tmp_path):
    """A batcher without an adapter bank refuses adapter requests (ValueError,
    the JAX package's words), one with a bank refuses a name it lacks
    (KeyError); the per-slot bank itself: tests/test_torch_adapter_bank.py."""
    from pocket_tts_tpu_torch.training.lora import build_adapter_bank, init_lora, save_lora_params

    with pytest.raises(ValueError, match="no adapter bank"):
        batcher.generate("Adapter request.", adapter="spk")
    with pytest.raises(ValueError, match="no adapter bank"):
        batcher.generate_batch(["Adapter request."], adapters=["spk"])
    path = tmp_path / "spk.lora.safetensors"
    save_lora_params(init_lora(models[1].params["flow_lm"], 2), path, rank=2, alpha=2.0)
    banked = ContinuousBatcher(models[1], adapter_bank=build_adapter_bank({"spk": str(path)}))
    with pytest.raises(KeyError, match="other"):
        banked.submit("Adapter request.", adapter="other")


# -- batcher against single stream and JAX (tests/test_batcher.py:34-123) ----


def test_batched_equals_single_stream(models, batcher):
    text = "Hello there, this is a batching test."
    refs = reference(models, text)
    assert_matches(batcher.generate(text), refs)


def test_concurrent_requests(models, batcher):
    texts = ["First request speaking now.", "Second one talking too.",
             "Third request in the batch.", "Fourth arrives later."]
    refs = [reference(models, t) for t in texts]
    results = [None] * len(texts)

    def run(i):
        results[i] = batcher.generate(texts[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i, (got, want) in enumerate(zip(results, refs)):
        assert got is not None, i
        assert_matches(got, want, f"req {i}")


def test_pause_handling(models, batcher):
    out = batcher.generate("Hello there everyone. [pause:300ms] Goodbye now.")
    n_silence = int(0.3 * models[1].sample_rate)
    a = batcher.generate("Hello there everyone.")
    b = batcher.generate("Goodbye now.")
    assert out.size == a.size + n_silence + b.size
    assert not out[a.size:a.size + n_silence].any()
    assert_matches(out, reference(models, "Hello there everyone. [pause:300ms] Goodbye now."))


def test_multisegment_request_ordered(models, batcher):
    """A long text splits into segments that run in parallel slots; the output
    is still their ordered concatenation (= the serial single stream)."""
    text = "This sentence has exactly enough words to be a decent chunk of text. " * 3
    assert len(models[1].split_into_best_sentences(text)) > 1
    assert_matches(batcher.generate(text), reference(models, text))


def test_voice_state_respected(models, batcher):
    jax_model, port = models
    wav = np.random.default_rng(7).normal(size=24000).astype(np.float32) * 0.1
    voices = (jax_model.get_voice_state_from_audio(wav), port.get_voice_state_from_audio(wav))
    refs = reference(models, "Voice in the batcher.", voices=voices)
    assert_matches(batcher.generate("Voice in the batcher.", voices[1]), refs)


def test_empty_text(batcher):
    with pytest.raises(ValueError):
        batcher.generate("   ")


def test_mixed_lsd_and_clamp_concurrent(models, batcher):
    """Per-request lsd_decode_steps / noise_clamp ride the batch as per-slot
    data: concurrent requests with different knobs each match their own
    single stream, with no cross-talk between slots."""
    text = "Mixed knob requests share one batch."
    gens = [GenParams(temp=0.0, lsd_decode_steps=1),
            GenParams(temp=0.0, lsd_decode_steps=2),
            GenParams(temp=0.0, lsd_decode_steps=3, noise_clamp=0.5)]
    refs = [reference(models, text, g) for g in gens]
    assert not np.allclose(refs[0][0], refs[1][0], atol=TOL)  # lsd changes the audio
    results = [None] * len(gens)

    def run(i):
        results[i] = batcher.generate(text, gen=gens[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(gens))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for i, (got, want) in enumerate(zip(results, refs)):
        assert got is not None, i
        assert_matches(got, want, f"req {i}")


def test_zero_noise_clamp_batched_matches_single(models, batcher):
    """noise_clamp=0.0 is a HARD zero-clamp, not 'unclamped': at temp 0.7 it
    gives the temp-0 audio, batched as in a single stream."""
    text = "Zero clamp means zero noise."
    gen = GenParams(temp=0.7, noise_clamp=0.0)
    refs = reference(models, text, gen)
    np.testing.assert_allclose(refs[0], single(models[1], text), rtol=0, atol=1e-5)
    assert_matches(batcher.generate(text, gen=gen), refs)
