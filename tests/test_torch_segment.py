"""Whole-utterance segment decode (``Engine.decode_segment``, taken by
``segment_dispatch="auto"``) in the port against the JAX package's fused
while_loop segment, on the small config of tests/test_tts.py at temp 0.  Both
packages load one set of weights (random_params -> export_state_dict -> the
port's from_state_dict).  The cases mirror tests/test_tts.py's fused-segment
tests.

Bounds: 1e-4 in float audio against JAX's ``generate`` (tests/test_tts.py);
4e-5 (1 int16 LSB) between the port's fused and chunked paths, as in JAX (the
codec groups frames differently, which can flip one PCM rounding).  On the
CPU the fused loop reads EOS every frame, so ``frames_decoded`` equals the
JAX while_loop's frame count: ``min(mf, eos_step + frames_after_eos)``, or
``eos_step + 1`` when frames_after_eos is 0, or mf without EOS.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pocket_tts_tpu import weights as jweights
from pocket_tts_tpu.models.mimi import MimiPlans
from pocket_tts_tpu.runtime.engine import GenParams as JaxGen
from pocket_tts_tpu.tts import TTSModel as JaxTTS
from pocket_tts_tpu.tts import _SegmentRun as JaxRun
from pocket_tts_tpu_torch import text as text_mod
from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.config import config_from_dict
from pocket_tts_tpu_torch.models import flow_lm, flow_mlp
from pocket_tts_tpu_torch.runtime import engine as engine_mod
from pocket_tts_tpu_torch.runtime.engine import GenParams
from pocket_tts_tpu_torch.tts import TTSModel, _SegmentRun
from tests.test_tts import CFG

torch.set_num_threads(1)
PCFG = config_from_dict(dataclasses.asdict(CFG))
LONG = "Hello, world! This is a longer sentence to exercise the budget."
SHORT = "Hello there friend."
TWO = "This is the first sentence. And here is the second one!"
LSB = 4e-5
JAX_TOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    plans = MimiPlans(CFG.mimi)
    jp = jweights.random_params(CFG, plans, seed=3)
    return jp, tweights.from_state_dict(jweights.export_state_dict(jp, plans), PCFG)


def _runtime(cfg, **kw):
    return dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime, **kw))


def _port(params, cfg=PCFG, seed=0, **gen):
    return TTSModel(cfg, params, gen=GenParams(**{"temp": 0.0, **gen}), has_real_weights=False,
                    device="cpu", seed=seed)


def _jax(jp, cfg=CFG, **gen):
    return JaxTTS(cfg, jp, gen=JaxGen(**{"temp": 0.0, **gen}), has_real_weights=False)


def _eos_logits(model, text: str, n: int) -> np.ndarray:
    """The port's first ``n`` EOS logits of ``text``'s segment at temp 0."""
    eng = model.engine
    prepared, _ = text_mod.prepare_text_prompt(text)
    tokens, n_tokens = text_mod.tokens_array(model.tokenizer, prepared)
    st = eng.prefill_tokens(eng.reset_for_segment(model.get_voice_state().as_dict()), tokens,
                            n_tokens)
    params = eng.params["flow_lm"]
    table = flow_mlp.time_embedding_table(params["flow"], 1)
    pos, latent, out = st["pos"], st["latent"], []
    for _ in range(n):
        latent, logit, _, _, pos = flow_lm.step(params, eng.cfg, st["kc"], st["vc"], pos,
                                                latent, torch.zeros(1, eng.ldim), table, 1)
        out.append(float(logit[0]))
    return np.asarray(out)


def _mid_threshold(model, text: str) -> tuple[float, int]:
    """(threshold, frame) at which EOS first fires mid-budget: between the
    running maximum of the logits before a frame and that frame's logit,
    at the frame past the first few with the widest such gap."""
    budget = model.estimate_generation_steps(text)
    logits = _eos_logits(model, text, budget)
    best = max(range(4, budget - 4),
               key=lambda j: logits[j] - logits[:j].max())
    gap = logits[best] - logits[:best].max()
    assert gap > 1e-3, "no frame's EOS logit rises above all before it"
    return float(logits[:best].max() + gap / 2), best


def _jax_while_counts(jax_model, text: str, fae) -> list[int]:
    """Frames the JAX fused segment's while_loop computes, per segment."""
    counts = []
    for sentence in jax_model.split_into_best_sentences(text):
        run = JaxRun(jax_model, sentence, jax_model.get_voice_state(), fae, low_latency=False)
        assert run.fused_bucket is not None
        run.dispatch_one()
        run.fetch_one()
        mf, f, e = run.max_frames, run.frames_after_eos, run.eos_step
        counts.append(mf if e is None else min(mf, e + max(f, 1)))
    return counts


@pytest.mark.parametrize("case", ["eos", "no_eos", "fae0", "mid_eos", "mid_eos_fae0",
                                  "two_segments"])
def test_fused_segment_matches_chunked_and_jax(weights, case):
    """The fused path against the port's chunk schedule (1 LSB) and against
    JAX's fused generate (1e-4); frames decoded equal the JAX while_loop's."""
    jp, pp = weights
    text = {"no_eos": SHORT, "mid_eos": SHORT, "mid_eos_fae0": SHORT,
            "two_segments": TWO}.get(case, LONG)
    fae = 0 if case.endswith("fae0") else None
    threshold = 1e9 if case == "no_eos" else -4.0
    if case.startswith("mid_eos"):
        threshold, frame = _mid_threshold(_port(pp), text)
    fused = _port(pp, eos_threshold=threshold)
    chunked = _port(pp, _runtime(PCFG, segment_dispatch="chunked"), eos_threshold=threshold)
    run = _SegmentRun(fused, text, fused.get_voice_state(), fae, low_latency=False)
    assert run.fused_bucket == fused.engine.segment_bucket(run.max_frames) is not None
    a = fused.generate(text, frames_after_eos=fae)
    b = chunked.generate(text, frames_after_eos=fae)
    assert a.size > 0 or case == "fae0"
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= LSB
    jax_model = _jax(jp, eos_threshold=threshold)
    ref = jax_model.generate(text, frames_after_eos=fae)
    assert a.shape == ref.shape
    assert np.abs(a - ref).max(initial=0.0) <= JAX_TOL
    counts = _jax_while_counts(jax_model, text, fae)
    assert fused.engine.frames_decoded == sum(counts)
    assert chunked.engine.frames_decoded >= fused.engine.frames_decoded
    if case.startswith("mid_eos"):
        emitted = frame + (0 if fae == 0 else text_mod.prepare_text_prompt(text)[1] + 2)
        assert a.size == emitted * fused.frame_size


def test_infinite_eos_threshold_keeps_chunked_schedule(weights):
    m = _port(weights[1], eos_threshold=float("inf"))
    run = _SegmentRun(m, "Hello.", m.get_voice_state(), None, low_latency=False)
    assert run.fused_bucket is None
    assert run._next_k in PCFG.runtime.decode_chunks


def test_fused_segment_budget_fallback(weights):
    """Budgets beyond the largest segment bucket fall back to the chunk
    schedule, and streaming always takes it."""
    m = _port(weights[1], _runtime(PCFG, segment_buckets=(8, 64)))
    vs = m.get_voice_state()
    run_fused = _SegmentRun(m, "Hi.", vs, None, low_latency=False)
    assert run_fused.fused_bucket == 64  # budget (1 + 2) * 13 = 39 -> 64 bucket
    run_stream = _SegmentRun(m, "Hi.", vs, None, low_latency=True)
    assert run_stream.fused_bucket is None  # streaming keeps the chunk ramp
    long_text = ("This sentence carries clearly more than the sixty four "
                 "frame budget that the largest configured bucket allows "
                 "so the run must fall back to the chunked schedule here.")
    run_long = _SegmentRun(m, long_text, vs, None, low_latency=False)
    assert run_long.fused_bucket is None
    chunked = _port(weights[1], _runtime(PCFG, segment_dispatch="chunked"))
    assert _SegmentRun(chunked, "Hi.", vs, None, low_latency=False).fused_bucket is None


@pytest.mark.parametrize("extra", [0, 70])
def test_fused_bucket_not_multiple_of_codec_group(weights, extra):
    """Buckets need not be multiples of the 64-frame codec group: one smaller
    than the group (budget) and one with a trailing partial group (budget +
    70) decode every valid frame, against the chunk schedule and JAX."""
    jp, pp = weights
    budget = _port(pp).estimate_generation_steps(SHORT)
    bucket = budget + extra
    bucket += bucket % 64 == 0
    fused = _port(pp, _runtime(PCFG, segment_buckets=(bucket,)), eos_threshold=1e9)
    run = _SegmentRun(fused, SHORT, fused.get_voice_state(), None, low_latency=False)
    assert run.fused_bucket == bucket
    a = fused.generate(SHORT)
    want = _port(pp, _runtime(PCFG, segment_dispatch="chunked"), eos_threshold=1e9
                 ).generate(SHORT)
    assert a.shape == want.shape == (budget * fused.frame_size,)
    # the trailing frames carry real audio, not zero fill
    assert np.abs(a - want).max() <= LSB
    assert np.abs(a[-fused.frame_size:]).max() > 0
    jcfg = dataclasses.replace(CFG, runtime=dataclasses.replace(CFG.runtime,
                                                                segment_buckets=(bucket,)))
    ref = _jax(jp, jcfg, eos_threshold=1e9).generate(SHORT)
    assert a.shape == ref.shape and np.abs(a - ref).max() <= JAX_TOL


@pytest.mark.parametrize("threshold", ["mid", 1e9])
def test_fused_matches_chunked_at_temperature(weights, threshold):
    """At temp 0.7 both paths draw one noise vector per frame from the
    segment's generator, seeded alike: the same audio within 1 LSB."""
    pp = weights[1]
    if threshold == "mid":
        threshold, _ = _mid_threshold(_port(pp), SHORT)
    fused = _port(pp, seed=5, temp=0.7, eos_threshold=threshold)
    chunked = _port(pp, _runtime(PCFG, segment_dispatch="chunked"), seed=5, temp=0.7,
                    eos_threshold=threshold)
    a, b = fused.generate(LONG), chunked.generate(LONG)
    assert a.size > 0 and a.shape == b.shape
    assert np.abs(a - b).max() <= LSB
    assert np.abs(a).max() > 0


def test_decode_segment_stops_exactly_on_the_cpu(weights):
    """Engine level: n_valid, eos_step and the frames computed, against the
    stop rule, for every frames_after_eos from 0 past the budget."""
    pp = weights[1]
    model = _port(pp)
    threshold, frame = _mid_threshold(model, SHORT)
    eng = model.engine
    prepared, _ = text_mod.prepare_text_prompt(SHORT)
    tokens, n_tokens = text_mod.tokens_array(model.tokenizer, prepared)
    mf = model.estimate_generation_steps(SHORT)
    gen = GenParams(temp=0.0, eos_threshold=threshold)
    for fae in (0, 1, 5, mf):
        st = eng.prefill_tokens(eng.reset_for_segment(model.get_voice_state().as_dict()),
                                tokens, n_tokens)
        before = eng.frames_decoded
        st, audio, n_valid, eos = eng.decode_segment(
            st, gen, torch.Generator().manual_seed(0), max_frames=mf, frames_after_eos=fae,
            bucket=eng.segment_bucket(mf))
        assert eos == frame
        assert n_valid == min(mf, frame + fae)
        assert eng.frames_decoded - before == min(mf, frame + max(fae, 1))
        assert audio.shape == (1, n_valid * eng.frame_size) and audio.dtype == torch.int16
        assert int(st["pos"][0]) == n_tokens + eng.frames_decoded - before


def test_decode_segment_refuses_what_it_cannot_decode(weights):
    eng = _port(weights[1]).engine
    gen, g = GenParams(temp=0.0), torch.Generator()
    with pytest.raises(ValueError, match="one lane"):
        eng.decode_segment(eng.new_state(2), gen, g, max_frames=4, frames_after_eos=1, bucket=8)
    with pytest.raises(ValueError, match="outside"):
        eng.decode_segment(eng.new_state(), gen, g, max_frames=9, frames_after_eos=1, bucket=8)


@pytest.mark.parametrize("bucket,n_valid,want", [
    (128, 0, []), (128, 1, [(0, 1)]), (128, 64, [(0, 64)]), (128, 65, [(0, 64), (64, 1)]),
    (40, 39, [(0, 39)]), (130, 130, [(0, 64), (64, 64), (128, 2)])])
def test_segment_groups(bucket, n_valid, want):
    assert engine_mod.Engine.segment_groups(bucket, n_valid) == want


class _Event:
    """A stand-in for torch.cuda.Event whose work finishes ``delay`` frames
    after it is recorded (never, with delay None)."""

    clock = 0

    def __init__(self, delay):
        self.delay, self.at, self.waited = delay, None, False

    def record(self):
        self.at = _Event.clock

    def query(self):
        return self.delay is not None and _Event.clock - self.at >= self.delay

    def synchronize(self):
        self.waited = True


@pytest.mark.parametrize("delay", [0, 3, None])
@pytest.mark.parametrize("fae", [0, 2, 40])
def test_eos_watch_bounds_the_frames_past_the_stop(delay, fae):
    """The CUDA polling schedule driven on the CPU with stand-in events: the
    loop never passes the budget, n_valid is the stop rule's, and at most
    SEGMENT_POLL + SEGMENT_MAX_LAG frames are computed past it, for an EOS
    at every frame and events that finish at once, late, or only when
    waited on."""
    poll, lag = engine_mod.SEGMENT_POLL, engine_mod.SEGMENT_MAX_LAG
    mf = 90
    worst = 0
    for e in [*range(0, mf), None]:
        _Event.clock = 0
        watch = engine_mod._EosWatch(torch.device("cpu"), 128, mf, fae, poll=poll,
                                     event=lambda: _Event(delay))
        i = 0
        while i < watch.stop:
            device = torch.tensor(-1 if e is None or e > i else e, dtype=torch.int32)
            i += 1
            _Event.clock = i
            watch.after_frame(i, device)
        n_valid = watch.finish(i, torch.tensor(-1 if e is None else e, dtype=torch.int32))
        assert i <= mf
        assert n_valid == (mf if e is None else min(mf, e + fae))
        assert i - n_valid <= poll + lag
        worst = max(worst, i - n_valid)
    if delay == 0:
        assert worst <= poll  # every copy is read at the frame it was made
