"""The port's continuous-batcher decode loop on the small config of
tests/test_tts.py (CPU, temp 0): ports of tests/test_batcher.py:186-373
(counters, early retirement, zero lsd rejected, warm ramp, preemption,
cancelling an abandoned stream), :455-626 (chunk policy, stop fails open,
concurrent chaos) and :629-708 (``generate_batch``).  Every batched result is
held against the port's own single stream within 1e-4 in float audio; the
port's single stream is held against the JAX package in
tests/test_torch_batcher.py and tests/test_torch_tts.py.
"""

import dataclasses
import os
import queue
import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.config import config_from_dict
from pocket_tts_tpu_torch.runtime.batcher import (
    _SENTINEL,
    ContinuousBatcher,
    _Request,
    _Segment,
    _Slot,
    batched_tts,
)
from pocket_tts_tpu_torch.runtime.engine import GenParams
from pocket_tts_tpu_torch.tts import TTSModel
from tests.test_tts import CFG

torch.set_num_threads(1)
PCFG = config_from_dict(dataclasses.asdict(CFG))
TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    params = tweights.from_state_dict(tweights.random_state_dict(PCFG, 3), PCFG)
    return TTSModel(PCFG, params, gen=GenParams(temp=0.0), has_real_weights=False, device="cpu")


@pytest.fixture(scope="module")
def batcher(model):
    b = ContinuousBatcher(model, batch_size=3, chunk_frames=4)
    b.start()
    yield b
    b.stop()


@pytest.fixture
def started(model):
    """A fresh batcher of the given shape, stopped after the test."""
    made = []

    def make(**kw):
        made.append(ContinuousBatcher(model, **kw))
        made[-1].start()
        return made[-1]

    yield make
    for b in made:
        b.stop()


def single(model, text, gen=None, voice=None):
    saved = model.gen
    model.gen = gen or saved
    try:
        return model.generate_with_pauses(text, voice)
    finally:
        model.gen = saved


def assert_close(got, want, what=""):
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=what)


def wait_idle(b, seconds=30):
    deadline = time.monotonic() + seconds
    while not b.idle():
        assert time.monotonic() < deadline, b.stats()
        time.sleep(0.01)


def test_stats_counters(batcher):
    batcher.generate("One more for the counters.")
    s = batcher.stats()
    assert s["requests_completed"] >= 1
    assert s["requests_submitted"] >= s["requests_completed"]
    assert s["frames_decoded"] > 0 and s["dispatches"] > 0
    assert s["active_requests"] == 0 and not s["dead"]


def test_early_retirement_reuses_lane_in_flight(model, started):
    """A lane whose dispatch frontier covers its segment's budget frees at
    once, up to depth chunks before that segment's results are fetched, and
    the next segment's admission writes the lane in place behind them.  With
    one lane and two queued requests that path must run; outputs stay exact."""
    b = started(batch_size=1, chunk_frames=4, depth=2)
    texts = ["First request speaking now.", "Second one talking too."]
    singles = [single(model, t) for t in texts]
    results = [None, None]

    def run(i):
        results[i] = b.generate(texts[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for got, want in zip(results, singles):
        assert got is not None
        assert_close(got, want)
    s = b.stats()
    assert s["early_retirements"] >= 1
    assert s["useful_frames"] > 0
    assert 0.0 < s["useful_ratio"] <= 1.0
    # waste is bounded by the in-flight tail of the last segment (plus
    # per-segment EOS slack), not depth * chunk for each
    assert s["frames_decoded"] - s["useful_frames"] <= len(texts) * 2 * 4 + 2 * 4


def test_decode_frames_rejects_zero_lsd(model):
    eng = model.engine
    with pytest.raises(ValueError, match="lsd_vec"):
        eng.decode_frames(eng.new_state(1), 2, model.gen, torch.Generator(),
                          lsd_vec=np.zeros((1,), np.int32))


def test_warm_ramp_first_chunk_small_audio_identical(model, started):
    """A newly admitted streaming slot gets a small warm chunk first; the ramp
    does not change the audio."""
    b = started(batch_size=2, chunk_frames=8, warm_chunk=2)
    text = "Warm ramp check sentence."
    want = single(model, text, GenParams(temp=0.0, eos_threshold=float("inf")))
    chunks = list(b.stream(text, gen=GenParams(temp=0.0, eos_threshold=float("inf"))))
    assert chunks[0].size == 2 * model.frame_size
    assert_close(np.concatenate(chunks), want)
    assert b.stats()["warm_dispatches"] >= 1


def test_warm_ramp_defaults_on_in_batched_tts(model):
    b = batched_tts(model, batch_size=2, chunk_frames=16)
    try:
        assert b.warm_chunk == 4
        assert b.idle()
        stream = b.stream("Idle probe check.")
        first = next(stream)
        assert first.size <= 4 * model.frame_size  # warm-bounded, not 16
        for _ in stream:
            pass
        wait_idle(b, 10)
    finally:
        b.stop()


def test_streaming_arrival_preempts_nonhead_segment(model, started):
    """A streaming request arriving at full occupancy evicts a NON-HEAD
    segment (a later segment of a request still streaming an earlier one).
    The victim restarts from its prefill and the hog's audio is intact."""
    b = started(batch_size=2, chunk_frames=8, warm_chunk=2)
    hog_gen = GenParams(temp=0.0, eos_threshold=float("inf"))
    sent = "This hog sentence occupies a slot for quite a while longer. "
    hog_q = b.submit(sent * 3, gen=hog_gen, latency_sensitive=False)
    deadline = time.monotonic() + 60
    while b.stats()["frames_decoded"] == 0:  # wait until the hog runs
        assert time.monotonic() < deadline
        time.sleep(0.01)

    stream_text = "Quick streaming arrival."
    got = np.concatenate(list(b.stream(stream_text)))
    assert b.stats()["preemptions"] >= 1
    assert_close(got, single(model, stream_text))

    hog_chunks = []
    while True:
        item = hog_q.get(timeout=120)
        if not isinstance(item, np.ndarray):
            break
        hog_chunks.append(item)
    # in float32 on the CPU the restarted segment stays within the bound of
    # its single stream (the JAX test allows bf16-style lane drift instead)
    assert_close(np.concatenate(hog_chunks), single(model, sent * 3, hog_gen))


def test_stream_abandon_cancels_request(model, started):
    """Abandoning a stream iterator retires the request's remaining segments,
    and the batcher keeps serving."""
    b = started(batch_size=2, chunk_frames=4)
    sent = "A long cancelled stream holds slots for quite a while. "
    it = b.stream(sent * 3, gen=GenParams(temp=0.0, eos_threshold=float("inf")))
    next(it)
    it.close()  # disconnect
    wait_idle(b)
    assert b.stats()["requests_cancelled"] == 1
    assert_close(b.generate("After the cancellation."), single(model, "After the cancellation."))


def test_whole_wav_requests_skip_latency_policy(started):
    b = started(batch_size=2, chunk_frames=8, warm_chunk=2)
    b.generate("Pure throughput path please.")
    st = b.stats()
    assert st["warm_dispatches"] == 0
    assert st["serve_dispatches"] == 0
    assert st["dispatches"] > 0


def test_chunk_policy_matrix(model):
    """The chunk-size / depth policy (see ``_chunk_policy``)."""
    b = ContinuousBatcher(model, batch_size=4, chunk_frames=64, warm_chunk=8)

    def slot(ramp, latency_sensitive, dispatched, frames_routed=None):
        req = _Request(voice=None, gen=None, out=queue.Queue(),
                       latency_sensitive=latency_sensitive)
        s = _Slot()
        s.segment = _Segment(req, 0, "text", ramp=ramp)
        s.dispatched = dispatched
        s.segment.frames_routed = dispatched if frames_routed is None else frames_routed
        return s

    assert b._chunk_policy([slot(True, True, 0)], 0) == (8, 0, True)
    assert b._chunk_policy([slot(True, True, 8)], 0) == (8, 1, True)
    assert b._chunk_policy([slot(True, True, 64)], 0) == (32, 1, False)
    assert b._chunk_policy([slot(False, False, 0)], 0) == (64, 2, False)
    assert b._chunk_policy([slot(True, True, 0)], 5, 5) == (64, 2, False)  # saturated
    assert b._chunk_policy([slot(True, True, 0)], 4, 4) == (8, 0, True)
    assert b._chunk_policy([slot(True, True, 0)], 20, 0) == (8, 0, True)
    assert b._chunk_policy([slot(True, True, 64)], 1, 1) == (16, 1, False)  # pressure
    assert b._chunk_policy([slot(False, False, 64)], 1, 1) == (16, 1, False)
    assert b._chunk_policy([slot(False, False, 64)], 3, 0) == (64, 2, False)
    assert b._chunk_policy([slot(True, True, 64)], 3, 0) == (32, 1, False)


def test_stop_fails_open(model):
    """stop() strands no consumer and accepts no new submissions."""
    b = ContinuousBatcher(model, batch_size=2, chunk_frames=4)
    b.start()
    out = b.submit("A sentence that will outlive the batcher by a lot.",
                   latency_sensitive=False)
    b.stop()
    while True:
        if out.get(timeout=5.0) is _SENTINEL:
            break
    with pytest.raises(RuntimeError, match="crashed|restart"):
        b.submit("too late")


def test_concurrent_chaos(started):
    """Whole-WAV generates, streams abandoned mid-audio and submit-then-cancel
    from more threads than cores, with a short switch interval: no errors,
    no hangs, and the accounting balances."""
    b = started(batch_size=3, chunk_frames=4, warm_chunk=2)
    n_workers = max(4, (os.cpu_count() or 1) + 1)
    texts = ["Short one.", "A slightly longer sentence for chaos testing here.",
             "Two segments, even. [pause:100ms] After a pause."]
    errors, done = [], [0]

    def worker(i):
        r = random.Random(i)
        try:
            for _ in range(3):
                mode = r.random()
                t = texts[r.randrange(len(texts))]
                if mode < 0.4:
                    b.generate(t, pauses=True)
                elif mode < 0.8:
                    it = b.stream(t)
                    for _chunk in it:
                        if r.random() < 0.3:
                            it.close()  # abandon mid-stream -> cancel
                            break
                else:
                    out = b.submit(t)
                    b._cancel(out._pocket_request)
                done[0] += 1
        except Exception as e:  # noqa: BLE001
            errors.append((i, repr(e)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads), "worker hung"
    assert done[0] == 3 * n_workers
    wait_idle(b)
    st = b.stats()
    assert st["requests_submitted"] == st["requests_completed"] + st["requests_cancelled"]


# -- generate_batch (tests/test_batcher.py:629-708) ---------------------------


def test_generate_batch_matches_single(model, batcher):
    texts = ["Batch item number one.", "Batch item number two.",
             "Batch item number three, a little longer than the others."]
    singles = [single(model, t) for t in texts]
    results = batcher.generate_batch(texts)
    assert len(results) == 3
    for i, (got, want) in enumerate(zip(results, singles)):
        assert_close(got, want, f"item {i}")
    gens = [None, GenParams(temp=0.0, lsd_decode_steps=2), None]
    varied = batcher.generate_batch(texts, gens=gens)
    assert_close(varied[0], singles[0])
    assert_close(varied[1], single(model, texts[1], gens[1]))
    assert varied[1].shape != singles[1].shape or not np.allclose(varied[1], singles[1],
                                                                  atol=TOL)


def test_generate_batch_exceptions(model, batcher):
    texts = ["A valid first utterance.", "   ", "A valid third utterance."]
    results = batcher.generate_batch(texts, return_exceptions=True)
    assert isinstance(results[1], ValueError)
    assert_close(results[0], single(model, texts[0]))
    assert results[2].size > 0
    seen = []
    with pytest.raises(ValueError):
        batcher.generate_batch(texts, on_result=lambda i, r: seen.append(i))
    assert batcher.generate("Still alive after the failure.").size > 0


def test_generate_batch_shared_and_list_voices(model, batcher):
    vs = model.get_voice_state()
    texts = ["Shared voice item.", "Second shared item."]
    shared = batcher.generate_batch(texts, voices=vs)
    listed = batcher.generate_batch(texts, voices=[vs, None])
    for got, want in zip(shared, listed):
        assert_close(got, want)
    with pytest.raises(ValueError, match="voices has 1"):
        batcher.generate_batch(texts, voices=[vs])


def test_generate_batch_many_items_soak(batcher):
    """n >> batch_size with failures and collect=False: input order kept,
    audio dropped after on_result, failed items stay failed, no leak."""
    n = 12
    texts = [f"Soak item number {i}." if i % 4 != 2 else "   " for i in range(n)]
    order = []

    def on_result(i, res):
        order.append(i)
        if i % 4 == 2:
            assert isinstance(res, ValueError), i
        else:
            assert isinstance(res, np.ndarray) and res.size > 0, i

    results = batcher.generate_batch(texts, return_exceptions=True, on_result=on_result,
                                     collect=False)
    assert order == list(range(n))
    for i, r in enumerate(results):
        assert isinstance(r, ValueError) if i % 4 == 2 else r is None, i
    assert batcher.stats()["active_requests"] == 0
    assert batcher.generate("Post-soak sanity utterance.").size > 0


def test_warmup_runs_every_chunk_size(model):
    """warmup() dispatches each chunk size the loop can choose on a throwaway
    state, without starting the loop."""
    b = ContinuousBatcher(model, batch_size=2, chunk_frames=16, warm_chunk=4)
    frames = b.engine.frames_decoded
    b.warmup()
    # warm 4 + press 4 (= max(4, 8 // 2)) + serve 8 + throughput 16, then a
    # per-slot-step dispatch at the warm chunk
    assert b.engine.frames_decoded - frames == 4 + 8 + 16 + 4
    assert b.stats()["dispatches"] == 0 and b.idle()
