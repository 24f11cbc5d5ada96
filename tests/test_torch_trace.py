"""The port's span recorder (``pocket_tts_tpu_torch/utils.py``) and the spans
the hot path records: nesting, request ids, the bounded ring, totals under
two recording threads, the end-time clip of ``spans``, ``record_function``
only while a profiler records, the chrome trace against the ring (one
user-annotation event per span, durations within 5% + 50 us: the shared
clock), and on the small config of tests/test_tts.py the spans of
``generate_stream`` / ``generate``, of a started batcher and the two
``/metrics`` counters."""

import dataclasses
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from pocket_tts_tpu_torch import utils
from pocket_tts_tpu_torch import weights as tweights
from pocket_tts_tpu_torch.config import config_from_dict
from pocket_tts_tpu_torch.runtime.batcher import batched_tts
from pocket_tts_tpu_torch.runtime.engine import GenParams
from pocket_tts_tpu_torch.server import app
from pocket_tts_tpu_torch.tts import TTSModel
from tests.test_tts import CFG

PCFG = config_from_dict(dataclasses.asdict(CFG))
ID, PARENT, REQUEST, NAME, START, END, N = range(7)


@pytest.fixture(scope="module")
def model():
    params = tweights.from_state_dict(tweights.random_state_dict(PCFG, 0), PCFG)
    return TTSModel(PCFG, params, gen=GenParams(temp=0.0), has_real_weights=False,
                    device="cpu", seed=0)


def _window(fn):
    """Run ``fn``, which starts one request; (its result, the ring records of
    that request that ended meanwhile).  Spans of other threads are left out."""
    t0 = time.perf_counter()
    out = fn()
    t1 = time.perf_counter()
    ((rid, _),) = utils.requests(t0, t1)
    return out, [r for r in utils.spans(t0, t1) if r[REQUEST] == rid]


# -- the recorder ----------------------------------------------------------------------


def test_nesting_sets_parents_and_a_request_shares_its_id():
    rec = utils.SpanRecorder()
    rid = rec.new_request()
    with rec.span("outer", request=rid) as outer:
        with rec.span("inner", 3) as inner:
            rec.record("queued", time.perf_counter_ns() - 1000, 1, rid)
            inner.n = 5
    with rec.span("alone"):
        pass
    by = {r[NAME]: r for r in rec.spans(0, float("inf"))}
    assert by["inner"][PARENT] == outer.id and by["queued"][PARENT] == inner.id
    assert by["outer"][PARENT] == by["alone"][PARENT] == 0
    assert by["outer"][REQUEST] == by["inner"][REQUEST] == by["queued"][REQUEST] == rid
    assert by["alone"][REQUEST] == 0 and by["inner"][N] == 5
    assert all(r[START] <= r[END] for r in by.values())
    assert [r[0] for r in rec.requests(0, float("inf"))] == [rid]
    assert list(by) == ["queued", "inner", "outer", "alone"]  # in order of their ends


def test_the_ring_stays_bounded_and_the_totals_count_everything():
    rec = utils.SpanRecorder(size=16)
    for i in range(100):
        with rec.span("s", i):
            pass
    ring = rec.spans(0, float("inf"))
    assert len(ring) == 16 and [r[N] for r in ring] == list(range(84, 100))
    totals = rec.span_totals()["s"]
    assert totals["count"] == 100 and totals["n"] == sum(range(100)) and totals["seconds"] >= 0


def test_the_totals_stay_right_under_two_recording_threads():
    rec = utils.SpanRecorder(size=64)
    per_thread, errors = 4000, []

    def work(name):
        try:
            for _ in range(per_thread):
                with rec.span(name, 2) as outer:
                    with rec.span(name + ".inner", 1) as inner:
                        pass
                    if inner.parent != outer.id:  # the parent is this thread's span
                        errors.append((outer.id, inner.parent))
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(f"t{i}",)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors[:3]
    totals = rec.span_totals()
    for i in range(2):
        assert totals[f"t{i}"]["count"] == per_thread and totals[f"t{i}"]["n"] == 2 * per_thread
        assert totals[f"t{i}.inner"]["count"] == totals[f"t{i}.inner"]["n"] == per_thread
    assert len(rec.spans(0, float("inf"))) == 64


def test_spans_clip_by_end_time():
    rec = utils.SpanRecorder()
    t0 = time.perf_counter()
    with rec.span("long"):
        time.sleep(0.002)
        mid = time.perf_counter()
        with rec.span("short"):
            pass
        time.sleep(0.002)
    t1 = time.perf_counter()
    assert [r[NAME] for r in rec.spans(t0, mid)] == []
    assert [r[NAME] for r in rec.spans(mid, t1)] == ["short", "long"]
    assert [r[NAME] for r in rec.spans(t0, t1)] == ["short", "long"]
    assert rec.spans(t1, t1 + 1.0) == [] and rec.requests(t0, t1) == []


def test_record_function_is_called_only_while_a_profiler_records(monkeypatch):
    real, calls = torch.profiler.record_function, []

    def counting(name, args=None):
        calls.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    rec = utils.SpanRecorder()
    with rec.span("off"):
        pass
    assert calls == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with rec.span("on", request=7):
            pass
    assert calls == [("on", "request=7")]
    with rec.span("off again"):
        pass
    assert len(calls) == 1 and rec.span_totals()["off again"]["count"] == 1


def test_the_chrome_trace_holds_every_span_with_its_duration(tmp_path):
    """The shared clock: under ``profiler_trace`` every span of the block is a
    user annotation of the same name, as long as the ring says."""
    with torch.profiler.record_function("warm"):  # its ops' first lookup, outside
        pass
    t0 = time.perf_counter()
    with utils.profiler_trace(tmp_path, device="cpu"):
        for i in range(3):  # spans of 10-40 ms: a preempted clock read seldom tops 5%
            with utils.span("trace_test.outer", i):
                time.sleep(0.01 * (i + 1))
                with utils.span("trace_test.inner"):
                    time.sleep(0.01)
                    torch.ones(64, 64) @ torch.ones(64, 64)
    ring = [r for r in utils.spans(t0, time.perf_counter()) if r[NAME].startswith("trace_test.")]
    (path,) = tmp_path.glob("trace_*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e["name"].startswith("trace_test.")]
    assert sorted(e["name"] for e in events) == sorted(r[NAME] for r in ring) and len(ring) == 6
    for name in ("trace_test.outer", "trace_test.inner"):  # paired in order of start
        ours = [(r[END] - r[START]) / 1e3 for r in sorted(ring, key=lambda r: r[START])
                if r[NAME] == name]  # us
        theirs = [float(e["dur"]) for e in sorted(events, key=lambda e: float(e["ts"]))
                  if e["name"] == name]
        for a, b in zip(ours, theirs):
            assert abs(a - b) <= 0.05 * a + 50.0, (name, ours, theirs)


# -- the spans of the hot path -----------------------------------------------------------


@pytest.mark.parametrize("entry", ["generate_stream", "generate"])
def test_a_request_records_the_orchestrator_and_engine_spans(model, entry):
    """``generate_stream`` runs the chunk schedule (``decode_frames``),
    ``generate`` the fused segment (``decode_segment``)."""
    before = model.engine.frames_decoded
    text = "Hello there friend. And a second sentence."

    def go():
        if entry == "generate":
            return model.generate(text)
        return np.concatenate(list(model.generate_stream(text)))

    audio, recs = _window(go)
    names = {r[NAME] for r in recs}
    assert {"tts.setup", "tts.dispatch", "engine.frames", "engine.codec", "tts.fetch"} <= names

    def total(name):
        return sum(r[N] for r in recs if r[NAME] == name)

    assert total("engine.frames") == model.engine.frames_decoded - before > 0
    assert total("tts.fetch") == audio.size // model.frame_size > 0
    assert total("tts.setup") == sum(r[NAME] == "tts.setup" for r in recs) >= 1  # n 1 each
    assert total("tts.dispatch") >= total("engine.frames")
    ids = {r[ID]: r for r in recs}
    for r in recs:
        if r[NAME].startswith("engine."):
            assert ids[r[PARENT]][NAME] == "tts.dispatch"
        else:
            assert r[PARENT] == 0
    assert len(recs) <= 3 * total("engine.frames")


def test_a_started_batcher_records_its_spans(model):
    batcher = batched_tts(model, batch_size=2, chunk_frames=4)
    try:
        before = batcher.stats()["frames_decoded"]
        t0 = time.perf_counter()
        audio = batcher.generate("Hi there my friend.")
        t1 = time.perf_counter()
        frames = batcher.stats()["frames_decoded"] - before
        ((rid, _),) = utils.requests(t0, t1)
        deadline = t1 + 30.0  # the loop polls while no slot is active
        while not any(r[NAME] == "batcher.idle" for r in utils.spans(t1, time.perf_counter())):
            assert time.perf_counter() < deadline, "no batcher.idle span"
            time.sleep(0.01)
    finally:
        batcher.stop()
    recs = utils.spans(t0, time.perf_counter())  # the loop's last route ends after t1
    assert audio.size > 0

    def named(name):
        return [r for r in recs if r[NAME] == name]

    assert len(named("batcher.queue")) == len(named("batcher.admit")) >= 1
    assert {r[REQUEST] for r in named("batcher.queue") + named("batcher.admit")} == {rid}
    assert sum(r[N] for r in named("batcher.dispatch")) == frames > 0
    assert sum(r[N] for r in named("batcher.route")) == audio.size // model.frame_size
    assert {"engine.frames", "engine.codec"} <= {r[NAME] for r in recs}


@pytest.mark.parametrize("with_batcher", [False, True])
def test_metrics_text_carries_both_span_counters(model, with_batcher):
    batcher = batched_tts(model, batch_size=2, chunk_frames=4) if with_batcher else None
    try:
        with utils.span("metrics_test.span", 4):
            pass
        state = app.ServerState(model, batcher=batcher)
        text = app.metrics_text(state)
        state.pool.shutdown()
    finally:
        if batcher is not None:
            batcher.stop()
    lines = text.splitlines()
    assert "# TYPE pocket_tts_span_seconds_total counter" in lines
    assert "# TYPE pocket_tts_span_count_total counter" in lines
    count = utils.span_totals()["metrics_test.span"]["count"]
    assert f'pocket_tts_span_count_total{{span="metrics_test.span"}} {count}' in lines
    assert any(line.startswith('pocket_tts_span_seconds_total{span="metrics_test.span"} ')
               for line in lines)
    assert ("pocket_tts_batcher_dead 0" in lines) == with_batcher
