"""The readers of the program's spans (``harness/spans.py``,
``systems/pocket_tts_torch_spans.py`` and the five metrics that read them)
in a ``--trace 1`` rehearsal of the tiny single-stream cell on the CPU, and
the same run against a program that records no spans, where they report
nothing and raise nothing."""

from __future__ import annotations

import types

import run

NEW = ("engine.enqueue_ms_per_frame", "orchestrator.fetch_wait_ms_per_frame",
       "orchestrator.kept_ratio", "orchestrator.setup_ms_p50", "orchestrator.first_chunk_ms_p50")


def once(base, trace=1, seed=2 ** 32 + 17):
    args = types.SimpleNamespace(workload="tiny-stream", seed=seed, seconds=2.0, trace=trace)
    return run.run(args, device="cpu", manifest_path=base / "BENCHMARK.json", base=base)


def test_a_traced_run_reports_the_span_metrics_with_sane_values(tiny_base):
    code, result, lines = once(tiny_base)
    assert code == 0 and result["correct"], lines
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(NEW) <= set(m), sorted(m)
    assert 0 < m["orchestrator.kept_ratio"] <= 100
    assert 0 < m["engine.enqueue_ms_per_frame"] <= m["engine.ms_per_step"]
    assert 0 <= m["orchestrator.fetch_wait_ms_per_frame"] < m["engine.ms_per_step"]
    assert 0 < m["orchestrator.setup_ms_p50"] <= m["orchestrator.first_chunk_ms_p50"]
    assert {result["metrics"][k]["unit"] for k in NEW} == {"ms", "%"}


def test_without_the_programs_spans_the_readers_report_nothing(tiny_base, monkeypatch):
    from systems import pocket_tts_torch_spans

    monkeypatch.setattr(pocket_tts_torch_spans, "_utils", lambda: None)
    code, result, lines = once(tiny_base)
    assert code == 0 and result["correct"], lines
    assert not set(NEW) & set(result["metrics"])
    assert {"engine.ms_per_step", "orchestrator.useful_ratio"} <= set(result["metrics"])
