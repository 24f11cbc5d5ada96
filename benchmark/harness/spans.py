"""The program's own spans for the per-layer readers: the records that ended
inside the counter window (the part of a traced run before the profiler
opens, so its slowdown stays out), read through the configuration's system
module's ``_spans`` twin (``systems/<system>_spans.py``).  Each reader gets
None where the program records no spans."""

from __future__ import annotations

import importlib
import math


def _source(ctx):
    return importlib.import_module(ctx.cfg["system"].removesuffix(".py").replace("/", ".")
                                   + "_spans")


def counter_window(ctx) -> tuple[float, float]:
    return ctx.window[0], ctx.window[0] + ctx.counter_seconds


def named(ctx, name: str, t1: float | None = None) -> list[tuple] | None:
    """``(request, start_s, end_s, n)`` of the spans ``name`` that ended in
    the counter window (up to ``t1`` when given); None without spans."""
    t0, end = counter_window(ctx)
    recs = _source(ctx).spans(t0, end if t1 is None else t1)
    if recs is None:
        return None
    return [(rid, s, e, n) for rid, nm, s, e, n in recs if nm == name]


def request_starts(ctx) -> dict[int, float] | None:
    """``{request: start_s}`` of the requests the program started in the
    counter window."""
    return _source(ctx).request_starts(*counter_window(ctx))


def seconds(recs) -> float:
    return sum(e - s for _, s, e, _ in recs)


def frames(recs) -> int:
    return sum(n for _, _, _, n in recs)


def first_chunk_ms(ctx) -> list[float]:
    """Each request started in the counter window: its start to the end of
    its first ``tts.fetch`` that emitted frames, in ms."""
    starts = request_starts(ctx)
    fetches = named(ctx, "tts.fetch", math.inf)
    if not starts or not fetches:
        return []
    first: dict[int, float] = {}
    for rid, _, e, n in fetches:
        if n > 0 and rid in starts and rid not in first:
            first[rid] = e
    return [1000.0 * (first[rid] - s) for rid, s in starts.items() if rid in first]
