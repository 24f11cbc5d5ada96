"""Observability utilities (port of ``pocket_tts_tpu/utils.py``): execution
timers, ``torch.profiler`` tracing, and the span recorder the hot path
writes to.

Spans: ``with span("engine.frames") as s: ...; s.n = frames`` records
``(id, parent id, request id, name, start_ns, end_ns, n)`` on
``time.perf_counter_ns`` into a bounded in-memory ring (the flight recorder,
the last ``RING_SIZE`` spans) and adds to running totals per name (count,
seconds, ``n``).  The parent is the span open around it on the same thread;
the request id is given, or the parent's, and ``new_request()`` makes one at
a request's entry point.  Both are always on: with no profiler a span costs
two clock reads, one append and the totals under a lock.  While a
``torch.profiler`` records, each span also opens
``torch.profiler.record_function(name)``, so it lands in the same trace as
the kernels, on that trace's clock (the profiler records the ranges of the
threads it profiles: the one that started it, unless it profiles all).
Readers: ``spans(t0, t1)``, ``requests(t0, t1)`` and ``span_totals()``."""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import tempfile
import threading
import time
from pathlib import Path

import torch

logger = logging.getLogger(__name__)


class Timer:
    def __init__(self):
        self.elapsed_ms = 0.0


@contextlib.contextmanager
def display_execution_time(label: str, print_output: bool = True):
    """``with display_execution_time("Prompting text") as t:`` logs the wall
    ms of the block and leaves them in ``t.elapsed_ms``.  Work enqueued on a
    card inside the block is counted only as far as the block waits for
    it."""
    t = Timer()
    t0 = time.monotonic()
    try:
        yield t
    finally:
        t.elapsed_ms = (time.monotonic() - t0) * 1000.0
        if print_output:
            logger.info("%s took %d ms", label, int(t.elapsed_ms))


@contextlib.contextmanager
def profiler_trace(log_dir: str | Path | None = None, device: torch.device | str = "cuda"):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when ``device`` is a card) and write a chrome trace
    (``trace_<ns>.json``, open with Perfetto or chrome://tracing) into
    ``log_dir`` (default: ``pocket_tts_trace`` in the temp directory).
    Yields the directory.  A CUDA ``device`` with no card visible raises."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("profiler_trace: device 'cuda' but no CUDA device is visible; "
                               "pass device=\"cpu\" to trace the CPU")
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir or Path(tempfile.gettempdir()) / "pocket_tts_trace")
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize()  # the block's kernels end inside the window
    path = log_dir / f"trace_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    logger.info("profiler trace written to %s", path)


# -- spans ---------------------------------------------------------------------------

RING_SIZE = 65536


class _Span:
    """One open span; ``n`` may be set inside the block."""

    __slots__ = ("_rec", "name", "n", "request", "id", "parent", "_t0", "_rf")

    def __init__(self, rec: "SpanRecorder", name: str, n: int, request: int | None):
        self._rec, self.name, self.n, self.request = rec, name, n, request

    def __enter__(self) -> "_Span":
        stack = self._rec._stack()
        self.parent, parent_request = stack[-1] if stack else (0, 0)
        if self.request is None:
            self.request = parent_request
        self.id = next(self._rec._span_ids)
        stack.append((self.id, self.request))
        # the clock reads bracket the profiler's range, which then lies inside
        # the record
        self._t0 = time.perf_counter_ns()
        self._rf = None
        if torch.autograd.profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name, f"request={self.request}")
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._rf is not None:
            self._rf.__exit__(*exc)
        t1 = time.perf_counter_ns()
        self._rec._stack().pop()
        self._rec._add(self.id, self.parent, self.request, self.name, self._t0, t1, self.n)


class SpanRecorder:
    """The ring of span records, the request starts and the totals per name;
    safe to write from several threads.  The module's functions use one
    process-wide recorder."""

    def __init__(self, size: int = RING_SIZE):
        self._ring: collections.deque = collections.deque(maxlen=size)
        self._requests: collections.deque = collections.deque(maxlen=size)
        self._totals: dict[str, list[int]] = {}
        self._lock = threading.Lock()
        self._span_ids = itertools.count(1)
        self._request_ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, sid: int, parent: int, request: int, name: str, start_ns: int, end_ns: int,
             n: int) -> None:
        with self._lock:
            self._ring.append((sid, parent, request, name, start_ns, end_ns, n))
            t = self._totals.get(name)
            if t is None:
                t = self._totals[name] = [0, 0, 0]
            t[0] += 1
            t[1] += end_ns - start_ns
            t[2] += n

    def new_request(self) -> int:
        """A new request id, its start time kept beside it."""
        rid = next(self._request_ids)
        with self._lock:
            self._requests.append((rid, time.perf_counter_ns()))
        return rid

    def span(self, name: str, n: int = 0, request: int | None = None) -> _Span:
        """A context manager recording the block as span ``name`` (request:
        the enclosing span's when None)."""
        return _Span(self, name, n, request)

    def record(self, name: str, start_ns: int, n: int = 0, request: int = 0) -> None:
        """A span from ``start_ns`` (taken earlier on ``perf_counter_ns``, as
        a queue's submit time) to now, under the span open on this thread."""
        stack = self._stack()
        self._add(next(self._span_ids), stack[-1][0] if stack else 0, request, name, start_ns,
                  time.perf_counter_ns(), n)

    def spans(self, t0: float, t1: float) -> list[tuple]:
        """The records that ended inside ``[t0, t1]`` (``perf_counter``
        seconds), oldest first: ``(id, parent, request, name, start_ns,
        end_ns, n)``."""
        lo, hi = t0 * 1e9, t1 * 1e9
        with self._lock:
            ring = list(self._ring)
        return [r for r in ring if lo <= r[5] <= hi]

    def requests(self, t0: float, t1: float) -> list[tuple[int, int]]:
        """``(request id, start_ns)`` of the requests started inside ``[t0, t1]``."""
        lo, hi = t0 * 1e9, t1 * 1e9
        with self._lock:
            starts = list(self._requests)
        return [r for r in starts if lo <= r[1] <= hi]

    def span_totals(self) -> dict[str, dict]:
        """``{name: {"count", "seconds", "n"}}`` since the process started."""
        with self._lock:
            return {k: {"count": c, "seconds": ns / 1e9, "n": n}
                    for k, (c, ns, n) in self._totals.items()}


_RECORDER = SpanRecorder()
span = _RECORDER.span
record = _RECORDER.record
new_request = _RECORDER.new_request
spans = _RECORDER.spans
requests = _RECORDER.requests
span_totals = _RECORDER.span_totals
