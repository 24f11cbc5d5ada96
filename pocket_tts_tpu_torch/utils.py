"""Observability utilities (port of ``pocket_tts_tpu/utils.py``): execution
timers, per-chunk decode statistics and ``torch.profiler`` tracing.  No
module on the hot path calls them; they wrap a caller's own code."""

from __future__ import annotations

import contextlib
import logging
import statistics
import tempfile
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


class StepStats:
    """Rolling per-chunk decode statistics."""

    def __init__(self):
        self.chunk_ms: list[float] = []
        self.frames: list[int] = []

    def record(self, wall_ms: float, n_frames: int) -> None:
        self.chunk_ms.append(wall_ms)
        self.frames.append(n_frames)

    @property
    def total_frames(self) -> int:
        return sum(self.frames)

    def summary(self) -> dict:
        if not self.chunk_ms:
            return {}
        total_ms = sum(self.chunk_ms)
        frames = max(self.total_frames, 1)
        return {
            "chunks": len(self.chunk_ms),
            "frames": frames,
            "mean_chunk_ms": round(statistics.mean(self.chunk_ms), 2),
            "ms_per_frame": round(total_ms / frames, 3),
            "x_realtime": round(frames * 80.0 / max(total_ms, 1e-9), 1),
        }

    def log(self) -> None:
        s = self.summary()
        if s:
            logger.info("decode stats: %s", s)
