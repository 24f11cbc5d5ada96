"""The program's span ring (``pocket_tts_tpu_torch.utils``), read for the
per-layer readers through ``harness/spans.py``: the twin of
``pocket_tts_torch.py`` that reads what the program recorded.  A program
without the ring (an older checkout) gives None, never an error."""

from __future__ import annotations


def _utils():
    from pocket_tts_tpu_torch import utils

    return utils if hasattr(utils, "spans") and hasattr(utils, "requests") else None


def spans(t0: float, t1: float) -> list[tuple] | None:
    """``(request, name, start_s, end_s, n)`` of every span that ended inside
    ``[t0, t1]`` (``time.perf_counter`` seconds), oldest first."""
    utils = _utils()
    if utils is None:
        return None
    return [(rid, name, s / 1e9, e / 1e9, n)
            for _, _, rid, name, s, e, n in utils.spans(t0, t1)]


def request_starts(t0: float, t1: float) -> dict[int, float] | None:
    """``{request: start_s}`` of the requests started inside ``[t0, t1]``."""
    utils = _utils()
    if utils is None:
        return None
    return {rid: s / 1e9 for rid, s in utils.requests(t0, t1)}
