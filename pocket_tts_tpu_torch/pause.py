"""Pause handling (copy of ``pocket_tts_tpu/pause.py``, which the port
cannot import): explicit ``[pause:Xms]`` / ``[pause:Xs]`` markers plus
natural pauses (ellipsis 500 ms, comma 200 ms unless between two digits).

Explicit markers are replaced by a single space; natural punctuation stays in
the clean text but the segmenter skips it, so commas and ellipses become
silence.
"""

from __future__ import annotations

import dataclasses
import re

ELLIPSIS_MS = 500
COMMA_MS = 200

_EXPLICIT_RE = re.compile(r"\[pause:(\d+(?:\.\d+)?)(ms|s)\]")
_ELLIPSIS_RE = re.compile(r"\.{3,}")


@dataclasses.dataclass
class PauseMarker:
    original: str
    duration_ms: int
    position: int  # offset in clean text


@dataclasses.dataclass
class ParsedText:
    clean_text: str
    pauses: list[PauseMarker]


@dataclasses.dataclass
class Segment:
    kind: str  # "text" | "pause"
    text: str = ""
    duration_ms: int = 0


def parse_explicit_pauses(text: str) -> list[PauseMarker]:
    out = []
    for m in _EXPLICIT_RE.finditer(text):
        value = float(m.group(1))
        ms = int(value) if m.group(2) == "ms" else int(value * 1000)
        out.append(PauseMarker(m.group(0), ms, m.start()))
    return out


def parse_natural_pauses(text: str) -> list[PauseMarker]:
    pauses = []
    for m in _ELLIPSIS_RE.finditer(text):
        pauses.append(PauseMarker(m.group(0), ELLIPSIS_MS, m.start()))
    for i, c in enumerate(text):
        if c == ",":
            prev_digit = i > 0 and text[i - 1].isdigit()
            next_digit = i + 1 < len(text) and text[i + 1].isdigit()
            if not (prev_digit and next_digit):
                pauses.append(PauseMarker(",", COMMA_MS, i))
    pauses.sort(key=lambda p: p.position)
    return pauses


def strip_pause_markers(text: str) -> str:
    return _EXPLICIT_RE.sub(" ", text)


def parse_text_with_pauses(text: str) -> ParsedText:
    clean = strip_pause_markers(text)
    pauses = parse_natural_pauses(clean)

    # explicit markers, with positions recomputed in the clean text (each
    # marker was replaced by one space)
    offset = 0
    for marker in parse_explicit_pauses(text):
        pos = max(marker.position - offset, 0)
        if marker.duration_ms > 0:
            pauses.append(PauseMarker(marker.original, marker.duration_ms, pos))
        offset += len(marker.original) - 1
    pauses.sort(key=lambda p: p.position)
    return ParsedText(clean, pauses)


def segment_text(text: str) -> list[Segment]:
    """Interleave text and pause segments in order."""
    parsed = parse_text_with_pauses(text)
    segments: list[Segment] = []
    last = 0
    for p in parsed.pauses:
        if p.position > last:
            seg = parsed.clean_text[last:p.position]
            if seg.strip():
                segments.append(Segment("text", text=seg))
        segments.append(Segment("pause", duration_ms=p.duration_ms))
        if p.original.startswith("[pause:"):
            last = p.position + 1  # marker became a single space
        else:
            last = p.position + len(p.original)
    if last < len(parsed.clean_text):
        seg = parsed.clean_text[last:]
        if seg.strip():
            segments.append(Segment("text", text=seg))
    return segments


def silence_samples(duration_ms: int, sample_rate: int) -> int:
    return (duration_ms * sample_rate) // 1000
