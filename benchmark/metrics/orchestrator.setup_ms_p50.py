"""orchestrator.setup_ms_p50: the median duration of the program's
``tts.setup`` spans (a segment's text preparation, tokens, cache reset,
text prefill and generator) that ended in the counter window."""

from harness import spans
from harness.stats import percentile


def read(ctx):
    recs = spans.named(ctx, "tts.setup")
    return percentile([1000.0 * (e - s) for _, s, e, _ in recs], 50) if recs else None
