"""orchestrator.first_chunk_ms_p50: the median, over the requests the program
started in the counter window, of the time from the request's start
(``utils.new_request``) to the end of its first ``tts.fetch`` that emitted
frames: first audio as the program sees it."""

from harness import spans
from harness.stats import percentile


def read(ctx):
    ms = spans.first_chunk_ms(ctx)
    return percentile(ms, 50) if ms else None
