"""flow_lm.prefill_ms_p50: the median, over the requests whose text prefill
ended in the counter window, of that prefill's milliseconds (the program's
``flow_lm.prefill`` spans of the request, added where a request has several
segments; the voice prefills of set-up belong to no request)."""

from harness import spans
from harness.stats import percentile


def read(ctx):
    recs = spans.named(ctx, "flow_lm.prefill")
    per_request: dict[int, float] = {}
    for rid, s, e, _ in recs or []:
        if rid:
            per_request[rid] = per_request.get(rid, 0.0) + 1000.0 * (e - s)
    return percentile(list(per_request.values()), 50) if per_request else None
