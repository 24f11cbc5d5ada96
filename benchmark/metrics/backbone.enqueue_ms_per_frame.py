"""backbone.enqueue_ms_per_frame: the program's ``flow_lm.backbone`` spans
(the host enqueueing one frame's backbone layer stack, n: its lanes) that
ended in the counter window: their summed milliseconds over their
lane-frames."""

from harness import spans


def read(ctx):
    recs = spans.named(ctx, "flow_lm.backbone")
    if not recs or not spans.frames(recs):
        return None
    return 1000.0 * spans.seconds(recs) / spans.frames(recs)
