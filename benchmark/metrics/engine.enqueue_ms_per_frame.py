"""engine.enqueue_ms_per_frame: the program's ``engine.frames`` spans (the
host's frame loops, which enqueue each frame's launches) that ended in the
counter window: their summed milliseconds over their frames (the spans'
``n``, the frames added to ``frames_decoded``)."""

from harness import spans


def read(ctx):
    recs = spans.named(ctx, "engine.frames")
    if not recs or not spans.frames(recs):
        return None
    return 1000.0 * spans.seconds(recs) / spans.frames(recs)
