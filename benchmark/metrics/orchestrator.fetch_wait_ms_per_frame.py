"""orchestrator.fetch_wait_ms_per_frame: the summed milliseconds of the
program's ``tts.fetch`` spans (a chunk's device-to-host copies, the one host
wait, and the stop rule) that ended in the counter window, over the frames
of the ``engine.frames`` spans of the same window."""

from harness import spans


def read(ctx):
    fetches, loops = spans.named(ctx, "tts.fetch"), spans.named(ctx, "engine.frames")
    if not fetches or not loops or not spans.frames(loops):
        return None
    return 1000.0 * spans.seconds(fetches) / spans.frames(loops)
