"""orchestrator.kept_ratio: frames the program's ``tts.fetch`` spans emitted
to the caller over the frames its ``engine.frames`` spans decoded, both
counted by the program over the counter window: the share of decoded
frames not cut off past a segment's budget."""

from harness import spans


def read(ctx):
    fetches, loops = spans.named(ctx, "tts.fetch"), spans.named(ctx, "engine.frames")
    if not fetches or not loops or not spans.frames(loops):
        return None
    return 100.0 * spans.frames(fetches) / spans.frames(loops)
