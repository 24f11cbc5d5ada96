"""lfm2_step.mfu: model FLOPs of the lane-frames decoded in the counter
window with LFM2-MoE as the backbone (its active products, attention at the
mean cache position of the delivered frames, the flow net per LSD step, the
Mimi decoder; ``costs_lfm2.lane_frame_flops``), over the window's seconds
times the H100's dense bf16 peak."""

from harness import costs_lfm2


def read(ctx):
    d = ctx.counters
    if not d["lane_frames"] or ctx.mean_pos is None or not hasattr(ctx.sizes, "expert_ff"):
        return None
    flops = d["lane_frames"] * costs_lfm2.lane_frame_flops(ctx.sizes, ctx.mean_pos,
                                                           ctx.lsd_steps)
    return 100.0 * flops / (ctx.counter_seconds * costs_lfm2.PEAKS["bf16_flops"])
