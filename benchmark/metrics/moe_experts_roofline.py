"""moe_experts_roofline: the least time of the traced window's one-token
routed-expert launches (``moe_up_kernel<true>``, ``moe_down_kernel<true>``:
a B = 1 frame's MoE layers; each moves the bytes of
``costs_lfm2.moe_one_token_bytes`` at the HBM rate, the bound, since 2 FLOP
a weight is far below the bf16 ridge) over their summed device time.  The
grouped launches of a prefill (``<false>``) are left out of both."""

from harness import costs_lfm2


def read(ctx):
    kernels = (ctx.trace or {}).get("kernels", {})
    hits = [(name, v) for name, v in kernels.items()
            if name.startswith(("moe_up_kernel<true>", "moe_down_kernel<true>"))]
    if not hits or not hasattr(ctx.sizes, "expert_ff"):
        return None
    up_b, down_b = costs_lfm2.moe_one_token_bytes(ctx.sizes)
    seconds, nbytes = 0.0, 0
    for name, (sec, launches) in hits:
        seconds += sec
        nbytes += launches * (up_b if name.startswith("moe_up") else down_b)
    if not nbytes or seconds <= 0:
        return None
    return 100.0 * nbytes / costs_lfm2.PEAKS["hbm_bytes_per_s"] / seconds
