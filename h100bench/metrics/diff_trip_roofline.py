"""The differentiable trip's kernels' share of their bound: the bound
summed over every launch of one counting step (``counting.count_diff``),
over their device milliseconds a step in the traced window."""

KERNELS = ("trip_head_kernel", "diff_trip_fwd_kernel", "diff_trip_bwd_kernel")


def read(ctx):
    dev_ms = ctx.trace.seconds(*KERNELS) * 1e3 / ctx.jobs
    bound = sum(ctx.counts[k]["bound_ms"] for k in ("trip_head", "diff_trip_fwd", "diff_trip_bwd")
                if k in (ctx.counts or {}))
    return 100.0 * bound / dev_ms if dev_ms > 0 and bound > 0 else None
