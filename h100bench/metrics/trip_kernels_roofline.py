"""The forward trip's kernels' share of their bound: the bound summed
over every launch of one counting render (``counting.count_trips``: each
lane's bytes and operations by its case, at the H100 SXM's published
peaks), over their device milliseconds a render in the traced window."""

KERNELS = ("trip_head_kernel", "trip_nee_kernel", "trip_tail_kernel")


def read(ctx):
    dev_ms = ctx.trace.seconds(*KERNELS) * 1e3 / ctx.jobs
    bound = sum(ctx.counts[k]["bound_ms"] for k in ("trip_head", "trip_nee", "trip_tail")
                if k in (ctx.counts or {}))
    return 100.0 * bound / dev_ms if dev_ms > 0 and bound > 0 else None
