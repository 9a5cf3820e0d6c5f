"""The closest-hit sweep's share of its bound: the bound summed over every
launch of one counting render (``counting_sweep.count_sweeps``: the
twin's slab tests and Möller–Trumbore pairs, each lane's and treelet's
bytes, at the H100 SXM's published peaks), over the kernel's device
milliseconds a render in the traced window."""

KERNELS = ("treelet_closest_hit_kernel",)


def read(ctx):
    dev_ms = ctx.trace.seconds(*KERNELS) * 1e3 / ctx.jobs
    count = (ctx.counts or {}).get("treelet_closest_hit")
    bound = count["bound_ms"] if count else 0.0
    return 100.0 * bound / dev_ms if dev_ms > 0 and bound > 0 else None
