"""Device milliseconds a render of next-event estimation's kernels:
``trip_nee_kernel`` and the any-hit sweep of the shadow rays
(``treelet_any_hit_walk_kernel``, ``treelet_any_hit_kernel``,
``treelet_any_hit_warp_kernel``), from the profiler's trace."""

KERNELS = ("trip_nee_kernel", "treelet_any_hit")


def read(ctx):
    s = ctx.trace.seconds(*KERNELS)
    return s * 1e3 / ctx.jobs if s else None
