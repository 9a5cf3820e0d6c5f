"""Device milliseconds a render of the forward trip's kernels,
``trip_head``, ``trip_nee`` and ``trip_tail``, from the profiler's
trace."""

KERNELS = ("trip_head_kernel", "trip_nee_kernel", "trip_tail_kernel")


def read(ctx):
    s = ctx.trace.seconds(*KERNELS)
    return s * 1e3 / ctx.jobs if s else None
