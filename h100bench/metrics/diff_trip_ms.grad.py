"""Device milliseconds a gradient step of the differentiable trip's
kernels, ``trip_head``, ``diff_trip_fwd`` and ``diff_trip_bwd``."""

KERNELS = ("trip_head_kernel", "diff_trip_fwd_kernel", "diff_trip_bwd_kernel")


def read(ctx):
    s = ctx.trace.seconds(*KERNELS)
    return s * 1e3 / ctx.jobs if s else None
