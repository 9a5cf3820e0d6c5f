"""Device milliseconds a render of the tail handover's kernels,
``trip_drain_compact_kernel`` and ``trip_drain_kernel``, from the
profiler's trace: the late lanes' trips, which ``trip_kernels_ms.render``
and ``trip_kernels_roofline`` leave out.  None from a program without
them."""

KERNELS = ("trip_drain_kernel", "trip_drain_compact_kernel")


def read(ctx):
    s = ctx.trace.seconds(*KERNELS)
    return s * 1e3 / ctx.jobs if s else None
