"""Forward trips a render: ``trip_tail`` launches in the traced window
(one a trip) over the renders in it, from the profiler's trace."""


def read(ctx):
    n = ctx.trace.count("trip_tail_kernel")
    return n / ctx.jobs if n else None
