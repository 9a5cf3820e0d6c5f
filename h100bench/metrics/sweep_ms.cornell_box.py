"""Device milliseconds a render of the closest-hit sweep,
``treelet_closest_hit_kernel`` (one launch a trip of a scene with
meshes), from the profiler's trace."""

KERNELS = ("treelet_closest_hit_kernel",)


def read(ctx):
    s = ctx.trace.seconds(*KERNELS)
    return s * 1e3 / ctx.jobs if s else None
