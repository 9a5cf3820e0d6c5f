"""Device kernels a gradient step: every kernel launch in the traced
window (copies and fills left out) over the steps in it."""


def read(ctx):
    return ctx.trace.kernels / ctx.jobs if ctx.trace.kernels else None
