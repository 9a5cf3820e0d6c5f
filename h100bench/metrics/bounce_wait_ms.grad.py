"""Host milliseconds a gradient step waits on the 4-byte read of the
lanes left after each bounce of the differentiable trip: the program's
``tpupt.diff.wait`` spans in the traced window
(``tpupt_torch.utils.trace``) over the steps in it.  None from a
program without the span."""


def read(ctx):
    try:
        from tpupt_torch.utils import trace
    except ImportError:
        return None
    s = trace.snapshot()["spans"].get("tpupt.diff.wait")
    return s["host_s"] * 1e3 / ctx.jobs if s else None
