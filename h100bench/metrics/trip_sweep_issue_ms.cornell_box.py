"""Host milliseconds a render spends issuing the closest-hit sweep of its
trips: the program's ``tpupt.trip.sweep`` spans in the traced window
(``tpupt_torch.utils.trace``) over the renders in it.  None from a
program without the span."""


def read(ctx):
    try:
        from tpupt_torch.utils import trace
    except ImportError:
        return None
    s = trace.snapshot()["spans"].get("tpupt.trip.sweep")
    return s["host_s"] * 1e3 / ctx.jobs if s else None
