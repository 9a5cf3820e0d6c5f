"""Host milliseconds a render spends issuing its trips, from
``trip_head``'s call to ``trip_tail``'s return: the program's
``tpupt.trip.issue`` spans in the traced window
(``tpupt_torch.utils.trace``) over the renders in it.  None from a
program without the span."""


def read(ctx):
    try:
        from tpupt_torch.utils import trace
    except ImportError:
        return None
    s = trace.snapshot()["spans"].get("tpupt.trip.issue")
    return s["host_s"] * 1e3 / ctx.jobs if s else None
