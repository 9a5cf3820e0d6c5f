"""Lanes a render hands to its tail handover: the program's counter
``trip.drain_lanes`` (the lanes still to trace when the issued trips
stop) in the traced window (``tpupt_torch.utils.trace``) over the renders
in it.  None from a program without the counter."""


def read(ctx):
    try:
        from tpupt_torch.utils import trace
    except ImportError:
        return None
    n = trace.snapshot()["counters"].get("trip.drain_lanes")
    return n / ctx.jobs if n else None
