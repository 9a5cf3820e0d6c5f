"""Host milliseconds a render waits on the 4-byte read of the lanes left
after each trip: the program's ``tpupt.trip.wait`` spans in the traced
window (``tpupt_torch.utils.trace``, which records while the profiler
runs) over the renders in it.  None from a program without the span."""


def read(ctx):
    try:
        from tpupt_torch.utils import trace
    except ImportError:
        return None
    s = trace.snapshot()["spans"].get("tpupt.trip.wait")
    return s["host_s"] * 1e3 / ctx.jobs if s else None
