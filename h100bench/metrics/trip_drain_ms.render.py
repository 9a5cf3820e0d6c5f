"""Host milliseconds a render spends in its tail handover: the program's
``tpupt.trip.drain`` spans (the lanes' compaction, the drain's launch and
the read of the lanes it left, which waits for the drain) in the traced
window (``tpupt_torch.utils.trace``) over the renders in it.  None from a
program without the span."""


def read(ctx):
    try:
        from tpupt_torch.utils import trace
    except ImportError:
        return None
    s = trace.snapshot()["spans"].get("tpupt.trip.drain")
    return s["host_s"] * 1e3 / ctx.jobs if s else None
