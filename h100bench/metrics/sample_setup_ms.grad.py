"""Milliseconds a gradient step spends in the per-sample set-up, on the
stream: the program's ``tpupt.sample.plan`` (the rebake, the slot table,
the trip plan) and ``tpupt.diff.start`` (the lane state on the primary
rays and the trip buffers) spans, each from a CUDA event recorded at its
start to one recorded at its end on the current stream, summed over the
samples of the steps in the traced window (``tpupt_torch.utils.trace``)
over those steps.  The device's idle time while the host still issues
inside a span counts too: this is the set-up's length on the stream, not
its kernels' busy time.  None from a program without the spans, or off
the card."""

SPANS = ("tpupt.sample.plan", "tpupt.diff.start")


def read(ctx):
    try:
        from tpupt_torch.utils import trace
    except ImportError:
        return None
    spans = trace.snapshot()["spans"]
    timed = [spans[k]["device_s"] for k in SPANS if k in spans and spans[k]["device_s"] is not None]
    return sum(timed) * 1e3 / ctx.jobs if timed else None
