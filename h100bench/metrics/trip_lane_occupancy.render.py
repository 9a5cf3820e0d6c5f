"""The share of the lane slots the forward trip kernels launch over that
hold a live lane: the program's counters ``trip.live_lanes`` (the lanes
live at each trip's start) over ``trip.lanes_launched`` (every lane of
each trip) in the traced window (``tpupt_torch.utils.trace``).  None
from a program without the counters."""


def read(ctx):
    try:
        from tpupt_torch.utils import trace
    except ImportError:
        return None
    c = trace.snapshot()["counters"]
    launched = c.get("trip.lanes_launched", 0)
    return 100.0 * c.get("trip.live_lanes", 0) / launched if launched else None
