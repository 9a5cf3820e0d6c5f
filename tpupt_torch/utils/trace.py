"""Spans and counters of the render loops, and the hand-written kernels'
launch counts.

A span (``span(name)``) marks a stage of the program: a render
(``tpupt.render``), a trip's issue and its read of the lanes left
(``tpupt.trip.issue``, ``tpupt.trip.wait``), inside the issue the
closest-hit sweep and next-event estimation's kernels
(``tpupt.trip.sweep``, ``tpupt.trip.nee``), the tail handover
(``tpupt.trip.drain``), a sample's set-up, a bounce, a backward pass.
It records only while a ``torch.profiler`` session is active
(``enabled()``: the benchmark's traced window, the CLI's ``--profile``);
otherwise entering it costs one call of that flag and nothing else, no
profiler range, no clock read, no CUDA event.
While it records, it opens a profiler range of that name, so the span
lands in the profiler's trace on the device operations' clock, and adds
its host seconds (the range's own cost included) to an in-memory
aggregate of that name; a span given a CUDA ``device`` also records a
CUDA event pair on that device's current stream, resolved (one
synchronize) when the aggregates are read.  The range is torch's fast
form (``torch._C._profiler._RecordFunctionFast``, the one torch's
compiled code opens: one profiler event and about a microsecond, against
``torch.profiler.record_function``'s dispatcher calls, three events and
about ten).

Each aggregate holds a count, host seconds and, where timed, the stream
seconds from the span's start event to its end event (device idle while
the host still issues inside the span included).  Counters (``count``)
record on the same terms.  ``snapshot()`` reads the totals, ``reset()``
clears them.

The launch counts are the exception: ``launched(kernel)`` counts every
launch of a hand-written kernel, profiler or not, and ``launch_counts()``
reads them for the whole process.
"""

from __future__ import annotations

import threading
import time

import torch

# whether a torch.profiler session is active: the one switch of spans and
# counters (a C call of about 0.1 us)
enabled = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast

# the hand-written kernels whose launches are counted, by the name their
# wrapper counts them under
KERNELS = ("treelet_closest_hit", "treelet_closest_hit(payload=True)", "treelet_any_hit",
           "winner_step", "trip_head", "trip_nee", "trip_tail", "trip_drain", "diff_trip_fwd",
           "diff_trip_bwd", "slot_scatter")
_launches = dict.fromkeys(KERNELS, 0)

_spans: dict = {}  # name -> _Agg
_counters: dict = {}  # name -> int
# the aggregates and counts are updated from the calling thread and from
# autograd's device threads (a backward pass)
_lock = threading.Lock()


class _Agg:
    __slots__ = ("count", "host_ns", "device_s", "pending")

    def __init__(self):
        self.count, self.host_ns, self.device_s = 0, 0, None
        self.pending = []  # CUDA event pairs not yet resolved


class _Off:
    """What ``span`` returns while no profiler is active."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "device", "rf", "t0", "ev")

    def __init__(self, name, device):
        self.name = name
        self.device = device if device is not None and torch.device(device).type == "cuda" \
            else None

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        self.rf = _range(self.name)
        self.rf.__enter__()
        self.ev = None
        if self.device is not None:
            self.ev = torch.cuda.Event(enable_timing=True)
            self.ev.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        end = None
        if self.ev is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
        self.rf.__exit__(*exc)
        host_ns = time.perf_counter_ns() - self.t0
        with _lock:
            agg = _spans.get(self.name)
            if agg is None:
                agg = _spans[self.name] = _Agg()
            agg.count += 1
            agg.host_ns += host_ns
            if end is not None:
                agg.pending.append((self.ev, end))
        return False


def span(name: str, device=None):
    """A context manager that marks a stage ``name`` while a profiler is
    active, and does nothing else otherwise.  ``device``: also time the
    span on this CUDA device's current stream (ignored for other
    devices)."""
    if not enabled():
        return _OFF
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler is active."""
    if enabled():
        with _lock:
            _counters[name] = _counters.get(name, 0) + int(n)


def launched(kernel: str) -> None:
    """Count one launch of ``kernel`` (a name in ``KERNELS``), always."""
    with _lock:
        _launches[kernel] += 1


def launch_counts() -> dict[str, int]:
    """Every hand-written kernel's launches so far in this process."""
    return dict(_launches)


def snapshot() -> dict:
    """What the spans and counters recorded since the last ``reset()``:
    ``spans`` {name: {count, host_s, device_s (None: not timed)}} and
    ``counters`` {name: total}.  Device events are resolved here."""
    out = {}
    with _lock:
        for name, agg in _spans.items():
            for start, end in agg.pending:
                end.synchronize()
                agg.device_s = (agg.device_s or 0.0) + start.elapsed_time(end) * 1e-3
            agg.pending.clear()
            out[name] = dict(count=agg.count, host_s=agg.host_ns * 1e-9, device_s=agg.device_s)
        return dict(spans=out, counters=dict(_counters))


def reset() -> None:
    """Clear the spans' and counters' aggregates (not the launch counts)."""
    with _lock:
        _spans.clear()
        _counters.clear()
