"""The reduction of a ``torch.profiler`` trace to what the per-layer
metrics and the result's ``breakdown`` read: each device operation's
count and time by name, the time in which some operation ran on the
device, the top device operations and the longest idle gaps, each named
by what the host was doing then."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Interval:
    name: str
    start_us: float
    end_us: float


@dataclass
class Reduced:
    """``ops``: {device operation name: [count, seconds]}; ``busy_s``: the
    union of the device operations' intervals; ``top_ops`` and
    ``idle_gaps``: [name, seconds] lists, longest first."""

    ops: dict = field(default_factory=dict)
    busy_s: float = 0.0
    top_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    kernels: int = 0

    def seconds(self, *patterns) -> float:
        """Device seconds of the operations whose name holds a pattern."""
        return sum(s for name, (_, s) in self.ops.items() if any(p in name for p in patterns))

    def count(self, *patterns) -> int:
        return sum(c for name, (c, _) in self.ops.items() if any(p in name for p in patterns))


def _short(name: str, limit: int = 96) -> str:
    name = " ".join(name.split())
    return name if len(name) <= limit else name[:limit - 3] + "..."


def is_kernel(name: str) -> bool:
    """A device operation that is a kernel, not a copy or a fill."""
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def reduce(device: list, host: list, top: int = 10) -> Reduced:
    """``device`` and ``host``: Intervals on one clock (microseconds)."""
    out = Reduced()
    for iv in device:
        c = out.ops.setdefault(iv.name, [0, 0.0])
        c[0] += 1
        c[1] += (iv.end_us - iv.start_us) * 1e-6
    out.kernels = sum(c for name, (c, _) in out.ops.items() if is_kernel(name))
    out.top_ops = [[_short(n), s] for n, (_, s) in
                   sorted(out.ops.items(), key=lambda kv: -kv[1][1])[:top]]
    spans = sorted((iv.start_us, iv.end_us) for iv in device)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    out.busy_s = sum(e - s for s, e in merged) * 1e-6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:top]
    out.idle_gaps = [[host_at(host, (a + b) / 2), g * 1e-6] for g, a, b in gaps]
    return out


def host_at(host: list, t_us: float) -> str:
    """What the host ran at ``t_us``: the innermost interval holding it,
    after the outermost span of the benchmark's own that holds it."""
    holding = [iv for iv in host if iv.start_us <= t_us < iv.end_us]
    if not holding:
        return "host outside any recorded op"
    inner = max(holding, key=lambda iv: iv.start_us)
    spans = [iv for iv in holding if iv.name.startswith("h100bench.")]
    outer = min(spans, key=lambda iv: iv.start_us).name + " > " if spans else ""
    return _short(outer + inner.name)


def from_profiler(prof) -> tuple[list, list]:
    """(device intervals, host intervals) of a finished profiler."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        tr = e.time_range
        if tr.end <= tr.start:
            continue
        iv = Interval(e.name, float(tr.start), float(tr.end))
        if e.device_type != DeviceType.CUDA:
            host.append(iv)
        elif not (getattr(e, "is_user_annotation", False) or e.name.startswith("h100bench.")):
            device.append(iv)  # a span's device-side copy is no operation
    return device, host
