"""Stage stopwatch (counterpart of ``tpupt/utils/timer.py``): named stages
with per-stage seconds and a total."""

from __future__ import annotations

import time


class Stopwatch:
    def __init__(self):
        self._stages: list[tuple[str, float]] = []
        self._current: str | None = None
        self._start = 0.0

    def stage(self, name: str) -> None:
        self.end_stage()
        self._current = name
        self._start = time.perf_counter()

    def end_stage(self) -> None:
        if self._current is not None:
            self._stages.append((self._current, time.perf_counter() - self._start))
            self._current = None

    @property
    def stages(self) -> list[tuple[str, float]]:
        return list(self._stages)

    def total(self) -> float:
        return sum(s for _, s in self._stages)

    def report(self) -> str:
        self.end_stage()
        lines = [f"{name} time: {secs:.6f}s" for name, secs in self._stages]
        lines.append(f"Total time: {self.total():.6f}s")
        return "\n".join(lines)
