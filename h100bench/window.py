"""The measured window's arithmetic: rates over all the work and all the
time, a tail over every job, and the uniform choice, drawn from the seed,
of the one job whose output the reference checks."""

from __future__ import annotations

import math
import random


def rate(work: float, seconds: float) -> float:
    """All the work of the window over all of its time."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return work / seconds


def percentile(values, q: float) -> float:
    """The nearest-rank ``q`` percentile of every value: the smallest value
    at or below which ``q`` percent of them lie."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def walls(ends) -> list:
    """Each job's wall, from the window's start or the job before's end
    to its own.  ``ends``: each job's end, in seconds from the window's
    start (every job ends in a synchronize)."""
    return [e - s for s, e in zip([0.0] + list(ends[:-1]), ends)]


class Reservoir:
    """Keeps one of the items offered, each with the same chance, the
    choices drawn from ``seed`` (reservoir sampling of size one)."""

    def __init__(self, seed: int):
        self._rng = random.Random(seed)
        self.seen = 0
        self.kept = None

    def offer(self, item) -> None:
        self.seen += 1
        if self._rng.randrange(self.seen) == 0:
            self.kept = item
