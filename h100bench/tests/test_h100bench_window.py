"""The window's arithmetic: the rate is all the work over all the time,
the tail is over every step, the checked job is drawn from the seed."""

from collections import Counter

import pytest

from h100bench.window import Reservoir, percentile, rate, walls


def test_rate_is_all_work_over_all_time():
    works = [3_000_000, 5_000_000, 7_000_000]
    assert rate(sum(works), 2.0) == 7_500_000.0
    with pytest.raises(ValueError):
        rate(1, 0.0)


@pytest.mark.parametrize("n", [20, 100, 237])
def test_p95_is_over_every_step(n):
    walls = [0.2] * n
    assert percentile(walls, 95) == 0.2
    slow = max(1, n - int(0.95 * n) + 1)  # more than 5% of the steps slow
    walls[:slow] = [1.0] * slow
    assert percentile(walls, 95) == 1.0
    assert percentile(list(range(1, 101)), 95) == 95


def test_reservoir_same_seed_same_choice_and_uniform():
    def kept(seed, n=10):
        r = Reservoir(seed)
        for i in range(n):
            r.offer(i)
        return r.kept

    assert kept(2**31 + 5) == kept(2**31 + 5)
    freq = Counter(kept(s) for s in range(4000))
    assert set(freq) == set(range(10))
    assert max(freq.values()) < 2 * min(freq.values())


def test_walls_are_every_step_whole():
    ends = [0.3, 0.6, 1.5, 1.8]  # a stall in step 3
    assert walls(ends) == [pytest.approx(w) for w in (0.3, 0.3, 0.9, 0.3)]
    assert percentile(walls(ends), 95) == pytest.approx(0.9)
    assert walls([0.25]) == [0.25]
