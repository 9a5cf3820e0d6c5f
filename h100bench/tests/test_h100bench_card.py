"""On the card: one short run of each cell at a small traffic mix, held
to the reference, its metrics present."""

import time

import pytest

from h100bench import run
from h100bench.tests.helpers import SMALL, bench, cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_small_run_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for trace in (False, True):
        r = run.run_cell(bench(), cell(name), 2**31 + 901, 0.5, trace, device="cuda",
                         traffic=SMALL[name], t_start=time.perf_counter())
        assert r["correct"], r["checks"]
        assert r["device"]["platform"] == "gpu" and r["metrics"]
