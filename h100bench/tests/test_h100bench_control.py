"""The control (the reference computed at TF32's precision, in the
program's place) comes out not correct in every cell, at a size a test
run holds; the program's own readings pass."""

import pytest

from h100bench import compare, control
from h100bench.tests.helpers import SMALL, cell


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_fails_program_passes(name):
    rows = control.readings(cell(name), [2**31 + 3], 1, device="cpu", traffic=SMALL[name],
                            log=lambda s: None)
    lim = compare.limits(name)
    prog = next(r for r in rows if r["kind"] == "program")["numbers"]
    ctrl = next(r for r in rows if r["kind"] == "control")["numbers"]
    assert compare.judge(prog, lim)[0]
    assert not compare.judge(ctrl, lim)[0]
    assert ctrl["pixels_off"] > 0.5
