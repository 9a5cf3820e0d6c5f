"""No module that a run loads has the top-level name jax, jaxlib, flax or
tpupt (compared whole: the program is tpupt_torch), and the reference
loads nothing of the program."""

import json
import subprocess
import sys

from h100bench import run

_RUN = """
import json, sys, time
from h100bench import run
from h100bench.tests.helpers import run_small
r = run_small("three_balls.grad", trace=True)
r2 = run_small("three_balls.render")
print(json.dumps(dict(correct=r["correct"] and r2["correct"], forbidden=run.forbidden_modules(),
                      tops=sorted({m.split(".")[0] for m in sys.modules}))))
"""

_REF = """
import json, sys
import h100bench.reference.pathtrace
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _py(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    got = _py(_RUN)
    assert got["correct"]
    assert got["forbidden"] == []
    assert "tpupt_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "tpupt"} & set(got["tops"])


def test_the_reference_loads_nothing_of_the_program():
    tops = set(_py(_REF))
    assert not {"tpupt_torch", "tpupt", "jax", "jaxlib", "flax"} & tops


def test_forbidden_names_compare_whole():
    sys.modules["tpupt_torch_lookalike"] = sys.modules["tpupt.fake"] = sys
    try:
        assert run.forbidden_modules() == ["tpupt.fake"]
    finally:
        del sys.modules["tpupt_torch_lookalike"], sys.modules["tpupt.fake"]
