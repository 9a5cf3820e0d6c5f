"""Readings for the limits of ``correct``, and the control that has to
fail them.

    python3 -m h100bench.control --workload three_balls.render --seeds 11,12,13 --controls 3

In one process: the program's job for each seed, at the cell's own size,
the start of job 1 of that seed's window, compared with the plain
reference (the sound readings); then for the first ``--controls`` seeds
the control in the program's place: the reference computed with every
float32 result rounded to TF32's 10-bit mantissa (``TF32``), the nearest
precision below the float32-with-TF32-off that the configurations state.
Prints one JSON line a reading and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time

import torch
from torch.overrides import TorchFunctionMode

from h100bench import compare
from h100bench.run import HERE, ROOT, load_json, prepare


def _tf32(t):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
        return t
    with torch.no_grad():
        v = t.detach()
        bits = (v.view(torch.int32) + 0x1000) & -0x2000
        r = torch.where(torch.isfinite(v), bits.view(torch.float32), v)
    return t + (r - t).detach() if t.requires_grad else r


class TF32(TorchFunctionMode):
    """Every float32 tensor an operation returns, rounded to nearest at
    TF32's precision (gradients pass straight through the rounding)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, tuple):
            return type(out)(_tf32(o) for o in out) if not hasattr(out, "_fields") \
                else type(out)(*(_tf32(o) for o in out))
        return _tf32(out)


def readings(cell: dict, seeds, controls: int, device="cuda", traffic=None, log=print):
    """[{seed, kind: "program" | "control", numbers, seconds}]."""
    config = load_json(HERE, "configs", cell["config"] + ".json")
    traffic = traffic or load_json(HERE, "traffic", cell["traffic"] + ".json")
    jobs = importlib.import_module(f"h100bench.jobs.{traffic['job']}")
    ref = importlib.import_module(f"h100bench.reference.{config['reference']}")
    scene_path = prepare(ROOT, config)
    out = []
    got = {}
    job = jobs.Job(scene_path, config, traffic, 0, device)
    for seed in seeds:
        job.first = seed % traffic["first_sample_modulus"]
        _, got[seed] = job.run(1)
    job.release()
    del job
    gc.collect()
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        want = jobs.reference(ref, scene_path, traffic, got[seed]["start"], device)
        row = dict(seed=seed, kind="program", numbers=jobs.numbers(got.pop(seed), want),
                   seconds=time.perf_counter() - t0)
        out.append(row)
        log(json.dumps(row))
        if i < controls:
            t0 = time.perf_counter()
            with TF32():
                ctrl = jobs.reference(ref, scene_path, traffic, want["start"], device)
            row = dict(seed=seed, kind="control", numbers=jobs.numbers(ctrl, want),
                       seconds=time.perf_counter() - t0)
            out.append(row)
            log(json.dumps(row))
            del ctrl
        del want
        gc.collect()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = [w for w in bench["workloads"] if w["name"] == args.workload][0]
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = readings(cell, seeds, args.controls, log=lambda s: print(s, flush=True))
    lim = compare.limits(cell["name"])
    for kind in ("program", "control"):
        vals = [r["numbers"] for r in rows if r["kind"] == kind]
        if vals:
            print(kind, {k: (min(v[k] for v in vals), max(v[k] for v in vals)) for k in vals[0]},
                  "limits", lim, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(rows, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
