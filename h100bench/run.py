"""Run one cell of the benchmark once and print its result line.

    python3 -m h100bench.run --workload three_balls.render --seed 12345 --seconds 50 --trace 0

From the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``configs/<name>.json``: a scene
and the OBJ models it names, data files in ``models/``) and a traffic
mix (``traffic/<name>.json``: the job, its sizes, and how the seed picks
the first sample index).  The job (``jobs/<job>.py``) runs on the
program, ``tpupt_torch``: set-up builds the scene through the program's
own path and runs two jobs at the cell's shapes; the window then runs
jobs back to back, each ending in a synchronize, until ``--seconds``
have passed, and the end-to-end metrics are taken over all its jobs and
all its time.  ``--trace 1`` runs the window under ``torch.profiler``
(at most the traffic's ``trace_jobs`` jobs), one job with the kernels'
work counted after it, and the per-layer metrics (``metrics/<name>.py``)
read from those.  Either way one job of the window, drawn from the seed,
is held to the plain reference (``reference/<name>.py``) once the window
has closed and the program's scene is freed (``compare.py``, limits in ``limits/<cell>.json``).

The last line of standard output is the result as one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error.  The run fails, printing no result, without a card, and if a
module of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "tpupt")


def forbidden_modules() -> list:
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load_file(path: str):
    """A module from its file (per-layer metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "h100bench_metric_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write(path: str, data: bytes) -> None:
    if not os.path.exists(path) or open(path, "rb").read() != data:
        with open(path, "wb") as fh:
            fh.write(data)


def prepare(root: str, config: dict) -> str:
    """The configuration's scene file, and the models it names (copied
    from ``models/``), under the checkout's build directory; returns the
    scene file's path.  Both the program and the reference read these."""
    base = os.path.join(root, "build", "h100bench", config["name"])
    for sub in ("scenes", "models"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    for name in config["models"]:
        with open(os.path.join(HERE, "models", name), "rb") as fh:
            _write(os.path.join(base, "models", name), fh.read())
    path = os.path.join(base, "scenes", config["scene_file"])
    _write(path, json.dumps(config["scene"], indent=1).encode())
    return path


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def card_power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() \
        else "not read"


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, device="cuda",
             root: str = ROOT, traffic: dict | None = None, t_start: float = T_START) -> dict:
    """One run of ``cell``; returns the result object (``checks`` last).
    ``traffic`` replaces the cell's mix (the tests run small ones)."""
    import torch

    from h100bench import compare, trace as tr
    from h100bench.window import Reservoir

    config = load_json(HERE, "configs", cell["config"] + ".json")
    traffic = traffic or load_json(HERE, "traffic", cell["traffic"] + ".json")
    jobs = importlib.import_module(f"h100bench.jobs.{traffic['job']}")
    scene_path = prepare(root, config)
    on_card = torch.device(device).type == "cuda"

    # set-up: the scene through the program's path, then two jobs at these
    # shapes, the first one's output held as the window holds one
    job = jobs.Job(scene_path, config, traffic, seed % traffic["first_sample_modulus"], device)
    held = job.run(0)
    job.run(0)
    del held
    setup_s = time.perf_counter() - t_start

    keep = Reservoir(seed)
    ends, work, k = [], 0, 1
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    t0 = time.perf_counter()
    while True:
        w, out = job.run(k)
        te = time.perf_counter()
        ends.append(te - t0)
        work += w
        keep.offer(out)
        del out
        k += 1
        if te - t0 >= seconds or (trace and k > traffic["trace_jobs"]):
            break
    window_s = te - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if forbidden_modules():
        raise RuntimeError(f"loaded: {forbidden_modules()}")

    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    result = {"correct": False, "attempted": len(ends), "failed": 0, "metrics": {},
              "device": {"platform": "gpu" if on_card else "cpu", "kind": kind,
                         "count": cell["chips"], "memory_peak_bytes": int(peak)}}
    if trace:
        device_iv, host_iv = tr.from_profiler(prof)
        reduced = tr.reduce(device_iv, host_iv)
        del prof, device_iv, host_iv
        counts = job.count(k)
        ctx = SimpleNamespace(trace=reduced, jobs=len(ends), window_s=window_s, counts=counts)
        for m in bench["per_layer"]:
            if not applies(m, cell["name"]):
                continue
            value = load_file(os.path.join(HERE, "metrics", m["name"] + ".py")).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"].update(busy_s=reduced.busy_s, window_s=window_s)
        result["breakdown"] = {"device_ops": reduced.top_ops, "idle_gaps": reduced.idle_gaps}
        print(f"peaks: {counting_peaks()}; this card: {card_power_limit() if on_card else 'cpu'}",
              file=sys.stderr)
    else:
        values = dict(jobs.end_to_end(dict(work=work, seconds=window_s, ends=ends)),
                      setup_s=setup_s, peak_mem_gib=peak / 2**30)
        for m in bench["end_to_end"]:
            if applies(m, cell["name"]):
                result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    # the check: the kept job against the reference, the program's scene freed
    got = keep.kept
    job.release()
    del job
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = importlib.import_module(f"h100bench.reference.{config['reference']}")
    t_ref = time.perf_counter()
    want = jobs.reference(ref, scene_path, traffic, got["start"], device)
    print(f"the reference took {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    print("details " + json.dumps(compare.details(got, want)), file=sys.stderr)
    ok, checks = compare.judge(jobs.numbers(got, want), compare.limits(cell["name"]))
    result["correct"] = ok
    result["checks"] = checks
    return result


def counting_peaks() -> str:
    from h100bench.counting import PEAKS

    return (f"NVIDIA H100 SXM published {PEAKS['flops'] / 1e12:.0f} TFLOP/s FP32, "
            f"{PEAKS['bytes'] / 1e12:.2f} TB/s, at {PEAKS['power_w']:.0f} W")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "h100bench",
                                                               "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "h100bench", "triton"))
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cells[0]["chips"]:
        print(f"{args.workload} needs {cells[0]['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = run_cell(bench, cells[0], args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
