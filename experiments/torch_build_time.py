"""The kernel library's build time on one machine with nvcc: one nvcc call
over every source in ``tpupt_torch/accel/csrc`` against
``kernels.build`` (one nvcc per source, all started together, then one
link), each into a fresh directory under ``build/``, in turns (one call,
``kernels.build``, ``kernels.build``, one call).

    python experiments/torch_build_time.py

Both use the library's flags (``kernels.NVCC_FLAGS``).  Prints the
seconds of each build and the machine's CPU count; the last line of
standard output is one JSON object.
"""

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpupt_torch.accel import kernels  # noqa: E402


def one_call(out_dir):
    srcs = sorted(os.path.join(kernels._CSRC, n) for n in os.listdir(kernels._CSRC)
                  if n.endswith(".cu"))
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, *srcs, "-o",
                    os.path.join(out_dir, "lib.so")], check=True, capture_output=True, timeout=900)


def per_source(out_dir):
    build_dir = kernels.BUILD_DIR
    kernels.BUILD_DIR = out_dir
    try:
        kernels.build()
    finally:
        kernels.BUILD_DIR = build_dir


def main():
    base = os.path.join(kernels.BUILD_DIR, "build_time")
    times = {"one_call": [], "per_source": []}
    for i, (name, fn) in enumerate((("one_call", one_call), ("per_source", per_source),
                                    ("per_source", per_source), ("one_call", one_call))):
        out_dir = os.path.join(base, f"{i}_{name}")
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        t0 = time.perf_counter()
        fn(out_dir)
        times[name].append(time.perf_counter() - t0)
        print(f"{name}: {times[name][-1]:.2f} s", flush=True)
    shutil.rmtree(base, ignore_errors=True)
    print(json.dumps(dict(cpus=os.cpu_count(), sources=len([n for n in os.listdir(kernels._CSRC)
                                                            if n.endswith(".cu")]),
                          seconds=times)))


if __name__ == "__main__":
    main()
