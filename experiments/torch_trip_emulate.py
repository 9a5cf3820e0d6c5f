"""The trip kernels' CUDA source run on the CPU: a rehearsal of
``tpupt_torch/accel/csrc/trip_kernels.cu`` where there is no card and no
nvcc.

    python experiments/torch_trip_emulate.py [--size 16] [--scenes lamp,cornell.json,...]

g++ compiles the source against stubs of the CUDA built-ins it uses (the
launch qualifiers, the thread and block indices, the warp vote, the
atomic, ``rsqrtf``): each launch ``k<<<grid, block, 0, stream>>>(args)``
becomes a loop over the blocks and threads, and the warp vote counts one
thread at a time.  The library goes into a temporary directory and is
called through ctypes on CPU tensors by the wrappers of
``tpupt_torch.render.trip_kernel`` (their CPU branch to the twins taken
out).  Both sides then use correctly rounded float32 sqrt, rsqrt (as
1 / sqrt), sin and cos: the stubs' (computed in double) and torch's,
patched to the same, since torch's CPU functions and the libm's differ
from each other and from CUDA's in the last bit.  With that, the trip
route through the emulated kernels equals the body route through the
torch functions bit for bit, which checks the kernels' logic, layout and
order of operations before a chip call; it says nothing about CUDA's own
functions, its compiler or speed.

Renders the named scenes (the emitter scenes of
``tests/test_torch_trip_nee.py`` and the harness's multimesh) chained and
per sample, with roulette and without, by both routes, and prints per
render the segments and whether colour, normal and depth are equal.
Exits non-zero if any differs.
"""

import argparse
import ctypes
import functools
import inspect
import os
import re
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from tpupt_torch.accel import kernels  # noqa: E402
from tpupt_torch.render import integrator, trip_kernel  # noqa: E402
from tpupt_torch.render.intersect import intersect_scene_ids  # noqa: E402

STUBS = r"""
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
using std::isnan;
using std::max;
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
typedef void* cudaStream_t;
typedef int cudaError_t;
const int cudaSuccess = 0;
struct Dim3 { unsigned x, y, z; };
Dim3 blockIdx, threadIdx;
inline unsigned __ballot_sync(unsigned, bool p) { return p ? 1u : 0u; }
inline int atomicAdd(int* a, int v) { int o = *a; *a += v; return o; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
#define cosf(x) ((float)std::cos((double)(x)))
#define sinf(x) ((float)std::sin((double)(x)))
"""


def build(out_dir) -> ctypes.CDLL:
    """The emulation library of trip_kernels.cu, its entries declared as
    ``kernels.bind`` declares them."""
    with open(os.path.join(ROOT, "tpupt_torch", "accel", "csrc", "trip_kernels.cu")) as fh:
        src = fh.read().replace("#include <cuda_runtime.h>", STUBS)

    def loop(m):
        name, grid, block, args = m.groups()
        return (f"for (unsigned b_ = 0; b_ < (unsigned)({grid}); ++b_) "
                f"for (unsigned t_ = 0; t_ < (unsigned)({block}); ++t_) "
                f"{{ blockIdx.x = b_; threadIdx.x = t_; {name}({args}); }}")

    src, n = re.subn(r"(\w+(?:<\w+>)?)<<<(.+?), (\w+), 0, stream>>>\(\s*(.*?)\);", loop, src,
                     flags=re.S)
    assert n >= 4, f"found {n} launches"
    # one thread at a time: every thread adds its own vote
    src = src.replace("(threadIdx.x & 31) == 0 && votes != 0u", "votes != 0u")
    cpp, lib = os.path.join(out_dir, "trip_emu.cpp"), os.path.join(out_dir, "libtrip_emu.so")
    with open(cpp, "w") as fh:
        fh.write(src)
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", cpp,
                    "-o", lib], check=True)
    lib = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tpupt_trip_head.argtypes = [P, P, I, I, P, I, P, P, P, P, P]
    lib.tpupt_trip_nee.argtypes = [P, P, I, I] + [P] * 9 + [I] * 7 + [P] * 5
    lib.tpupt_trip_tail.argtypes = [P, P, I] + [P] * 9 + [I] * 3 + [P] + [I] * 11 + [P] * 6
    return lib


def emulated_wrappers(lib) -> dict:
    """trip_head, trip_nee and trip_tail as the module defines them, with
    the CPU branch to the twins and the device checks taken out and the
    emulation library in place of the kernels'."""
    kernels.stream_of = lambda t: None
    kernels.check = lambda _lib, err, what: None if err == 0 else sys.exit(f"{what}: {err}")
    out = {}
    for name in ("trip_head", "trip_nee", "trip_tail"):
        src = inspect.getsource(getattr(trip_kernel, name))
        src = src.replace('F.device.type == "cpu"', "False")
        scope = dict(vars(trip_kernel), _check=lambda *a: lib)
        exec(src, scope)
        out[name] = scope[name]
    return out


def correctly_rounded_torch():
    """torch.sqrt, rsqrt, sin and cos rounded once from double, as the
    stubs compute them."""
    sqrt, sin, cos = torch.sqrt, torch.sin, torch.cos
    torch.sqrt = lambda x: sqrt(x.double()).float()
    torch.rsqrt = lambda x: torch.reciprocal(torch.sqrt(x))
    torch.sin = lambda x: sin(x.double()).float()
    torch.cos = lambda x: cos(x.double()).float()


def scenes(names, tmp):
    import shutil

    import test_torch_trip_nee as t

    from tpupt_torch.bench import harness
    from tpupt_torch.scene.assets_gen import ensure_models, locate_asset_path

    shutil.copytree(os.path.join(locate_asset_path(), "scenes"), os.path.join(tmp, "scenes"))
    ensure_models(os.path.join(tmp, "models"), names=["quad.obj"])
    for name in names:
        if name == "multimesh":
            yield name, harness.CONFIGS["multimesh"]["scene"](device="cpu")
        else:
            yield name, t._port_scene(name, os.path.join(tmp, "scenes"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=16)
    ap.add_argument("--scenes", default="lamp,many16,quad_mixed,cornell.json,cornell_area.json,"
                                        "multimesh")
    args = ap.parse_args()
    torch.set_num_threads(1)
    body = functools.partial(intersect_scene_ids)
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        emu = emulated_wrappers(build(tmp))
        wrappers = {k: getattr(trip_kernel, k) for k in emu}
        correctly_rounded_torch()
        for name, (scene, cam) in scenes(args.scenes.split(","), tmp):
            for rr in (None, 2):
                for mode, kw in (("chained", {}), ("per sample", dict(chain_samples=False))):
                    kw = dict(kw, spp=2, max_bounces=4, rr_start=rr)
                    vars(trip_kernel).update(emu)
                    got, rays = integrator.render_image(scene, cam, args.size, args.size, **kw)
                    vars(trip_kernel).update(wrappers)
                    want, rays_b = integrator.render_image(scene, cam, args.size, args.size,
                                                           intersect_fn=body, **kw)
                    same = {k: torch.equal(getattr(got, k), getattr(want, k))
                            for k in ("color", "normal", "depth")}
                    ok = all(same.values()) and int(rays) == int(rays_b)
                    bad += not ok
                    print(f"{name:18s} rr {str(rr):4s} {mode:10s} segments {int(rays)} / "
                          f"{int(rays_b)}; equal {same}{'' if ok else '  <-- differs'}")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
