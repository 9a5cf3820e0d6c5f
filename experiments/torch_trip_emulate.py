"""The trip kernels' CUDA source run on the CPU: a rehearsal of
``tpupt_torch/accel/csrc/trip_kernels.cu`` where there is no card and no
nvcc.

    python experiments/torch_trip_emulate.py [--size 16] [--scenes lamp,cornell.json,...]

g++ compiles the source against stubs of the CUDA built-ins it uses (the
launch qualifiers, the thread and block indices, the warp vote, the
atomic, ``rsqrtf``): each launch ``k<<<grid, block, 0, stream>>>(args)``
becomes a loop over the blocks and threads, and the warp vote counts one
thread at a time.  What a CTA of ``trip_nee``, ``trip_head`` or
``trip_drain`` does together cannot run one thread at a time, so their CTA
loops (``nee_cta``, ``head_cta``, ``drain_cta``) are replaced by plain ones
(``NEE_CTA``, ``HEAD_CTA``, ``DRAIN_CTA``): each block's thread 0 runs the
kernel's own staging, then its warps' chunks in turn, each thread's flags
and closing stores and each live lane (its hit, shading and NEE terms; its
sphere pass and rows; its drained trips) in order; ``trip_drain``'s list
takes one lane at a time (``DRAIN_LIST``).  The warp's queue of live lanes
and the list's ranks behind one atomic a warp run only on the card.  The
library goes into a temporary directory and is called through ctypes on
CPU tensors by the wrappers of
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
Exits non-zero if any differs.  ``tests/test_torch_trip_emulated.py`` runs
the emitter scenes at 8^2 and the CDF search alone in the suite.
"""

import argparse
import contextlib
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
#include <cstdlib>
#include <cstring>
using std::isnan;
using std::max;
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
typedef void* cudaStream_t;
typedef int cudaError_t;
const int cudaSuccess = 0;
struct Dim3 { unsigned x, y, z; };
Dim3 blockIdx, threadIdx, gridDim;
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
#define __host__
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline void __syncthreads() {}
inline void __syncwarp() {}
inline int __shfl_sync(unsigned, int v, int) { return v; }
inline float __shfl_sync(unsigned, float v, int) { return v; }
inline int __shfl_up_sync(unsigned, int v, int) { return v; }
inline float __int_as_float(int v) { float f; std::memcpy(&f, &v, 4); return f; }
inline int __float_as_int(float v) { int i; std::memcpy(&i, &v, 4); return i; }
template <class T> inline cudaError_t cudaMalloc(T** p, size_t n) {
  *p = static_cast<T*>(std::calloc(1, n));
  return 0;
}
inline cudaError_t cudaFree(void* p) { std::free(p); return 0; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K> inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 132; return 0; }
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, K, int, size_t) {
  *v = 2;
  return 0;
}
"""


def source(name) -> str:
    """A CUDA source of ``tpupt_torch/accel/csrc`` with the header it
    includes inlined and the stubs in place of the CUDA runtime."""
    csrc = os.path.join(ROOT, "tpupt_torch", "accel", "csrc")
    with open(os.path.join(csrc, name)) as fh:
        src = fh.read()
    with open(os.path.join(csrc, "trip_common.cuh")) as fh:
        common = fh.read().replace("#pragma once", "")
    return src.replace('#include "trip_common.cuh"', common).replace(
        "#include <cuda_runtime.h>", STUBS)


def launches_as_loops(src, expect):
    """Each launch ``k<<<grid, block, smem, stream>>>(args)`` as a loop over
    the blocks and threads, one thread at a time (``gridDim.x`` set to the
    grid)."""
    def loop(m):
        name, grid, block, args = m.groups()
        return (f"for (unsigned b_ = 0; b_ < (gridDim.x = (unsigned)({grid})); ++b_) "
                f"for (unsigned t_ = 0; t_ < (unsigned)({block}); ++t_) "
                f"{{ blockIdx.x = b_; threadIdx.x = t_; {name}({args}); }}")

    src, n = re.subn(r"(\w+(?:<\w+>)?)<<<(.+?), (\w+), \w+, stream>>>\(\s*(.*?)\);", loop, src,
                     flags=re.S)
    assert n >= expect, f"found {n} launches"
    # one thread at a time: every thread adds its own vote
    return src.replace("(threadIdx.x & 31) == 0 && votes != 0u", "votes != 0u")


def replace_functions(src, bodies):
    """Each device function ``name`` of ``bodies`` (its definition up to the
    first closing brace at the start of a line) replaced by its body."""
    for name, body in bodies.items():
        src, k = re.subn(r"(template <[^>]*>\n)?__device__ __forceinline__ void " + name
                         + r"\(.*?\n}\n", body.replace("\\", "\\\\") + "\n", src, count=1,
                         flags=re.S)
        assert k == 1, name
    return src


# trip_nee's CTA one thread at a time: each block's thread 0 stages the
# table, then runs each of its warps' chunks in turn: every thread's
# closing stores, then the chunk's live lanes in lane order (the warp's
# queue and its shuffles are what only the card runs)
NEE_CTA = """template <bool kStaged>
inline void nee_cta(const NeeArgs& a) {
  if (threadIdx.x != 0) return;
  for (unsigned t = 0; t < (unsigned)kGridThreads; ++t) {
    threadIdx.x = t;
    if (kStaged) stage_table(a.tab, a.n_stage);
  }
  threadIdx.x = 0;
  const int warps = gridDim.x * kGridWarps, chunks = a.n_pad / kWarpLanes;
  for (int w = 0; w < kGridWarps; ++w) {
    for (int c = blockIdx.x * kGridWarps + w; c < chunks; c += warps) {
      const int lane0 = c * kWarpLanes;
      for (int t = 0; t < 32; ++t) close_lanes(a, lane0 + t * kLanePer);
      for (int l = 0; l < kWarpLanes && lane0 + l < a.n; ++l) {
        if (a.I[(size_t)I_ALIVE * a.n + lane0 + l] != 0) nee_lane<kStaged>(a, lane0 + l);
      }
    }
  }
}"""
# trip_head's CTA the same way: each thread's flags, mask and seed stores
# (head_flags), then, where one lane is live, each thread's staging and its
# live lanes in place (head_run)
HEAD_CTA = """template <bool kStaged>
inline void head_cta(const HeadArgs& a) {
  if (threadIdx.x != 0) return;
  unsigned char* live = reinterpret_cast<unsigned char*>(grid_sm);
  const int base = blockIdx.x * kHeadLanes;
  bool any = false;
  for (unsigned t = 0; t < (unsigned)kThreads; ++t) {
    threadIdx.x = t;
    any |= head_flags(a, base, live);
  }
  for (unsigned t = 0; any && kStaged && t < (unsigned)kThreads; ++t) {
    threadIdx.x = t;
    stage_table(a.tab, a.n_stage);
  }
  for (unsigned t = 0; any && t < (unsigned)kThreads; ++t) {
    threadIdx.x = t;
    head_run<kStaged>(a, base, live);
  }
}"""
# trip_drain's list one thread at a time: each live lane takes the next
# entry (the warp's ranks behind one atomic are what only the card runs)
DRAIN_LIST = """inline void drain_list(const DrainArgs& d, int i, bool live) {
  if (!live) return;
  const int at = atomicAdd(d.len, 1);
  if (at < d.cap) d.ids[at] = i;
}"""
# trip_drain's CTA the same way: each thread's share of the staging, then
# each thread's listed lane drained in turn, the lanes left counted one by
# one, and by block 0 those the list could not hold
DRAIN_CTA = """template <bool kStaged>
inline void drain_cta(const DrainArgs& d) {
  if (threadIdx.x != 0) return;
  const int listed = min(*d.len, d.cap);
  if ((int)blockIdx.x * kThreads >= listed) return;
  for (unsigned t = 0; kStaged && t < (unsigned)kThreads; ++t) {
    threadIdx.x = t;
    stage_table(d.t.tab, d.n_stage);
  }
  for (unsigned t = 0; t < (unsigned)kThreads; ++t) {
    threadIdx.x = t;
    const int slot = blockIdx.x * kThreads + t;
    if (slot < listed && drain_lane<kStaged>(d, d.ids[slot])) atomicAdd(d.t.count, 1);
  }
  threadIdx.x = 0;
  if (blockIdx.x == 0 && *d.len > d.cap) atomicAdd(d.t.count, *d.len - d.cap);
}"""
# an entry the tests call: the CDF search alone
EXPORTS = """
extern "C" int emu_cdf_index(const float* cum, int n, float u) { return cdf_index(cum, n, u); }
"""


def compile_emulation(src, out_dir, name) -> ctypes.CDLL:
    cpp, lib = os.path.join(out_dir, f"{name}.cpp"), os.path.join(out_dir, f"lib{name}.so")
    with open(cpp, "w") as fh:
        fh.write(src)
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", cpp,
                    "-o", lib], check=True)
    return ctypes.CDLL(lib)


def build(out_dir, subs=()) -> ctypes.CDLL:
    """The emulation library of trip_kernels.cu with each (old, new) of
    ``subs`` applied (each must match once), its entries declared as
    ``kernels.bind`` declares them."""
    src = replace_functions(source("trip_kernels.cu"), {"nee_cta": NEE_CTA, "head_cta": HEAD_CTA,
                                                        "drain_list": DRAIN_LIST,
                                                        "drain_cta": DRAIN_CTA})
    for old, new in subs:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    src = src.replace("extern __shared__ float4 grid_sm[];", "float4 grid_sm[1 << 16] = {};")
    lib = compile_emulation(launches_as_loops(src, 4) + EXPORTS, out_dir, "trip_emu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.emu_cdf_index.argtypes = [P, I, ctypes.c_float]
    lib.tpupt_trip_head.argtypes = [P, P, I, I, P, I, P, P, P, P, P]
    lib.tpupt_trip_nee.argtypes = [P, P, I, I] + [P] * 9 + [I] * 7 + [P] * 5
    lib.tpupt_trip_tail.argtypes = [P, P, I] + [P] * 9 + [I] * 3 + [P] + [I] * 11 + [P] * 6
    lib.tpupt_trip_drain.argtypes = [P, P, I, P] + [I] * 5 + [P] + [I] * 9 + [P, I, P, P, P]
    return lib


def emulated_wrappers(lib) -> dict:
    """trip_head, trip_nee, trip_tail and trip_drain as the module defines them, with
    the CPU branch to the twins and the device checks taken out and the
    emulation library in place of the kernels'."""
    kernels.stream_of = lambda t: None
    kernels.check = lambda _lib, err, what: None if err == 0 else sys.exit(f"{what}: {err}")
    out = {}
    for name in ("trip_head", "trip_nee", "trip_tail", "trip_drain"):
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


@contextlib.contextmanager
def emulation(out_dir, subs=()):
    """(the emulated wrappers of ``emulated_wrappers``, the library) of a
    g++ build in ``out_dir`` (with ``subs``, as ``build`` takes them), with
    torch's sqrt, rsqrt, sin and cos correctly rounded and one intra-op
    thread; every global it changes is put back on exit."""
    patched = [(kernels, "stream_of"), (kernels, "check"), (torch, "sqrt"), (torch, "rsqrt"),
               (torch, "sin"), (torch, "cos")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in patched]
    threads = torch.get_num_threads()
    try:
        lib = build(out_dir, subs)
        wrappers = emulated_wrappers(lib)
        correctly_rounded_torch()
        torch.set_num_threads(1)
        yield wrappers, lib
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)
        torch.set_num_threads(threads)


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
    ap.add_argument("--scenes", default="lamp,many16,quad_mixed,ico_light,cornell.json,"
                                        "cornell_area.json,multimesh")
    args = ap.parse_args()
    body = functools.partial(intersect_scene_ids)
    bad = 0
    with tempfile.TemporaryDirectory() as tmp, emulation(tmp) as (emu, _lib):
        wrappers = {k: getattr(trip_kernel, k) for k in emu}
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
