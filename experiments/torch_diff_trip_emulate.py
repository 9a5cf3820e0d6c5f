"""The differentiable trip's CUDA source run on the CPU: a rehearsal of
``tpupt_torch/accel/csrc/diff_trip_kernels.cu`` where there is no card and
no nvcc.

    python experiments/torch_diff_trip_emulate.py [--size 16]

As ``experiments/torch_trip_emulate.py`` does for the trip kernels, g++
compiles the source against stubs of the CUDA built-ins, each launch a
loop over the blocks and threads, one thread at a time.  The warp and
block sums of the backward's leaf table and of ``slot_scatter`` cannot run
one thread at a time, so their four device functions (``block_table_zero``,
``warp_add_keyed``, ``block_table_flush``, ``scatter_row``) are replaced by
plain adds of each lane's values: the emulation checks the per-lane
arithmetic, layout and control flow, not the reductions, which only the
card runs (``chip_smoke.py`` holds them to the twins).  Both sides use
correctly rounded float32 sqrt, rsqrt, sin and cos.

For each scene (spheres of all four materials; the same with two meshes;
bunny.json), with roulette and without: the differentiable render through
the emulated kernels against the same render through the twins, forward
bit-equal, and every leaf's gradient, the loss taking colour, normal and
depth, within rtol 1e-5 of the twins' (atol 1e-5 x the leaf's max
|grad|).  Exits non-zero if any differs.
"""

import argparse
import ctypes
import inspect
import os
import re
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "experiments"))

import torch_trip_emulate as emu  # noqa: E402
from tpupt_torch import extract_params, with_params  # noqa: E402
from tpupt_torch.accel import kernels, slot_scatter as ss  # noqa: E402
from tpupt_torch.core import math3d as m3  # noqa: E402
from tpupt_torch.core.camera import make_camera  # noqa: E402
from tpupt_torch.diff.params import MATERIAL_LEAVES, PARAM_LEAVES  # noqa: E402
from tpupt_torch.render import diff_trip  # noqa: E402
from tpupt_torch.render.integrator import render_image, render_route  # noqa: E402
from tpupt_torch.scene.description import SceneDescription  # noqa: E402
from tpupt_torch.scene.procedural import icosphere  # noqa: E402

# the warp- and block-level sums as plain adds, one thread at a time; the
# shared table is a static array that the block's last thread flushes
REDUCTIONS = {
    "block_table_zero": "inline void block_table_zero(double*, int) {}",
    "warp_add_keyed": """template <int W>
inline void warp_add_keyed(double* sm, int base, int key, const float (&v)[W]) {
  if (key >= 0) for (int j = 0; j < W; ++j) sm[base + key * W + j] += v[j];
}""",
    "block_table_flush": """inline void block_table_flush(double* sm, const BwdArgs& a, int n_ent) {
  if (threadIdx.x != kThreads - 1) return;
  for (int e = 0; e < n_ent; ++e) {
    if (sm[e] != 0.0) a.gtab[leaf_index(a, e)] += sm[e];
    sm[e] = 0.0;
  }
}""",
    "scatter_row": """inline void scatter_row(float* g, int s, const float (&v)[9]) {
  if (s >= 0) for (int k = 0; k < 9; ++k) g[(size_t)s * 9 + k] += v[k];
}""",
}
STUBS = r"""
inline double __shfl_xor_sync(unsigned, double v, int) { return v; }
inline int __shfl_sync(unsigned, int v, int) { return v; }
inline float __shfl_sync(unsigned, float v, int) { return v; }
inline int __ffs(unsigned v) { return __builtin_ffs(v); }
inline unsigned __match_any_sync(unsigned, int) { return 1u; }
inline void __syncthreads() {}
inline float atomicAdd(float* a, float v) { float o = *a; *a += v; return o; }
inline double atomicAdd(double* a, double v) { double o = *a; *a += v; return o; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K> inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
"""


def build(out_dir) -> ctypes.CDLL:
    src = emu.source("diff_trip_kernels.cu").replace("namespace {", STUBS + "\nnamespace {", 1)
    for name, body in REDUCTIONS.items():
        src, k = re.subn(r"(template <int W>\n)?__device__ __forceinline__ void " + name
                         + r"\(.*?\n}\n", body.replace("\\", "\\\\") + "\n", src, count=1,
                         flags=re.S)
        assert k == 1, name
    src = src.replace("extern __shared__ double sm[];", "static double sm[1 << 16] = {};")
    lib = emu.compile_emulation(emu.launches_as_loops(src, 3), out_dir, "diff_trip_emu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tpupt_diff_trip_fwd.argtypes = [P, P, I] + [P] * 13 + [I] * 6 + [P] * 4
    lib.tpupt_diff_trip_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.tpupt_diff_trip_bwd_smem_bytes.argtypes = [I, I]
    lib.tpupt_diff_trip_bwd.argtypes = [P, I] + [P] * 5 + [I] * 7 + [P] * 3
    lib.tpupt_slot_scatter.argtypes = [P, I, P, P, I, I, I, P]
    return lib


def emulated_wrappers(lib) -> dict:
    """diff_trip_fwd, diff_trip_bwd (with diff_trip_bwd_lanes) and
    slot_scatter as their modules define them, with the CPU branch to the
    twins and the device checks taken out and the emulation library in
    place of the kernels'."""
    kernels.stream_of = lambda t: None
    kernels.check = lambda _lib, err, what: None if err == 0 else sys.exit(f"{what}: {err}")
    out = {}
    for mod, name, subs in (
            (diff_trip, "diff_trip_fwd", [('F.device.type == "cpu"', "False")]),
            (diff_trip, "diff_trip_bwd_lanes", [(
                "torch.cuda.get_device_properties(G.device).shared_memory_per_block_optin",
                "232448")]),
            (ss, "slot_scatter", [('g.device.type == "cpu"', "False"), ("g.is_cuda and ", ""),
                                  ("kernels.load()", "_lib")]),
            # the wrapper around the two above, which calls their emulations
            (diff_trip, "diff_trip_bwd", [('G.device.type == "cpu"', "False")])):
        src = inspect.getsource(getattr(mod, name))
        for a, b in subs:
            assert a in src, (name, a)
            src = src.replace(a, b)
        scope = dict(vars(mod), _check=lambda *a: lib, _lib=lib, **out)
        exec(src, scope)
        out[name] = scope[name]
        if name == "slot_scatter":
            out[name].launches = 0
    return out


def scenes(size):
    """(name, scene, camera): spheres of the four materials, the same with
    two icosphere meshes (metal and glass), bunny.json."""
    from tpupt_torch.scene.assets_gen import ensure_models, locate_asset_path
    from tpupt_torch.scene.json_parser import scene_from_json

    def spheres(mesh):
        d = SceneDescription()
        d.add_material("ground", "lambertian", albedo=(0.8, 0.8, 0.0))
        d.add_material("blue", "lambertian", albedo=(0.1, 0.2, 0.5))
        d.add_material("glass", "dielectric", refraction_index=1.5)
        d.add_material("metal", "metal", albedo=(0.8, 0.6, 0.2), fuzz=0.3)
        t = lambda v: np.asarray(m3.mat_translate(v), np.float64)  # noqa: E731
        d.add_sphere(100.0, t([0, -100.5, -1.0]), "ground")
        d.add_sphere(0.5, t([0, 0, -1.0]), "blue")
        d.add_sphere(0.5, t([-1, 0, -1.0]), "glass")
        d.add_sphere(0.5, t([1, 0, -1.0]), "metal")
        if mesh:
            v, f = icosphere(2)
            d.add_mesh("ico", v, f)
            d.add_mesh_object("ico", t([0.3, 0.6, -1.5]), "metal")
            d.add_mesh_object("ico", t([-0.4, 0.5, -0.6]) @ np.diag([0.3, 0.3, 0.3, 1.0]),
                              "glass")
        return d.build(device="cpu")

    cam = make_camera(vfov=np.pi / 2)
    yield "spheres", spheres(False), cam
    yield "spheres+meshes", spheres(True), cam
    with tempfile.TemporaryDirectory() as tmp:
        import shutil

        shutil.copytree(os.path.join(locate_asset_path(ROOT), "scenes"), os.path.join(tmp, "s"))
        ensure_models(os.path.join(tmp, "models"), names=["bunny.obj"])
        d = scene_from_json(os.path.join(tmp, "s", "bunny.json"))
        yield "bunny.json", d.build(leaf_size=32, device="cpu"), d.camera


LEAVES = PARAM_LEAVES + tuple(f"materials.{k}" for k in MATERIAL_LEAVES)


def leaf(params, name):
    return params["materials"][name[10:]] if name.startswith("materials.") else params[name]


def step(scene, cam, size, rr):
    params = extract_params(scene)
    buf, rays = render_image(with_params(scene, params), cam, size, size, 2, max_bounces=4,
                             differentiable=True, rr_start=rr)
    loss = (buf.color ** 2).sum() + 0.1 * buf.normal.sum() + 0.01 * buf.depth.clamp(max=20).sum()
    grads = torch.autograd.grad(loss, [leaf(params, k) for k in LEAVES], allow_unused=True,
                                materialize_grads=True)
    return buf, int(rays), dict(zip(LEAVES, grads))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=16)
    args = ap.parse_args()
    torch.set_num_threads(1)
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        emulated = emulated_wrappers(build(tmp))
        twins = {"diff_trip_fwd": diff_trip.diff_trip_fwd, "diff_trip_bwd": diff_trip.diff_trip_bwd}
        emu.correctly_rounded_torch()

        def use(wrappers):
            diff_trip.diff_trip_fwd = wrappers["diff_trip_fwd"]
            diff_trip.diff_trip_bwd = wrappers["diff_trip_bwd"]

        for name, scene, cam in scenes(args.size):
            assert render_route(scene, True) == "diff_trip", name
            for rr in (None, 1):
                use(emulated)
                got = step(scene, cam, args.size, rr)
                use(twins)
                want = step(scene, cam, args.size, rr)
                same = {k: torch.equal(getattr(got[0], k), getattr(want[0], k))
                        for k in ("color", "normal", "depth")}
                gaps = {}
                ok = all(same.values()) and got[1] == want[1]
                for k in LEAVES:
                    a, b = got[2][k], want[2][k]
                    scale = float(b.abs().max())
                    close = torch.allclose(a, b, rtol=1e-5, atol=1e-5 * scale)
                    gaps[k] = float((a - b).abs().max()) / scale if scale > 0 else 0.0
                    ok &= close and bool(torch.isfinite(a).all())
                bad += not ok
                print(f"{name:16s} rr {str(rr):4s} segments {got[1]} / {want[1]}; forward equal "
                      f"{same}; largest gradient gap {max(gaps.values()):.3g} of its leaf's max "
                      f"|grad| ({max(gaps, key=gaps.get)}){'' if ok else '  <-- differs'}",
                      flush=True)
                if not ok:
                    print("   ", {k: f"{v:.3g}" for k, v in gaps.items()})
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
