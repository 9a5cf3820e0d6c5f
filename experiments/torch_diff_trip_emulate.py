"""The differentiable trip's CUDA source run on the CPU: a rehearsal of
``tpupt_torch/accel/csrc/diff_trip_kernels.cu`` where there is no card and
no nvcc.

    python experiments/torch_diff_trip_emulate.py [--size 16]

As ``experiments/torch_trip_emulate.py`` does for the trip kernels, g++
compiles the source against stubs of the CUDA built-ins, each launch a
loop over the blocks and threads, one thread at a time.  What a warp or a
CTA does together cannot run one thread at a time, so seven device
functions are replaced by plain loops and adds (``REDUCTIONS``): the
forward's CTA (``fwd_cta``: each thread's flags, codes and residual
stores by the kernel's own ``fwd_scan``, then, where a lane is live, each
thread's lanes in place by ``fwd_run``, the lanes left summed),
the backward's CTA loop (``cta_lanes``: the work counter, the chunk's scan and
its queues by case become one loop over the lanes in order, each live lane
handed to ``case_warp`` as a warp of one), the leaf table's warp sums and
CTA flush (``block_table_zero``, ``warp_add_keyed``,
``block_table_flush``), and the slot table's scatter (``scatter_row``,
which the backward's triangle lanes and ``slot_scatter`` call, and
``slot_scatter``'s 16-byte slot loads passed round the warp,
``round_slots``, which becomes each lane's own slot read).  The
emulation checks each case's per-lane arithmetic, the layout and the
control flow around them, not the reductions or the queues, which only the
card runs (``chip_smoke.py`` and the card tests hold them to the twins).
Both sides use correctly rounded float32 sqrt, rsqrt, sin and cos.

For each scene (spheres of all four materials; the same with two meshes;
bunny.json), with roulette and without: the differentiable render through
the emulated kernels against the same render through the twins, forward
bit-equal, and every leaf's gradient (the loss taking colour, normal and
depth) and each sample's slot table gradient within rtol 1e-5 of the
twins' (atol 1e-5 x the leaf's or table's max |grad|).  Exits non-zero if
any differs.  ``tests/test_torch_diff_trip_emulated.py`` runs the same
comparison at 8^2, and ``slot_scatter``'s emulation against
``index_add_``.
"""

import argparse
import contextlib
import ctypes
import inspect
import os
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

# what a warp or a CTA does together, as plain loops and adds one thread at
# a time: each block's thread 0 takes chunks from the work counter and runs
# their lanes in order, and the shared table is a static array that each
# block's last thread flushes
REDUCTIONS = {
    "cta_lanes": """inline void cta_lanes(const BwdArgs& a, double* sm, int*, unsigned short*) {
  if (threadIdx.x != 0) return;
  const int chunks = (int)(((long long)a.n + kChunk - 1) / kChunk);
  for (int t; (t = take_chunk(a.work, chunks)) < chunks;) {
    for (int i = t * kChunk; i < a.n && i < (t + 1) * kChunk; ++i) {
      const int code = a.res_i[(size_t)R_CODE * a.n + i];
      if (code != kDead) case_warp(a, sm, code == kMiss ? C_MISS : ((code & 1) ? C_TRI : C_SPHERE), i);
    }
  }
}""",
    "fwd_cta": """inline void fwd_cta(const FwdArgs& a, int* codes) {
  if (threadIdx.x != 0) return;
  const int base = blockIdx.x * kFwdLanes;
  bool any = false;
  for (unsigned t = 0; t < (unsigned)kFwdThreads; ++t) {
    threadIdx.x = t;
    any |= fwd_scan(a, base, codes);
  }
  if (!any) return;
  int left = 0;
  for (unsigned t = 0; t < (unsigned)kFwdThreads; ++t) {
    threadIdx.x = t;
    left += fwd_run(a, base, codes);
  }
  if (left != 0) atomicAdd(a.count, left);
}""",
    "block_table_zero": "inline void block_table_zero(double*, int) {}",
    "warp_add_keyed": """template <int W>
inline void warp_add_keyed(double* sm, int base, int key, const float (&v)[W]) {
  if (key >= 0) for (int j = 0; j < W; ++j) sm[base + key * W + j] += v[j];
}""",
    "block_table_flush": """inline void block_table_flush(double* sm, const BwdArgs& a, int n_ent) {
  if (threadIdx.x != kBwdThreads - 1) return;
  for (int e = 0; e < n_ent; ++e) {
    if (sm[e] != 0.0) a.gtab[leaf_index(a, e)] += sm[e];
    sm[e] = 0.0;
  }
}""",
    "scatter_row": """inline void scatter_row(float* g, int s, const float (&v)[9]) {
  if (s >= 0) for (int k = 0; k < 9; ++k) g[(size_t)s * 9 + k] += v[k];
}""",
    "round_slots": """inline void round_slots(const int* slot, long long w0, int n, bool, int (&s)[4]) {
  for (int k = 0; k < 4; ++k) {
    const long long i = w0 + 32 * k + (threadIdx.x & 31);
    s[k] = i < n ? slot[i] : -1;
  }
}""",
}
STUBS = r"""
inline double __shfl_xor_sync(unsigned, double v, int) { return v; }
inline int __ffs(unsigned v) { return __builtin_ffs(v); }
inline float __fdividef(float a, float b) { return a / b; }
inline unsigned __match_any_sync(unsigned, int) { return 1u; }
inline float atomicAdd(float* a, float v) { float o = *a; *a += v; return o; }
inline double atomicAdd(double* a, double v) { double o = *a; *a += v; return o; }
"""


def build(out_dir) -> ctypes.CDLL:
    src = emu.source("diff_trip_kernels.cu").replace("namespace {", STUBS + "\nnamespace {", 1)
    src = emu.replace_functions(src, REDUCTIONS)
    src = src.replace("extern __shared__ double sm[];", "static double sm[1 << 16] = {};")
    src = src.replace("__shared__ int codes[kFwdLanes];", "static int codes[kFwdLanes] = {};")
    # the backward's chunks of 16 lanes, so that a small sample's bounce
    # spans several CTAs, which hand the work counter on and leave it at 0
    assert src.count("constexpr int kChunk = 2048;") == 1
    src = src.replace("constexpr int kChunk = 2048;", "constexpr int kChunk = 16;")
    lib = emu.compile_emulation(emu.launches_as_loops(src, 3), out_dir, "diff_trip_emu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tpupt_diff_trip_fwd.argtypes = [P, P, I] + [P] * 13 + [I] * 6 + [P] * 4
    lib.tpupt_diff_trip_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.tpupt_diff_trip_bwd_smem_bytes.argtypes = [I, I]
    lib.tpupt_diff_trip_bwd.argtypes = [P, I] + [P] * 4 + [I, P] + [I] * 7 + [P] * 4
    lib.tpupt_slot_scatter.argtypes = [P, I, P, P, I, I, I, P]
    return lib


def emulated_wrappers(lib) -> dict:
    """diff_trip_fwd, diff_trip_bwd and slot_scatter as their modules
    define them, with the CPU branch to the twins and the device checks
    taken out and the emulation library in place of the kernels'.  Sets
    ``kernels.stream_of`` and ``kernels.check`` for the emulation
    (``emulation`` puts them back)."""
    kernels.stream_of = lambda t: None
    kernels.check = lambda _lib, err, what: None if err == 0 else sys.exit(f"{what}: {err}")
    out = {}
    for mod, name, subs in (
            (diff_trip, "diff_trip_fwd", [('F.device.type == "cpu"', "False")]),
            (diff_trip, "diff_trip_bwd", [
                ('G.device.type == "cpu"', "False"),
                ("torch.cuda.get_device_properties(G.device).shared_memory_per_block_optin",
                 "232448")]),
            (ss, "slot_scatter", [('g.device.type == "cpu"', "False"), ("g.is_cuda and ", ""),
                                  ("kernels.load()", "_lib")])):
        src = inspect.getsource(getattr(mod, name))
        for a, b in subs:
            assert a in src, (name, a)
            src = src.replace(a, b)
        scope = dict(vars(mod), _check=lambda *a: lib, _lib=lib)
        exec(src, scope)
        out[name] = scope[name]
        if name == "slot_scatter":
            out[name].launches = 0
    return out


@contextlib.contextmanager
def emulation(out_dir):
    """The emulated wrappers (``emulated_wrappers``) of a g++ build in
    ``out_dir``, with torch's sqrt, rsqrt, sin and cos correctly rounded
    and one intra-op thread; every global it changes is put back on exit."""
    patched = [(kernels, "stream_of"), (kernels, "check"), (torch, "sqrt"), (torch, "rsqrt"),
               (torch, "sin"), (torch, "cos")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in patched]
    threads = torch.get_num_threads()
    try:
        wrappers = emulated_wrappers(build(out_dir))
        emu.correctly_rounded_torch()
        torch.set_num_threads(1)
        yield wrappers
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)
        torch.set_num_threads(threads)


SCENES = ("spheres", "spheres+meshes", "bunny.json", "nine spheres")


def scene(name, tmp):
    """(scene, camera) of one of SCENES: spheres of the four materials,
    the same with two icosphere meshes (metal and glass), bunny.json (its
    model generated under ``tmp``), tests/test_torch_trip.py's nine
    spheres (an exact-t tie, a radius-1000 ground)."""
    if name == "nine spheres":
        import test_torch_trip

        return test_torch_trip.nine_spheres()
    if name == "bunny.json":
        import shutil

        from tpupt_torch.scene.assets_gen import ensure_models, locate_asset_path
        from tpupt_torch.scene.json_parser import scene_from_json

        scenes_dir = os.path.join(tmp, "s")
        if not os.path.isdir(scenes_dir):
            shutil.copytree(os.path.join(locate_asset_path(ROOT), "scenes"), scenes_dir)
        ensure_models(os.path.join(tmp, "models"), names=["bunny.obj"])
        d = scene_from_json(os.path.join(scenes_dir, "bunny.json"))
        return d.build(leaf_size=32, device="cpu"), d.camera
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
    if name == "spheres+meshes":
        v, f = icosphere(2)
        d.add_mesh("ico", v, f)
        d.add_mesh_object("ico", t([0.3, 0.6, -1.5]), "metal")
        d.add_mesh_object("ico", t([-0.4, 0.5, -0.6]) @ np.diag([0.3, 0.3, 0.3, 1.0]), "glass")
    return d.build(device="cpu"), make_camera(vfov=np.pi / 2)


LEAVES = PARAM_LEAVES + tuple(f"materials.{k}" for k in MATERIAL_LEAVES)


def leaf(params, name):
    return params["materials"][name[10:]] if name.startswith("materials.") else params[name]


def step(scn, cam, size, rr, wrappers):
    """The differentiable render (2 spp, 4 bounces) through ``wrappers``'
    diff_trip_fwd and diff_trip_bwd, its loss and gradients: (buffers,
    segments, {leaf: grad}, [each sample's slot table gradient])."""
    slots, bwd = [], wrappers["diff_trip_bwd"]

    def recording_bwd(dp, G, res, seed, b, gtab, g_slot=None):
        if g_slot is not None and not any(g_slot is s for s in slots):
            slots.append(g_slot)
        return bwd(dp, G, res, seed, b, gtab, g_slot)

    saved = diff_trip.diff_trip_fwd, diff_trip.diff_trip_bwd
    diff_trip.diff_trip_fwd, diff_trip.diff_trip_bwd = wrappers["diff_trip_fwd"], recording_bwd
    try:
        params = extract_params(scn)
        buf, rays = render_image(with_params(scn, params), cam, size, size, 2, max_bounces=4,
                                 differentiable=True, rr_start=rr)
        loss = ((buf.color ** 2).sum() + 0.1 * buf.normal.sum()
                + 0.01 * buf.depth.clamp(max=20).sum())
        grads = torch.autograd.grad(loss, [leaf(params, k) for k in LEAVES], allow_unused=True,
                                    materialize_grads=True)
    finally:
        diff_trip.diff_trip_fwd, diff_trip.diff_trip_bwd = saved
    return buf, int(rays), dict(zip(LEAVES, grads)), slots


def compare(scn, cam, size, rr, emulated) -> dict:
    """The render of ``step`` through the emulated kernels and through the
    twins: whether the forward (colour, normal, depth, segments) is equal,
    each leaf's and slot table gradient's largest gap over its max
    |grad|, and ``ok``: the forward equal, every gradient finite and at
    rtol 1e-5 (atol 1e-5 x its max |grad|)."""
    twins = {"diff_trip_fwd": diff_trip.diff_trip_fwd, "diff_trip_bwd": diff_trip.diff_trip_bwd}
    got = step(scn, cam, size, rr, emulated)
    want = step(scn, cam, size, rr, twins)
    same = {k: torch.equal(getattr(got[0], k), getattr(want[0], k))
            for k in ("color", "normal", "depth")}
    same["segments"] = got[1] == want[1]
    pairs = [(k, got[2][k], want[2][k]) for k in LEAVES]
    pairs += [(f"slot table {j}", a, b) for j, (a, b) in enumerate(zip(got[3], want[3]))]
    gaps, ok = {}, all(same.values()) and len(got[3]) == len(want[3])
    for k, a, b in pairs:
        scale = float(b.abs().max())
        gaps[k] = float((a - b).abs().max()) / scale if scale > 0 else 0.0
        ok &= bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5 * scale))
        ok &= bool(torch.isfinite(a).all())
    return dict(ok=ok, forward_equal=same, segments=(got[1], want[1]), gaps=gaps,
                slot_tables=len(got[3]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=16)
    args = ap.parse_args()
    bad = 0
    with tempfile.TemporaryDirectory() as tmp, emulation(tmp) as emulated:
        for name in SCENES:
            scn, cam = scene(name, tmp)
            assert render_route(scn, True) == "diff_trip", name
            for rr in (None, 1):
                r = compare(scn, cam, args.size, rr, emulated)
                bad += not r["ok"]
                worst = max(r["gaps"], key=r["gaps"].get)
                print(f"{name:16s} rr {str(rr):4s} segments {r['segments'][0]} / "
                      f"{r['segments'][1]}; forward equal {r['forward_equal']}; "
                      f"{r['slot_tables']} slot table gradients; largest gradient gap "
                      f"{r['gaps'][worst]:.3g} of its max |grad| ({worst})"
                      f"{'' if r['ok'] else '  <-- differs'}", flush=True)
                if not r["ok"]:
                    print("   ", {k: f"{v:.3g}" for k, v in r["gaps"].items()})
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
