"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA
kernels from the sources in this checkout, holds each against its torch
twin at the main path's shapes, renders the bunny scene at full size and
checks the result.

    python chip_smoke.py

Phases print as they go; any failure raises and the script exits non-zero.
Without a CUDA device, or without the rest of the repository beside it,
it fails before printing any result.  Its standard output ends with:
  * the card's name and power limit, as nvidia-smi reports them,
  * one JSON line {"kernels": [...], "off_path": [...]}: per kernel its
    launches in the main-path render and its measured error and times,
  * {"ok": true, "device": {...}} as the last line.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch sees no CUDA device")

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import tpupt_torch  # noqa: E402  (needs the repository beside this script)
from tpupt_torch.accel import kernels, packets, step_kernel, sweep_kernel  # noqa: E402
from tpupt_torch.core.camera import generate_rays, pixel_centers  # noqa: E402
from tpupt_torch.render import integrator, intersect  # noqa: E402
from tpupt_torch.render.materials import shade  # noqa: E402
from tpupt_torch.scene.assets_gen import ensure_models, locate_asset_path  # noqa: E402
from tpupt_torch.scene.json_parser import scene_from_json  # noqa: E402

DEV = torch.device("cuda")
SIZE, SPP, MAX_BOUNCES, RR = 1024, 16, 50, 8  # the main path's render
OUT = os.path.join(ROOT, "chiprun_out")


def phase(name):
    print(f"\n== {name}", flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds per call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ulp_gap(a, b):
    """Largest distance in float32 ulps between two float tensors."""
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max()) if a.numel() else 0


def require_equal(name, got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            gap = ulp_gap(a.float(), b.float()) if a.is_floating_point() else "n/a"
            raise AssertionError(f"{name}: output {i} differs from the twin (max ulp gap {gap})")


# --- 0 -------------------------------------------------------------------
phase("0 environment")
smi = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True, check=True,
).stdout.strip().splitlines()[0]
print(f"card: {smi}")
try:
    import triton

    triton_version = triton.__version__
except ImportError:
    triton_version = "absent"
nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True, text=True,
                      check=True).stdout.strip().splitlines()[-1]
print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}  "
      f"nvcc {nvcc}  triton {triton_version}")
print(f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
      f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")

# --- 1 -------------------------------------------------------------------
phase("1 build")
t0 = time.perf_counter()
kernels.load()
print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s: {kernels.library_path()}")
with open(kernels.library_path() + ".log") as fh:
    print("".join(ln for ln in fh if "registers" in ln or "Compiling" in ln).rstrip())

# --- scene (shared by phases 2-5) ---------------------------------------
ensure_models(names=["bunny.obj"])
desc = scene_from_json(os.path.join(locate_asset_path(), "scenes", "bunny.json"))
t0 = time.perf_counter()
scene = desc.build(leaf_size=32, device=DEV)
K, L = scene.tre_min.shape[0], scene.s_leaf_size
print(f"bunny.json built in {time.perf_counter() - t0:.2f} s: K={K} treelets of L={L}")

# --- 2 -------------------------------------------------------------------
phase("2 winner_step vs twin, sz=4096")
rng = np.random.default_rng(0)
sz, p, rl = 4096, 256, 64
tids = rng.integers(0, K, (sz, rl // L))
comps = (scene.tre_tris.view(K, 13, L)[torch.from_numpy(tids).to(DEV)]
         .permute(0, 2, 1, 3).reshape(sz, 13, rl).contiguous())
# each ray aims from around the scene at a point inside one triangle of its
# row's first treelet (a pad triangle's ray misses)
j = torch.from_numpy(rng.integers(0, L, (sz, p))).to(DEV)
tri = torch.gather(comps[:, :9, :], 2, j[:, None, :].expand(sz, 9, p))  # (sz, 9, p)
target = tri[:, 0:3] + 0.3 * tri[:, 3:6] + 0.3 * tri[:, 6:9]
o = torch.from_numpy(rng.uniform(-3.0, 3.0, (sz, 3, p)).astype(np.float32)).to(DEV)
o[:, 1] += 2.0
d = target - o
d = (d / d.norm(dim=1, keepdim=True)).permute(0, 2, 1)
o = o.permute(0, 2, 1)
rows = {k: v.contiguous() for k, v in dict(
    rox=o[..., 0], roy=o[..., 1], roz=o[..., 2], rdx=d[..., 0], rdy=d[..., 1], rdz=d[..., 2],
    tmin=torch.full((sz, p), 1e-4, device=DEV),
    t=torch.where(torch.rand((sz, p), device=DEV, generator=torch.Generator(DEV).manual_seed(1))
                  < 0.2, 4.0, 3.0e38)).items()}
slots = torch.from_numpy((tids[:, :, None] * L + np.arange(L)).reshape(sz, rl)).int().to(DEV)
live = torch.from_numpy((rng.random((sz, rl)) < 0.9).astype(np.float32)).to(DEV)
out_k = step_kernel.winner_step(rows, comps, live, slots)
out_p = step_kernel.winner_step_plain(rows, comps, live, slots)
torch.cuda.synchronize()
require_equal("winner_step", out_k, out_p)
n_hit = int((out_k[0] < 3.0e38).sum())
assert n_hit > 1000, f"winner_step inputs produced only {n_hit} hits"
ws_ms = cuda_ms(lambda: step_kernel.winner_step(rows, comps, live, slots), 20)
ws_plain_ms = cuda_ms(lambda: step_kernel.winner_step_plain(rows, comps, live, slots), 5)
print(f"equal on all 6 channels ({n_hit} hit lanes); kernel {ws_ms:.4f} ms, twin {ws_plain_ms:.4f} ms")

# --- 3 -------------------------------------------------------------------
phase("3 treelet_closest_hit vs twin on bunny.json, 1024^2")
n = SIZE * SIZE
fx, fy = pixel_centers(SIZE, SIZE, device=DEV)
ro, rd = generate_rays(desc.camera.to(DEV), SIZE, SIZE, fx, fy)


def sphere_seed(ro, rd, t_min, active):
    z = torch.zeros(n, device=DEV)
    return intersect._sphere_pass(
        scene, ro, rd, t_min, active, z + intersect.BIG_T, z.int() - 1, z.long() - 1,
        z.long() - 1,
    )[0]


def compare_sweep(label, ro, rd, t_min, active):
    t_seed = sphere_seed(ro, rd, t_min, active)
    call = lambda ch: packets.intersect_treelets(scene, ro, rd, t_min, t_seed, active,
                                                 closest_hit=ch)
    tk, sk, ek = call(sweep_kernel.treelet_closest_hit)
    tp, sp, ep = call(sweep_kernel.treelet_closest_hit_plain)
    torch.cuda.synchronize()
    hit = sk >= 0
    require_equal(f"treelet_closest_hit {label}", (sk, tk, ek["obj"], ek["nx"], ek["ny"], ek["nz"]),
                  (sp, tp, ep["obj"], ep["nx"], ep["ny"], ep["nz"]))
    err = float((tk[hit] - tp[hit]).abs().max()) if bool(hit.any()) else 0.0
    ms = cuda_ms(lambda: call(sweep_kernel.treelet_closest_hit), 5)
    plain_ms = cuda_ms(lambda: call(sweep_kernel.treelet_closest_hit_plain), 2)
    print(f"{label}: {int(active.sum())} live rays, {int(hit.sum())} mesh hits, slot/obj/hit/t "
          f"equal; kernel {ms:.3f} ms, twin {plain_ms:.3f} ms")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, hits=int(hit.sum()))


t_min = torch.full((n,), 1e-4, device=DEV)
primary = compare_sweep("pixel-centre primaries", ro, rd, t_min, torch.ones(n, dtype=torch.bool,
                                                                            device=DEV))
# secondaries: one bounce of the render's own jittered primaries
pix = torch.arange(n, device=DEV)
st, seed = integrator._fresh_state(scene, desc.camera.to(DEV), SIZE, SIZE, pix, 0)
_ids, hit0 = intersect.intersect_scene_ids(scene, st["ro"], st["rd"], st["t_min"], st["alive"])
ro2, rd2, tmin2, *_ = shade(scene, hit0, st["ro"], st["rd"], st["t_min"], st["color"], seed,
                            torch.zeros_like(pix))
secondary = compare_sweep("secondaries after bounce 0", ro2, rd2, tmin2, hit0.mask)

# --- 4 -------------------------------------------------------------------
phase(f"4 main path: bunny.json render {SIZE}^2, {SPP} spp, {MAX_BOUNCES} bounces, rr {RR}")
counted = (sweep_kernel.treelet_closest_hit, step_kernel.winner_step)
for w in counted:
    w.launches = 0
torch.cuda.synchronize()
t0 = time.perf_counter()
buf, rays = tpupt_torch.render_image(scene, desc.camera, SIZE, SIZE, spp=SPP,
                                     max_bounces=MAX_BOUNCES, rr_start=RR, device=DEV)
torch.cuda.synchronize()
first_s = time.perf_counter() - t0
launches = {w.__name__: w.launches for w in counted}
rays = int(rays)
img = buf.color
assert launches["treelet_closest_hit"] > 0, launches
assert rays > n, rays
assert tuple(img.shape) == (n, 3) and bool(torch.isfinite(img).all()), "non-finite image"
assert bool(torch.isfinite(buf.normal).all() and torch.isfinite(buf.depth).all())
mean = img.mean(dim=0).tolist()
assert 0.05 < min(mean) and max(mean) < 1.5, f"implausible mean colour {mean}"
print(f"first call {first_s:.2f} s; launches {launches}; {rays} traced segments; "
      f"mean colour {[round(x, 4) for x in mean]}")
walls = []
for _ in range(3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buf2, rays2 = tpupt_torch.render_image(scene, desc.camera, SIZE, SIZE, spp=SPP,
                                           max_bounces=MAX_BOUNCES, rr_start=RR, device=DEV)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    assert int(rays2) == rays and torch.equal(buf2.color, img), "render is not deterministic"
wall = sorted(walls)[1]
print(f"calls 2-4: {', '.join(f'{w:.3f}' for w in walls)} s wall; median {wall:.3f} s = "
      f"{rays / wall / 1e6:.3f} traced Mrays/s  [{smi}]")
os.makedirs(OUT, exist_ok=True)
np.save(os.path.join(OUT, "bunny_1024_16spp.npy"),
        img.reshape(SIZE, SIZE, 3).cpu().numpy().astype(np.float16))

# --- 5 -------------------------------------------------------------------
phase("5 render parity, kernel vs twin: 256^2, 2 spp, 8 bounces")
twin = lambda *a: intersect.intersect_scene_ids(
    *a, closest_hit=sweep_kernel.treelet_closest_hit_plain)
bk, rk = tpupt_torch.render_image(scene, desc.camera, 256, 256, spp=2, max_bounces=8, device=DEV)
bp, rp = tpupt_torch.render_image(scene, desc.camera, 256, 256, spp=2, max_bounces=8,
                                  intersect_fn=twin, device=DEV)
assert int(rk) == int(rp), (int(rk), int(rp))
for key in ("color", "normal", "depth"):
    a, b = getattr(bk, key), getattr(bp, key)
    assert torch.allclose(a, b, rtol=1e-4, atol=1e-5), key
    print(f"{key}: max |kernel - twin| = {float((a - b).abs().max()):.3g}")
print(f"ray count equal: {int(rk)}")

# --- report ----------------------------------------------------------------
report = {
    "kernels": [dict(
        name="treelet_closest_hit", route="cuda",
        source="tpupt_torch/accel/csrc/treelet_kernels.cu",
        replaces="tpupt/accel/pallas_sweep.py:54",
        launches=launches["treelet_closest_hit"],
        max_abs_err=max(primary["max_abs_err"], secondary["max_abs_err"]),
        ms=primary["ms"], plain_ms=primary["plain_ms"],
        secondary_ms=secondary["ms"], secondary_plain_ms=secondary["plain_ms"],
    )],
    # not launched by the main path, which runs its MT-and-fold routine
    # inside treelet_closest_hit
    "off_path": [dict(
        name="winner_step", route="cuda",
        source="tpupt_torch/accel/csrc/treelet_kernels.cu",
        replaces="tpupt/accel/pallas_step.py:64",
        launches=launches["winner_step"],
        max_abs_err=float((out_k[0] - out_p[0]).abs().max()), ms=ws_ms, plain_ms=ws_plain_ms,
    )],
    "render": dict(rays=rays, wall_s=wall, walls_s=walls, mrays_per_s=rays / wall / 1e6,
                   first_call_s=first_s),
}
with open(os.path.join(OUT, "chip_smoke.json"), "w") as fh:
    config = dict(scene="bunny.json", size=SIZE, spp=SPP, max_bounces=MAX_BOUNCES, rr_start=RR)
    json.dump(dict(report, card=smi, config=config), fh, indent=1)
print()
print(smi)
print(json.dumps(report))
print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                         "count": torch.cuda.device_count()}}))
