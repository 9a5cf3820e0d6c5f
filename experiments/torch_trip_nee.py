"""trip_nee of the shipped kernel library against the library built from
another checkout's sources, in turns, on one NVIDIA GPU.

    python experiments/torch_trip_nee.py --compare-root DIR[,DIR...] [--variants no_stage,...]
                                         [--reps 50] [--renders 2] [--no-sass]

``--compare-root`` names checkouts (e.g. a ``git archive`` of an earlier
tree under ``build/``), each labelled by its directory's name, whose
``tpupt_torch/accel/csrc`` is built with the library's own flags
(``torch_variant.py``); their ``tpupt_trip_nee`` has the same C interface,
so the shipped wrapper calls any of the libraries.
``--variants`` adds libraries built from the shipped sources with the
substitutions of ``VARIANTS`` (a design choice each: no staged table, no
queue of a warp's live lanes, neither, the warp's chunk, the launch
bounds) or
of ``DIAGNOSTIC`` (a part of the work dropped: timed, not compared).

The inputs are phase 10's of ``chip_smoke.py``: cornell.json (4 spp),
cornell_area.json (16 spp), sixteen lamps and the emissive icosphere
(``tests/test_torch_trip_nee.py``'s ``many16`` and ``ico_light``, 2 spp),
512^2, 4 bounces, roulette from bounce 2, on the trip route.  trip_nee's
inputs on trips 0, 2 and the last of each render are kept; on each every
library's trip_nee must equal the twin ``trip_nee_plain`` in every output,
and each is timed on the device (torch.profiler over ``--reps`` calls,
the lane state restored before each, the kernel's time summed) in turns:
shipped, others..., variants..., variants..., others..., shipped.  Each trip's
bytes and byte bound are counted as ``chip_smoke.nee_trip_work`` counts
them.  Then ``--renders`` cornell_area renders by each library in turns
(shipped, others..., others..., shipped), each under torch.profiler: trip_nee's
device ms summed over the render, its launches, and the render's busy
time (every kernel's device time).

Prints the card's name, power limit and SM clocks, each library's
registers and spill for trip_nee_kernel, and (unless ``--no-sass``) the
SASS instructions of the pieces a lane runs, from ``cuobjdump`` as
``torch_mt_sass.py`` counts them: probe kernels that call one piece
(the hit record with background, shade, the emitter's light pdf, the mesh
term, a sphere term unrolled or sampled, one sphere's shadow test) 2 and 4
times, whose difference over 2 is the piece's marginal count (rarely run
slow paths of division, sqrt and sin/cos that are inlined count too);
with the lanes of each case on each trip, the lane instructions a trip
issues and the time they take at one warp instruction a scheduler and
clock.  The last line of standard output is one JSON object; the same
goes to ``chiprun_out/torch_trip_nee.json``.
"""

import argparse
import concurrent.futures
import contextlib
import json
import os
import re
import subprocess
import sys

import torch

import torch_mt_sass
import torch_variant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from test_torch_trip_nee import HEAD_OUT, NEE_OUT, _port_scene  # noqa: E402
from tpupt_torch import render_image  # noqa: E402
from tpupt_torch.accel import kernels  # noqa: E402
from tpupt_torch.render import trip_kernel  # noqa: E402
from tpupt_torch.scene.assets_gen import ensure_models, locate_asset_path  # noqa: E402

SIZE, BOUNCES, RR = 512, 4, 2
SPP = {"cornell.json": 4, "cornell_area.json": 16, "many16": 2, "ico_light": 2}
KERNEL = "trip_nee_kernel"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM5 HBM3 peak memory rate

_BOUNDS = "__launch_bounds__(kGridThreads, 2) trip_nee_kernel"
_LANES = "constexpr int kWarpLanes = 64;"
_STAGE = ("constexpr int kStageMax = 8192;", "constexpr int kStageMax = 0;")
_QUEUE = (
    "    for (int j = lane; j < n_live; j += 32) nee_lane<kStaged>(a, lane0 + queue[j]);",
    "    for (int k = 0; k < kLanePer; ++k) {\n"
    "      const int i = lane0 + lane + 32 * k;\n"
    "      if (i < a.n && alive[i] != 0) nee_lane<kStaged>(a, i);\n    }")
VARIANTS = {
    # the scene table read from device memory, not staged
    "no_stage": [_STAGE],
    # no queue: each thread runs the live lanes among lanes lane, lane + 32
    # of its warp's chunk in place
    "no_queue": [_QUEUE],
    # the persistent grid alone: neither the staged table nor the queue
    "grid_alone": [_STAGE, _QUEUE],
    "lanes32": [(_LANES, _LANES.replace("64", "32"))],
    "lanes128": [(_LANES, _LANES.replace("64", "128"))],
    "lb1": [(_BOUNDS, _BOUNDS.replace("(kGridThreads, 2)", "(kGridThreads, 1)"))],
    "lb3": [(_BOUNDS, _BOUNDS.replace("(kGridThreads, 2)", "(kGridThreads, 3)"))],
    "lb_default": [(_BOUNDS, _BOUNDS.replace("(kGridThreads, 2)", "(kGridThreads)"))],
}
# where the time goes: no NEE term is sampled (the hit, shading, emission only)
DIAGNOSTIC = {"no_terms": [(
    "    nee_term<kStaged>(a, t, i, p, h.normal, thr_alb, seed, bounce);\n", "")]}

# the SASS probes: each calls one piece N times on inputs it cannot fold
PROBE = r"""
#include "trip_kernels.cu"

namespace {
__device__ __forceinline__ V3 in3(const float* p, int j) { return v3(p[j], p[j + 1], p[j + 2]); }

template <int N>
__global__ void probe_record(const NeeArgs a, float* out) {
  const int i = threadIdx.x;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const V3 ro = in3(a.tab, 3 * j + i), rd = in3(a.tab, 3 * j + i + 64);
    const HitRec h = hit_record(a.rec, a.tab, a.obj_off, a.n, i + 32 * j, ro, rd);
    const V3 bg = background(a.tab + a.bg_off + j, rd);
    acc += h.t + h.point.x + h.normal.y + (float)h.mat + bg.x + bg.z;
  }
  out[i] = acc;
}

template <int N>
__global__ void probe_shade(const NeeArgs a, float* out) {
  const int i = threadIdx.x;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    HitRec h;
    h.mask = true;
    h.front = a.F[i + j] > 0.0f;
    h.kind = kPrimSphere;
    h.obj = 0;
    h.mat = a.I[i + j];
    h.t = a.F[i + 64 + j];
    h.point = in3(a.F, 128 + i + j);
    h.normal = in3(a.F, 192 + i + j);
    const Scatter sc = shade(a.tab, a.mat_off, h, in3(a.F, 256 + i + j), a.F[320 + i + j],
                             (uint32_t)a.I[64 + i + j], a.I[128 + i + j]);
    acc += sc.ro.x + sc.rd.y + sc.mult.z + sc.emitted.x + sc.albedo.y + sc.t_min + sc.pdf_w +
           (float)sc.mtype + (sc.is_emis ? 1.0f : 0.0f) + (sc.specular ? 2.0f : 0.0f);
  }
  out[i] = acc;
}

template <int N>
__global__ void probe_light_pdf(const NeeArgs a, float* out) {
  const int i = threadIdx.x;
  const Lights L = lights_of(a.tab, a.tab + 4096, a.nee_off, a.n_lights, a.n_tri);
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    HitRec h;
    h.kind = a.I[i + j];
    h.obj = a.I[i + 64 + j];
    h.t = a.F[i + j];
    h.normal = in3(a.F, 64 + i + j);
    acc += light_pdf_at_hit(L, h, in3(a.F, 128 + i + j), in3(a.F, 192 + i + j));
  }
  out[i] = acc;
}

template <int N, int kKind>  // 0: the mesh term, 1: a sphere light unrolled, 2: sampled
__global__ void probe_term(const NeeArgs a, float* out) {
  const int i = threadIdx.x;
  const Lights L = lights_of(a.tab, a.tab + 4096, a.nee_off, a.n_lights, a.n_tri);
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const V3 p = in3(a.F, i + j), n = in3(a.F, 64 + i + j), ta = in3(a.F, 128 + i + j);
    const uint32_t seed = (uint32_t)a.I[i + j];
    const int bounce = a.I[64 + i + j];
    const Term t = kKind == 0 ? mesh_term(a.tab, a.mat_off, L, p, n, ta, seed, bounce)
                              : sphere_term(L, a.I[128 + i + j], kKind == 2, p, n, ta, seed,
                                            bounce);
    acc += t.dir.x + t.contrib.y + t.t_limit + (t.active ? 1.0f : 0.0f) + (float)t.light;
  }
  out[i] = acc;
}

template <int N>
__global__ void probe_sphere(const NeeArgs a, float* out) {
  const int i = threadIdx.x;
  int hits = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    hits += sphere_blocks(a.tab + (i + j) * kSphereRow, in3(a.F, i + j), in3(a.F, 64 + i + j),
                          a.F[128 + i + j]) ? 1 : 0;
  }
  out[i] = (float)hits;
}

}  // namespace

// every probe referenced, so that each is compiled
extern "C" {
void* trip_nee_probes[] = {
    (void*)probe_record<2>, (void*)probe_record<4>, (void*)probe_shade<2>,
    (void*)probe_shade<4>, (void*)probe_light_pdf<2>, (void*)probe_light_pdf<4>,
    (void*)probe_term<2, 0>, (void*)probe_term<4, 0>, (void*)probe_term<2, 1>,
    (void*)probe_term<4, 1>, (void*)probe_term<2, 2>, (void*)probe_term<4, 2>,
    (void*)probe_sphere<2>, (void*)probe_sphere<4>};
}
"""
PIECES = {"record": "probe_record", "shade": "probe_shade", "light_pdf": "probe_light_pdf",
          "mesh_term": "probe_termILi{}ELi0E", "light_term": "probe_termILi{}ELi1E",
          "sampled_term": "probe_termILi{}ELi2E", "sphere_test": "probe_sphere"}


@contextlib.contextmanager
def using(lib):
    """Every kernel wrapper launches from ``lib`` inside the block."""
    load = kernels.load
    kernels.load = lambda: lib
    try:
        yield
    finally:
        kernels.load = load


def register_report(log_path):
    """ptxas's lines for trip_nee_kernel in a library's build log."""
    out, keep = [], False
    with open(log_path) as fh:
        for ln in fh:
            if "Compiling entry function" in ln:
                keep = KERNEL in ln
            if keep and ("registers" in ln or "spill" in ln or "stack frame" in ln):
                out.append(re.sub(r"\s+", " ", ln.strip()))
    return out


def device_ms(fn, restore, reps):
    """Mean device milliseconds of trip_nee_kernel per call of ``fn``: the
    profiler's sum over ``reps`` calls, ``restore`` (other kernels, not
    summed) before each; None where it records no device time."""
    restore()
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            restore()
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages() if KERNEL in e.key)
    return total / 1e3 / reps if total > 0 else None


def record_trips(scene, cam, spp):
    """The render's trips, and trip_nee's inputs on trips 0, 2 and the last
    (the lane state and buffers as it found them, the sweep's outputs)."""
    keep, kept, count, nee = set(), {}, [0], trip_kernel.trip_nee

    def rec(plan, F, I, buf, sweep=None):
        if count[0] in keep:
            kept[count[0]] = dict(
                plan=plan, F=F.clone(), I=I.clone(),
                buf={k: getattr(buf, k).clone() for k in HEAD_OUT + NEE_OUT
                     if getattr(buf, k) is not None},
                sweep=None if sweep is None else tuple(o.clone() for o in sweep))
        count[0] += 1
        return nee(plan, F, I, buf, sweep)

    trip_kernel.trip_nee = rec
    try:
        render_image(scene, cam, SIZE, SIZE, spp=spp, max_bounces=BOUNCES, rr_start=RR)
        trips, count[0] = count[0], 0
        keep.update({0, 2, trips - 1})
        render_image(scene, cam, SIZE, SIZE, spp=spp, max_bounces=BOUNCES, rr_start=RR)
    finally:
        trip_kernel.trip_nee = nee
    assert count[0] == trips, (count[0], trips)
    return trips, kept


def run(r, fn=None):
    """trip_nee (``fn``, by default the wrapper of the library in use) on a
    kept trip's inputs: (F, I, buffers)."""
    plan = r["plan"]
    buf = trip_kernel.trip_buffers(plan)
    for k, v in r["buf"].items():
        getattr(buf, k).copy_(v)
    F, I = r["F"].clone(), r["I"].clone()
    (fn or trip_kernel.trip_nee)(plan, F, I, buf, r["sweep"])
    return F, I, buf


def same(a, b):
    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and all(torch.equal(getattr(a[2], k), getattr(b[2], k)) for k in NEE_OUT
                    if getattr(a[2], k) is not None))


def work(r, out):
    """The trip's lanes by case, and its bytes as chip_smoke.nee_trip_work
    counts them (each input read once, each output written once)."""
    plan, I0 = r["plan"], r["I"]
    keys = trip_kernel.I_KEYS
    n, n_pad, terms, mesh = plan.n, plan.n_pad, len(plan.nee_kinds), plan.mesh
    alive = I0[keys.index("alive")] != 0
    on_mesh = (r["sweep"][1].reshape(-1)[:n] >= 0) & alive if mesh else torch.zeros_like(alive)
    hit = (r["buf"]["hint"] >= 0) & alive | on_mesh
    first = hit & (I0[keys.index("bounce")] == 0)
    alive_next = out[2].alive_next
    emissive = hit & ~alive_next
    specular = hit & alive_next & (out[1][keys.index("spec")] != 0)
    diffuse = hit & alive_next & (out[1][keys.index("spec")] == 0)
    live = int(alive.sum())
    opens = int(out[2].nee_mask.sum())
    nbytes = (n * 4 + live * (8 + 48 + 32 + 12 + 1 + (4 if mesh else 0))
              + int(on_mesh.sum()) * 20 + int(hit.sum()) * 52 + int(first.sum()) * 16
              + int(emissive.sum()) * 8 + terms * n_pad * (1 + (4 if mesh else 0))
              + opens * (12 + (28 if mesh else 0))
              + (terms * (n_pad - n) * 28 if mesh else 0) + plan.tables.table.numel() * 4)
    return dict(lanes=n, live=live, miss=live - int(hit.sum()), emitter=int(emissive.sum()),
                specular=int(specular.sum()), diffuse=int(diffuse.sum()), terms=terms,
                n_sph=plan.tables.n_sph, open_terms=opens, bytes=nbytes,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)


def sass_pieces():
    """Each piece's marginal SASS instructions ((count(4) - count(2)) / 2),
    by opcode class, and ptxas's report of the probes."""
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    src = os.path.join(kernels.BUILD_DIR, "trip_nee_probe.cu")
    with open(src, "w") as fh:
        fh.write(PROBE)
    cubin = os.path.join(kernels.BUILD_DIR, "trip_nee_probe.cubin")
    torch_mt_sass.compile_cubin(src, cubin, kernels._CSRC)
    funcs = torch_mt_sass.sass_by_function(cubin)

    def count(tag, n):
        name = tag.format(n) if "{}" in tag else f"{tag}ILi{n}E"
        hits = [f for f in funcs if name in f]
        assert len(hits) == 1, (name, hits)
        return funcs[hits[0]]

    out = {}
    for piece, tag in PIECES.items():
        c2, c4 = count(tag, 2), count(tag, 4)
        marginal = {op: (c4[op] - c2[op]) / 2 for op in set(c2) | set(c4) if c4[op] != c2[op]}
        by_class = {}
        for op, v in marginal.items():
            k = torch_mt_sass.classify(op)
            by_class[k] = by_class.get(k, 0) + v
        out[piece] = dict(instructions=sum(marginal.values()), by_class=by_class)
    return out


def lane_instructions(w, pieces):
    """Lane instructions a trip issues at most, from the pieces' counts: a
    miss runs the record; a hit also shade, an emitter the light pdf; a
    diffuse lane each term and its shadow ray's test of every sphere."""
    p = {k: v["instructions"] for k, v in pieces.items()}
    hits = w["emitter"] + w["specular"] + w["diffuse"]
    term = p["mesh_term"] if w["kind"] == "mesh" else p[
        "sampled_term" if w["kind"] == "sampled" else "light_term"]
    return (w["live"] * p["record"] + hits * p["shade"] + w["emitter"] * p["light_pdf"]
            + w["diffuse"] * w["terms"] * (term + w["n_sph"] * p["sphere_test"]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--compare-root", required=True)
    ap.add_argument("--variants", default="")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--renders", type=int, default=2)
    ap.add_argument("--no-sass", action="store_true")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"card (name, power limit, SM clock, max SM clock): {smi}", flush=True)
    max_mhz = float(smi.split(",")[-1].split()[0])
    roots = {os.path.basename(os.path.normpath(r)): os.path.join(
        os.path.abspath(r), "tpupt_torch", "accel", "csrc") for r in args.compare_root.split(",")}
    builds = {"shipped": ([], None), **{name: ([], csrc) for name, csrc in roots.items()}}
    for v in filter(None, args.variants.split(",")):
        builds[v] = ({**VARIANTS, **DIAGNOSTIC}[v], None)
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        futs = {name: pool.submit(torch_variant.build, kernels, subs, csrc=csrc)
                for name, (subs, csrc) in builds.items()}
        paths = {name: f.result() for name, f in futs.items()}
    libs = {name: kernels.bind(p) for name, p in paths.items()}
    registers = {name: register_report(p + ".log") for name, p in paths.items()}
    for name, lines in registers.items():
        print(f"{name}: " + "; ".join(lines), flush=True)

    ensure_models(names=["quad.obj"])
    scenes_dir = os.path.join(locate_asset_path(), "scenes")
    order = list(libs) + list(libs)[::-1]
    report = dict(card=smi, registers=registers, trips={}, renders={})
    for name, spp in SPP.items():
        scene, cam = _port_scene(name, scenes_dir, device="cuda")
        trips, kept = record_trips(scene, cam, spp)
        for t, r in sorted(kept.items()):
            label = f"{name.removesuffix('.json')}_trip{t}"
            twin = run(r, trip_kernel.trip_nee_plain)
            outs = {}
            for lib_name, lib in libs.items():
                with using(lib):
                    outs[lib_name] = run(r)
            torch.cuda.synchronize()
            for lib_name, out in outs.items():
                if lib_name not in DIAGNOSTIC:
                    assert same(out, twin), f"{label}: {lib_name}'s trip_nee differs from the twin"
            w = work(r, twin)
            w["kind"] = r["plan"].nee_kinds[-1]
            ms = {lib_name: [] for lib_name in libs}
            plan = r["plan"]
            buf = trip_kernel.trip_buffers(plan)
            for k, v in r["buf"].items():
                getattr(buf, k).copy_(v)
            F, I = r["F"].clone(), r["I"].clone()

            def restore():
                F.copy_(r["F"])
                I.copy_(r["I"])

            for lib_name in order:
                with using(libs[lib_name]):
                    ms[lib_name].append(device_ms(
                        lambda: trip_kernel.trip_nee(plan, F, I, buf, r["sweep"]), restore,
                        args.reps))
            report["trips"][label] = dict(work=w, device_ms=ms, trips=trips)
            print(f"{label} ({w['live']} live: {w['miss']} miss, {w['emitter']} emitter, "
                  f"{w['specular']} specular, {w['diffuse']} diffuse; {w['terms']} term(s), "
                  f"{w['n_sph']} spheres; {w['bytes'] / 1e6:.1f} MB, bound "
                  f"{w['bound_ms']:.4f} ms): "
                  + ", ".join(f"{k} " + "/".join("n/a" if x is None else f"{x:.4f}" for x in v)
                              for k, v in ms.items()), flush=True)
        del kept
    if not args.no_sass:
        pieces = report["sass_pieces"] = sass_pieces()
        print("SASS instructions a piece: " + ", ".join(
            f"{k} {v['instructions']:g}" for k, v in pieces.items()), flush=True)
        for label, entry in report["trips"].items():
            li = entry["lane_instructions"] = lane_instructions(entry["work"], pieces)
            entry["issue_ms"] = li / (132 * 4 * 32 * max_mhz * 1e6) * 1e3
            print(f"{label}: at most {li / 1e6:.1f} M lane instructions = "
                  f"{entry['issue_ms']:.4f} ms of issue at {max_mhz:g} MHz", flush=True)

    # whole cornell_area renders by the shipped and the other libraries in turns
    scene, cam = _port_scene("cornell_area.json", scenes_dir, device="cuda")
    for lib_name in (["shipped", *roots, *list(roots)[::-1], "shipped"] * args.renders):
        with using(libs[lib_name]):
            render_image(scene, cam, SIZE, SIZE, spp=16, max_bounces=BOUNCES, rr_start=RR)
            torch.cuda.synchronize()
            n0 = trip_kernel.LAUNCHES["trip_nee"]
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                render_image(scene, cam, SIZE, SIZE, spp=16, max_bounces=BOUNCES, rr_start=RR)
                torch.cuda.synchronize()
        kav = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        rec = report["renders"].setdefault(lib_name, [])
        rec.append(dict(trip_nee_ms=sum(e.self_device_time_total for e in kav
                                        if KERNEL in e.key) / 1e3,
                        busy_ms=sum(e.self_device_time_total for e in kav) / 1e3,
                        launches=trip_kernel.LAUNCHES["trip_nee"] - n0))
        print(f"cornell_area render, {lib_name}: {rec[-1]}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "torch_trip_nee.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
