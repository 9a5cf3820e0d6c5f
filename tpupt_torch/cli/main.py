"""Headless CLI renderer (counterpart of ``tpupt/cli/main.py``).

    python -m tpupt_torch.cli bunny.json -o out.png [--spp N] [--denoise]
        [--method streaming] [--device cpu] ...

A positional scene file, -o/--output, a --spp override, a per-stage
stopwatch report and a PNG.  The JAX package's extensions (--denoise,
--max-bounces, --method, --rr, --resolution, --chunk, --stats-json,
--profile, --checkpoint, --honor-background) keep their names and
meanings; --device picks the card (the default, "cuda") or the CPU.
Without a card the CLI exits with a message unless --device cpu is given:
it never renders on the CPU unasked.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpupt-torch",
        description="differentiable path tracer on a CUDA GPU (headless render)",
    )
    p.add_argument("filename", help="scene .json file (path or name under assets/scenes)")
    p.add_argument("-o", "--output", required=True, help="output PNG path")
    p.add_argument("--spp", type=int, default=None, help="override scene samples-per-pixel")
    p.add_argument("--max-bounces", type=int, default=50, help="max path length (reference: 50)")
    p.add_argument("--resolution", type=str, default=None, help="WxH override, e.g. 1024x1024")
    p.add_argument("--denoise", action="store_true", help="apply the a-trous denoiser")
    p.add_argument("--rr", type=int, default=None, metavar="BOUNCE",
                   help="enable russian roulette from this bounce (extension)")
    p.add_argument("--method", default="megakernel",
                   choices=["megakernel", "streaming"],
                   help="integrator (reference GPUMethod: megakernel | streaming)")
    p.add_argument("--display", default="final",
                   choices=["final", "color", "normal", "depth"],
                   help="which buffer to write (reference DisplayBufferType)")
    p.add_argument("--chunk", type=int, default=32, metavar="SPP",
                   help="samples per call of the chained renderer; also the "
                        "checkpoint/progress granularity (default 32)")
    p.add_argument("--stats-json", default=None, help="write stage timing/throughput JSON here")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the path-tracing stage here, "
                        "with the program's tpupt.* spans")
    p.add_argument("--checkpoint", default=None, metavar="NPZ",
                   help="save accumulation state here; resumes from it if present")
    p.add_argument("--honor-background", action="store_true",
                   help="honor the scene 'background' key (the reference ignores it)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="render on the CUDA card (default) or, when asked, the CPU")
    return p


def resolve_scene_path(filename: str) -> str:
    """The reference's read_scene: resolve under the asset dir, require
    .json."""
    from tpupt_torch.scene.assets_gen import locate_asset_path

    if not filename.endswith(".json"):
        raise SystemExit(f"Only support scenes in json format (got {filename!r})")
    if os.path.exists(filename):
        return filename
    cand = os.path.join(locate_asset_path(), "scenes", filename)
    if os.path.exists(cand):
        return cand
    raise SystemExit(f"Cannot find scene file {filename!r}")


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    from tpupt_torch.utils.timer import Stopwatch

    sw = Stopwatch()
    sw.stage("Scene loading")

    from tpupt_torch.scene.assets_gen import ensure_models
    from tpupt_torch.scene.json_parser import scene_from_json

    ensure_models()
    scene_path = resolve_scene_path(args.filename)
    desc = scene_from_json(scene_path, honor_background=args.honor_background)
    if args.spp is not None:
        desc.spp = args.spp
    if args.resolution:
        w, h = args.resolution.lower().split("x")
        desc.resolution = (int(w), int(h))
    width, height = desc.resolution

    # The device is its own stage: the first contact with the card and the
    # one-time build of the kernel library (nvcc, at first use) must not
    # land in the first chunk's time.
    sw.stage("Device init")
    import torch

    cuda = args.device == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise SystemExit("tpupt-torch: no CUDA device is available; "
                             "pass --device cpu to render on the CPU")
        from tpupt_torch.accel import kernels

        kernels.load()
        print(f"device: {torch.cuda.get_device_name(0)} (kernels: {kernels.library_path()})")
    else:
        print("device: cpu (the kernels' torch twins)")
    print(f"Scene: {scene_path}")
    print(f"Resolution: {width}x{height}  spp: {desc.spp}  max bounces: {args.max_bounces}")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sw.stage("Initialization")
    from tpupt_torch.render.progressive import PathTracer
    from tpupt_torch.utils import trace

    scene = desc.build(device=args.device)
    tracer = PathTracer(scene, (width, height),
                        max_bounces=args.max_bounces, rr_start=args.rr,
                        method=args.method)

    if args.checkpoint and os.path.exists(args.checkpoint):
        tracer.load_checkpoint(args.checkpoint)
        print(f"Resumed from {args.checkpoint} at iteration {tracer.iteration}")

    sw.stage("Path tracing")
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profile_ctx = torch.profiler.profile(activities=acts)
    else:
        profile_ctx = contextlib.nullcontext()
    # Render in chunks of spp through the chained renderer, one call per
    # chunk.  A chunk is also the checkpoint granularity.  Per-chunk timing
    # keeps the first chunk, which pays one-time costs (CUDA context and
    # allocator warm-up), apart from the steady rate.
    chunk = max(1, args.chunk)
    if cuda:
        launches_before = trace.launch_counts()
    total_rays = 0
    chunk_stats = []  # (seconds, ray segments) per chunk
    t0 = time.perf_counter()
    with profile_ctx as prof:
        while tracer.iteration < desc.spp:
            n = min(chunk, desc.spp - tracer.iteration)
            tc = time.perf_counter()
            r = tracer.path_trace_many(desc.camera, n)
            sync()
            chunk_stats.append((time.perf_counter() - tc, r))
            total_rays += r
            if args.checkpoint and tracer.iteration < desc.spp:
                tracer.save_checkpoint(args.checkpoint)
    trace_secs = time.perf_counter() - t0
    launched = ({k: n - launches_before[k] for k, n in trace.launch_counts().items()} if cuda
                else None)
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "path_tracing_trace.json"))

    if len(chunk_stats) >= 2:
        steady_secs = sum(t for t, _ in chunk_stats[1:])
        steady_rays = sum(r for _, r in chunk_stats[1:])
    else:
        steady_secs, steady_rays = trace_secs, total_rays
    steady_mrays = steady_rays / max(steady_secs, 1e-9) / 1e6

    if args.checkpoint:
        tracer.save_checkpoint(args.checkpoint)

    if args.denoise:
        sw.stage("Denoising")
        tracer.denoise(desc.camera)
        sync()

    sw.stage("Image writing")
    from tpupt_torch.utils.image import write_image_file

    img = tracer.display(args.display)
    write_image_file(args.output, img)

    sw.end_stage()
    print(sw.report())
    mrays = total_rays / max(trace_secs, 1e-9) / 1e6
    print(f"Traced {total_rays} ray segments in {trace_secs:.3f}s = {mrays:.2f} Mrays/s")
    if launched is not None:
        print(f"Kernel launches while path tracing: {json.dumps(launched)}")
    if len(chunk_stats) >= 2:
        print(
            f"Steady-state: {steady_mrays:.2f} Mrays/s over "
            f"{len(chunk_stats) - 1} chunks (the first chunk took "
            f"{chunk_stats[0][0]:.1f}s)"
        )

    if args.stats_json:
        with open(args.stats_json, "w") as fh:
            json.dump(
                {
                    "scene": scene_path,
                    "resolution": [width, height],
                    "spp": desc.spp,
                    "rays": total_rays,
                    "path_tracing_secs": trace_secs,
                    "mrays_per_sec": mrays,
                    # without the first chunk; equals mrays_per_sec when
                    # only one chunk ran
                    "mrays_per_sec_steady": steady_mrays,
                    "first_dispatch_secs": chunk_stats[0][0] if chunk_stats else 0.0,
                    "stages": dict(sw.stages),
                },
                fh,
                indent=2,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
