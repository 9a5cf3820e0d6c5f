"""tpupt_torch — the tpupt path tracer ported to PyTorch and CUDA.

The JAX package ``tpupt`` is the reference; this package mirrors its
layout (core/, sampling/, scene/, accel/, render/, diff/, denoise/, utils/,
cli/, interactive/) and names, imports torch and numpy and never JAX.
``PathTracer`` is the progressive engine and ``python -m tpupt_torch.cli``
the headless renderer.  The closest-hit treelet sweep runs as a
hand-written CUDA kernel on the card (accel/csrc/), and as a plain torch
twin on the CPU.  ``render_image(differentiable=True)``
renders under autograd; ``extract_params``/``with_params`` name what a
gradient reaches and ``diff.fit_scene`` fits them to a target image.
``dist.sharding`` splits a render into row bands over a
``torch.distributed`` group; ``cpu_ref`` and ``render.intersect.
intersect_scene_ids_bvh`` are the reference hit passes.

TF32 is switched off for matmuls and cuDNN: a reduced-precision fetch of
triangle data flips hits (the JAX package needed full-precision one-hot
fetches for the same reason).  Importing the package sets both flags.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from tpupt_torch.core.types import (  # noqa: E402
    Camera,
    Materials,
    RenderBuffers,
    SceneArrays,
    scene_from_numpy,
)
from tpupt_torch.denoise.atrous import atrous_denoise  # noqa: E402
from tpupt_torch.diff.params import extract_params, params_from_numpy, with_params  # noqa: E402
from tpupt_torch.render.integrator import render_image, trace_sample  # noqa: E402
from tpupt_torch.render.progressive import PathTracer  # noqa: E402
from tpupt_torch.scene.description import SceneDescription  # noqa: E402
from tpupt_torch.scene.json_parser import scene_from_json  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Materials",
    "PathTracer",
    "RenderBuffers",
    "SceneArrays",
    "SceneDescription",
    "atrous_denoise",
    "extract_params",
    "params_from_numpy",
    "render_image",
    "scene_from_json",
    "scene_from_numpy",
    "trace_sample",
    "with_params",
]
