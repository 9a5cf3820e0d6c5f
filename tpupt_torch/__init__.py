"""tpupt_torch — the tpupt path tracer ported to PyTorch and CUDA.

The JAX package ``tpupt`` is the reference; this package mirrors its
layout (core/, sampling/, scene/, accel/, render/) and names, imports
torch and numpy and never JAX.  The closest-hit treelet sweep runs as a
hand-written CUDA kernel on the card (accel/csrc/), and as a plain torch
twin on the CPU.

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
from tpupt_torch.render.integrator import render_image  # noqa: E402
from tpupt_torch.scene.description import SceneDescription  # noqa: E402
from tpupt_torch.scene.json_parser import scene_from_json  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Materials",
    "RenderBuffers",
    "SceneArrays",
    "SceneDescription",
    "render_image",
    "scene_from_json",
    "scene_from_numpy",
]
