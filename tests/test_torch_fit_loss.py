"""``render_loss`` of the PyTorch port's inverse rendering
(``tpupt_torch.diff.fit``) against the JAX package's
(``tpupt/diff/fit.py:26``): the loss and its gradients at the same
parameters (carried across by ``params_from_numpy``) and target, on
``sphere_scene`` and ``full_scene``, with the denoiser off and on.

The loss is held at test_torch_grads.py's IMAGE (rtol 1e-4, atol 1e-5:
last-bit differences of the two packages' float32 sqrt, rsqrt, sin, cos
and exp) and each leaf's gradient at rtol 1e-4 with a floor of 1e-4 x
max|g| of the leaf, its tolerances.  The JAX references run op by op
(compiling a gradient through the denoiser takes minutes), once per
module; they take ~40 s of this file's time, which is why the fits
themselves are tests/test_torch_fit.py's.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.core.camera import make_camera as jax_make_camera
from tpupt.denoise.atrous import atrous_denoise as jax_atrous_denoise
from tpupt.diff.params import extract_params as jax_extract_params
from tpupt.diff.params import with_params as jax_with_params
from tpupt.render.integrator import render_image as jax_render_image

from test_torch_scene import port_scene
from tpupt_torch.core.camera import make_camera
from tpupt_torch.diff.fit import render_loss
from tpupt_torch.diff.params import MATERIAL_LEAVES, PARAM_LEAVES, params_from_numpy

# the test tensors are small, so torch's intra-op thread pool only adds
# overhead (a ~1k-ray twin sweep: 6.5 s on 8 threads, 0.2 s on one)
torch.set_num_threads(1)

IMAGE = dict(rtol=1e-4, atol=1e-5)
LEAVES = PARAM_LEAVES + tuple(f"materials.{k}" for k in MATERIAL_LEAVES)
SCENES = ("sphere_scene", "full_scene")
LW = LH = 16  # 1 spp, 3 bounces
MB = 3


def _get(params, leaf):
    if leaf.startswith("materials."):
        return params["materials"][leaf.split(".", 1)[1]]
    return params[leaf]


def _jax_image_loss(color, normal, depth, target, denoise):
    """render_loss's loss of the render's buffers (tpupt/diff/fit.py)."""
    img = color
    if denoise:
        img = jax_atrous_denoise(color.reshape(LH, LW, 3), normal.reshape(LH, LW, 3),
                                 depth.reshape(LH, LW), jax_make_camera(vfov=np.pi / 2),
                                 filter_size=4).reshape(-1, 3)
    return jnp.mean((img - target) ** 2)


_JAX_LOSS = {d: jax.value_and_grad(partial(_jax_image_loss, denoise=d), (0, 1, 2))
             for d in (False, True)}


@pytest.fixture(scope="module")
def losses(request):
    """{(scene, denoise): (JAX loss, JAX grads, port loss, port grads)}
    from the same parameters and target.  The JAX side is render_loss
    (tpupt/diff/fit.py:26) taken apart: one linearized render per scene,
    each loss's gradient pulled back through it."""
    target = np.random.default_rng(0).uniform(0.0, 1.0, (LW * LH, 3)).astype(np.float32)
    out = {}
    for name in SCENES:
        jscene = request.getfixturevalue(name)
        pscene = port_scene(jscene)
        jp = jax_extract_params(jscene)
        np_params = jax.tree_util.tree_map(np.asarray, jp)

        def buffers(p, jscene=jscene):
            buf, _ = jax_render_image(jax_with_params(jscene, p), jax_make_camera(vfov=np.pi / 2),
                                      LW, LH, 1, max_bounces=MB, differentiable=True)
            return buf.color, buf.normal, buf.depth

        bufs, pull = jax.vjp(buffers, jp)
        for denoise in (False, True):
            jl, cot = _JAX_LOSS[denoise](*bufs, jnp.asarray(target))
            (jg,) = pull(cot)
            params = params_from_numpy(np_params, "cpu")
            loss = render_loss(params, pscene, make_camera(vfov=np.pi / 2), torch.from_numpy(target), LW, LH, 1, MB,
                               denoise, False)
            loss.backward()
            out[name, denoise] = (
                float(jl), {k: np.asarray(_get(jg, k)) for k in LEAVES},
                float(loss.detach()), {k: _get(params, k).grad for k in LEAVES},
            )
    return out


@pytest.mark.parametrize("denoise", [False, True])
@pytest.mark.parametrize("name", SCENES)
def test_render_loss_matches_jax(losses, name, denoise):
    jl, _, pl, _ = losses[name, denoise]
    np.testing.assert_allclose(pl, jl, **IMAGE)


@pytest.mark.parametrize("denoise", [False, True])
@pytest.mark.parametrize("name", SCENES)
def test_render_loss_grads_match_jax(losses, name, denoise):
    _, jg, _, pg = losses[name, denoise]
    for leaf in LEAVES:
        want = jg[leaf]
        got = np.zeros_like(want) if pg[leaf] is None else pg[leaf].numpy()
        assert np.isfinite(got).all(), leaf
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=leaf)
