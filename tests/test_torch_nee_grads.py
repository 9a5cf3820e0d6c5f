"""Gradients of the PyTorch port's NEE render against the JAX package's
(CPU: the port runs its torch twins).

Setting: ``tests/test_emissive.py``'s quad light with a sphere lamp beside
it (an emissive mesh and an unrolled sphere light) and its eight lamps
(one sampled light per lane), 24^2, 1 spp, 4 bounces, loss sum(color^2),
gradients to every ``extract_params`` leaf.  Ray counts EQUAL, the loss
at test_torch_render.py's IMAGE tolerance, each leaf's gradient at rtol
1e-4 with a floor of 1e-4 x max|g| of the leaf (test_torch_grads.py's),
and the emission's gradient nonzero.

The JAX package's NEE gradients of the geometry leaves are NaN (ROADMAP
section 3): its MIS weight pb / max(pb + pl, 1e-20) is selected away on
specular lanes, but the quotient's backward there divides 0 by the
square of 1e-20, which XLA's CPU backend flushes to 0; and its
emissive-triangle pdf squares t = 3e38 on lanes that hit nothing, whose
cotangent then multiplies 0 by inf.  The port computes both with those
lanes' operands replaced (the same values on every lane that is kept).
The gradient reference is the JAX render with the same two replacements
patched into its module for the test; the unpatched reference's loss and
finite leaves are held equal to the patched one's on the eight lamps.

The quad scene's reference is compiled (op by op its mesh sweeps take
longer); the eight lamps' runs op by op (compiling it takes longer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.core.camera import make_camera as jax_make_camera
from tpupt.diff.params import extract_params as jax_extract_params
from tpupt.diff.params import with_params as jax_with_params
from tpupt.render import integrator as jax_integrator

from test_emissive import _many_light_scene, _quad_light_scene
from test_torch_grads import LEAVES, _get
from test_torch_scene import port_scene
from tpupt_torch import params_from_numpy, with_params
from tpupt_torch.core.camera import make_camera
from tpupt_torch.render import integrator

# the test tensors are small, so torch's intra-op thread pool only adds
# overhead (a ~1k-ray twin sweep: 6.5 s on 8 threads, 0.2 s on one)
torch.set_num_threads(1)

IMAGE = dict(rtol=1e-4, atol=1e-5)
W = H = 24


def _guarded_weighted_emission(scene, radiance, state, ids, hit, emitted, absorb, hit_alive,
                               has_nee):
    """tpupt's _weighted_emission with the denominator 1 on specular lanes."""
    from tpupt.core import vec as jvec

    if not has_nee:
        return jvec.where(hit_alive, radiance + state["color"] * emitted, radiance)
    pl = jax_integrator._light_pdf_at_hit(scene, ids.obj_id, ids.kind, hit, state["ro"],
                                          state["rd"], absorb)
    pb, spec = state["pdf_w"], state["spec"]
    w = jnp.where(spec, 1.0, pb / jnp.where(spec, 1.0, jnp.maximum(pb + pl, 1e-20)))
    return jvec.where(hit_alive & absorb, radiance + state["color"] * emitted * w, radiance)


def _guarded_pdf(orig):
    def pdf(scene, obj_id, kind, hit, ro, rd, absorb):
        """tpupt's _light_pdf_at_hit with t zeroed where nothing was hit."""
        return orig(scene, obj_id, kind, hit.replace(t=jnp.where(hit.mask, hit.t, 0.0)), ro, rd,
                    absorb)
    return pdf


def _jax_loss_and_grads(jscene, jcam, op_by_op):
    def loss_fn(p):
        buf, rays = jax_integrator.render_image(jax_with_params(jscene, p), jcam, W, H, 1,
                                                max_bounces=4, differentiable=True)
        return jnp.sum(buf.color ** 2), rays

    with jax.disable_jit(op_by_op):
        (loss, rays), g = jax.value_and_grad(loss_fn, has_aux=True)(jax_extract_params(jscene))
        return float(loss), int(rays), {k: np.asarray(_get(g, k)) for k in LEAVES}


GRAD_SCENES = ("quad_mixed", "many8")


def _guarded(jscene, jcam, op_by_op):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_integrator, "_weighted_emission", _guarded_weighted_emission)
        mp.setattr(jax_integrator, "_light_pdf_at_hit",
                   _guarded_pdf(jax_integrator._light_pdf_at_hit))
        return _jax_loss_and_grads(jscene, jcam, op_by_op)


@pytest.fixture(scope="module")
def grads():
    """Per scene: the guarded JAX loss, ray count and gradients and the
    port's, from the same parameters; for the eight lamps also the
    unguarded reference's."""
    out = {}
    for name in GRAD_SCENES:
        jscene = _quad_light_scene(extra_sphere_lamp=True) if name == "quad_mixed" else \
            _many_light_scene(8)
        jcam = jax_make_camera(vfov=np.pi / 2)
        op_by_op = name == "many8"
        out[name] = dict(guarded=_guarded(jscene, jcam, op_by_op))
        if name == "many8":
            out[name]["raw"] = _jax_loss_and_grads(jscene, jcam, op_by_op)
        params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_extract_params(jscene)),
                                   "cpu")
        buf, rays = integrator.render_image(with_params(port_scene(jscene), params),
                                            make_camera(vfov=np.pi / 2), W, H, 1, max_bounces=4,
                                            differentiable=True)
        loss = (buf.color ** 2).sum()
        leaves = [_get(params, k) for k in LEAVES]
        g = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        out[name]["port"] = (float(loss.detach()), int(rays),
                             {k: v.numpy() for k, v in zip(LEAVES, g)})
    return out


def test_guards_change_only_the_nans(grads):
    (rl, rr, rg), (gl, gr, gg) = grads["many8"]["raw"], grads["many8"]["guarded"]
    assert (rl, rr) == (gl, gr)
    nan_leaves = [k for k in LEAVES if not np.isfinite(rg[k]).all()]
    assert "sphere_center" in nan_leaves  # the reference's NaN (ROADMAP section 3)
    for k in LEAVES:
        assert np.isfinite(gg[k]).all(), k
        if k not in nan_leaves:
            np.testing.assert_array_equal(gg[k], rg[k], err_msg=k)


@pytest.mark.parametrize("name", GRAD_SCENES)
def test_loss_and_ray_count_match_jax(grads, name):
    (jl, jr, _), (pl, pr, _) = grads[name]["guarded"], grads[name]["port"]
    assert pr == jr > W * H
    np.testing.assert_allclose(pl, jl, **IMAGE)


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("name", GRAD_SCENES)
def test_leaf_gradient_matches_jax(grads, name, leaf):
    want, got = grads[name]["guarded"][2][leaf], grads[name]["port"][2][leaf]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))
    if leaf == "materials.emission":
        assert np.abs(got).max() > 0
