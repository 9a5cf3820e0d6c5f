"""Next-event estimation (NEE) with multiple importance sampling (MIS) in
the PyTorch port against the JAX package (CPU: the port runs its torch
twins).

Scenes: ``tests/test_emissive.py``'s lamp (one unrolled sphere light),
sixteen lamps (one sampled light per lane), the quad light with a sphere
lamp beside it (the mixed-light regression), and the shipped
``cornell.json`` (sphere lights) and ``cornell_area.json`` (a 2-triangle
emissive quad), each built by both packages' own scene code.

Held:
  * traced-segment counts EQUAL, for the chained forward render with and
    without Russian roulette and for one differentiable ``trace_sample``;
  * their images at test_torch_render.py's IMAGE tolerance (rtol 1e-4,
    atol 1e-5: the two packages' float32 sqrt, rsqrt, sin and cos differ
    in the last bit), first-hit normals at atol 1e-4 (grazing hits on the
    0.15-radius lamps move a component near 0 by up to 9.2e-5);
  * the Cornell scenes twice.  With the JAX package's float32 sqrt,
    rsqrt, sin and cos bits patched into torch, every buffer at IMAGE
    (measured: equal to the last bit).  With torch's own functions, the
    ray counts equal and at least 97% of the colour values inside IMAGE
    (measured 97.6-99.4%): the walls are spheres of radius 1000, whose
    quadratic cancels |oc|^2 ~ 1e6 down to ~1, so a last-bit difference
    in a direction moves a wall hit visibly (gaps up to 1.6e-3), and
    pixel 498 (row 20, column 18, a path through the glass sphere) takes
    another discrete decision in one sample (gap 0.135).  The patched
    run is the witness that these gaps come from those four functions
    alone (ROADMAP section 3);
  * ``sample_light_sphere`` at rtol 1e-5, atol 1e-6 (its direction goes
    through rsqrt, its sin through a sqrt of 1 - cos^2);
  * the any-hit sweep's booleans EQUAL to ``intersect_treelets_anyhit``'s.

The JAX references run op by op (``jax.disable_jit()``): compiling the
sixteen-lamp render alone takes over a minute here.  The gradients are in
``test_torch_nee_grads.py``.
"""

import contextlib
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.accel.packets import intersect_treelets_anyhit as jax_anyhit
from tpupt.core.camera import make_camera as jax_make_camera
from tpupt.core.vec import Vec3 as JVec3
from tpupt.render import integrator as jax_integrator
from tpupt.render.materials import sample_light_sphere as jax_sample_light_sphere
from tpupt.scene.json_parser import scene_from_json as jax_scene_from_json

from test_emissive import _lamp_scene, _many_light_scene, _quad_light_scene
from test_lex_selection import _rays as lex_rays
from test_lex_selection import _scene as lex_scene
from test_torch_scene import port_scene
from tpupt_torch.accel import packets
from tpupt_torch.core.camera import make_camera
from tpupt_torch.core.vec import Vec3
from tpupt_torch.render import integrator
from tpupt_torch.render.materials import sample_light_sphere
from tpupt_torch.scene.assets_gen import ensure_models, locate_asset_path
from tpupt_torch.scene.json_parser import scene_from_json

# the test tensors are small, so torch's intra-op thread pool only adds
# overhead (a ~1k-ray twin sweep: 6.5 s on 8 threads, 0.2 s on one)
torch.set_num_threads(1)

IMAGE = dict(rtol=1e-4, atol=1e-5)
NORMAL = dict(rtol=1e-4, atol=1e-4)
CORNELL = ("cornell.json", "cornell_area.json")
W = H = 24


def _t(a):
    return torch.from_numpy(np.array(a))


@contextlib.contextmanager
def _xla_elementary():
    """torch.sqrt, rsqrt, sin and cos return the JAX package's float32 bits
    inside (CPU tensors outside autograd only)."""
    with pytest.MonkeyPatch.context() as m:
        for k, fn in dict(sqrt=jnp.sqrt, rsqrt=jax.lax.rsqrt, sin=jnp.sin, cos=jnp.cos).items():
            m.setattr(torch, k, lambda x, fn=fn: _t(fn(jnp.asarray(x.numpy()))))
        yield


# --- scenes ---------------------------------------------------------------

@pytest.fixture(scope="module")
def scenes_dir(tmp_path_factory):
    """The shipped Cornell JSONs beside a private models/ dir (other test
    files generate the shared assets/models concurrently)."""
    root = tmp_path_factory.mktemp("nee_assets")
    shutil.copytree(os.path.join(locate_asset_path(), "scenes"), root / "scenes")
    ensure_models(str(root / "models"), names=["quad.obj"])
    return str(root / "scenes")


def _json_pair(scenes_dir, name):
    path = os.path.join(scenes_dir, name)
    jdesc = jax_scene_from_json(path)
    pdesc = scene_from_json(path)
    return jdesc.build(), jdesc.camera, pdesc.build(device="cpu"), pdesc.camera


@pytest.fixture(scope="module")
def scenes(scenes_dir):
    """name -> (JAX scene, JAX camera, port scene, port camera)."""
    out = {}
    for name, build in (("lamp", _lamp_scene), ("many16", lambda: _many_light_scene(16)),
                        ("quad_mixed", lambda: _quad_light_scene(extra_sphere_lamp=True))):
        js = build()
        out[name] = (js, jax_make_camera(vfov=np.pi / 2), port_scene(js),
                     make_camera(vfov=np.pi / 2))
    for name in ("cornell.json", "cornell_area.json"):
        out[name] = _json_pair(scenes_dir, name)
    return out


def test_scenes_cover_every_emitter_kind(scenes):
    kinds = {name: (len(s[2].s_light_objs), s[2].s_tri_light_count) for name, s in scenes.items()}
    assert kinds == {"lamp": (1, 0), "many16": (16, 0), "quad_mixed": (1, 2),
                     "cornell.json": (1, 0), "cornell_area.json": (0, 2)}
    assert 16 > integrator.NEE_UNROLL_MAX == jax_integrator.NEE_UNROLL_MAX


# --- the forward render and trace_sample ---------------------------------

SCENES = ("lamp", "many16", "quad_mixed", "cornell.json", "cornell_area.json")


@pytest.mark.parametrize("rr_start", [None, 2], ids=["no_rr", "rr2"])
@pytest.mark.parametrize("name", SCENES)
def test_render_image_matches_jax(scenes, name, rr_start):
    jscene, jcam, pscene, pcam = scenes[name]
    kw = dict(spp=2, max_bounces=4, rr_start=rr_start)
    with jax.disable_jit():
        jbuf, jrays = jax_integrator.render_image(jscene, jcam, W, H, **kw)
    want = [np.asarray(getattr(jbuf, k)) for k in ("color", "normal", "depth")]
    for patched in (False, True) if name in CORNELL else (False,):
        with _xla_elementary() if patched else contextlib.nullcontext():
            pbuf, prays = integrator.render_image(pscene, pcam, W, H, **kw)
        assert int(prays) == int(jrays) > W * H
        got = [getattr(pbuf, k).numpy() for k in ("color", "normal", "depth")]
        _check_buffers(name, patched, got, want)
        assert pbuf.color.max() > 0.05  # the emitters light the scene


def _check_buffers(name, patched, got, want):
    """(color, normal, depth) at the tolerances of the module docstring;
    ``patched``: the port ran with the JAX package's elementary bits."""
    for key, g, w in zip(("color", "normal", "depth"), got, want):
        assert g.shape == w.shape and np.isfinite(g).all(), key
        if key == "color" and name in CORNELL and not patched:
            inside = np.abs(g - w) <= IMAGE["atol"] + IMAGE["rtol"] * np.abs(w)
            assert inside.mean() >= 0.97, inside.mean()
        elif key == "normal" and not patched:
            np.testing.assert_allclose(g, w, err_msg=key, **NORMAL)
        else:
            np.testing.assert_allclose(g, w, err_msg=key, **IMAGE)


@pytest.mark.parametrize("name", SCENES)
def test_trace_sample_matches_jax(scenes, name):
    """One differentiable sample (``differentiable=True``: refine_hit's
    hit record), with roulette."""
    jscene, jcam, pscene, pcam = scenes[name]
    with jax.disable_jit():
        jc, jn, jd, jr = jax_integrator.trace_sample(jscene, jcam, W, H, 1, max_bounces=4,
                                                     differentiable=True, rr_start=2)
    for patched in (False, True) if name in CORNELL else (False,):
        with torch.no_grad(), _xla_elementary() if patched else contextlib.nullcontext():
            pc, pn, pd, pr = integrator.trace_sample(pscene, pcam, W, H, 1, 4,
                                                       differentiable=True, rr_start=2)
        assert int(pr) == int(jr) > W * H
        _check_buffers(name, patched, [t.numpy() for t in (pc, pn, pd)],
                       [np.asarray(t) for t in (jc, jn, jd)])


# --- the twins -------------------------------------------------------------

def test_sample_light_sphere_matches_jax():
    r = np.random.default_rng(0)
    n = 4096
    c = r.uniform(-2, 2, (3, n)).astype(np.float32)
    p = r.uniform(-2, 2, (3, n)).astype(np.float32)
    rad = r.uniform(0.05, 1.5, n).astype(np.float32)
    u1, u2 = r.random((2, n)).astype(np.float32)
    jd, jpdf, jvalid = jax_sample_light_sphere(JVec3(*map(jnp.asarray, c)), jnp.asarray(rad),
                                               JVec3(*map(jnp.asarray, p)), jnp.asarray(u1),
                                               jnp.asarray(u2))
    pd, ppdf, pvalid = sample_light_sphere(Vec3(*map(_t, c)), _t(rad), Vec3(*map(_t, p)),
                                           _t(u1), _t(u2))
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))
    assert 0 < int(pvalid.sum()) < n
    for a, b in zip(jd, pd):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ppdf.numpy(), np.asarray(jpdf), rtol=1e-5)


def _anyhit_inputs(window, seed=5):
    """test_lex_selection's 1024 pixel-grid rays with a t window: "fixed"
    4.0 for every lane (that test's), or "random", per-lane ends from
    [0.5, 6] and a random active mask."""
    ro, rd, t_min, _, active = lex_rays()
    n = t_min.shape[0]
    if window == "fixed":
        t_limit = np.full(n, 4.0, np.float32)
        active = np.asarray(active)
    else:
        r = np.random.default_rng(seed)
        t_limit = r.uniform(0.5, 6.0, n).astype(np.float32)
        active = r.random(n) < 0.8
    return ro, rd, np.asarray(t_min), t_limit, active


@pytest.mark.parametrize("window", ["fixed", "random"])
@pytest.mark.parametrize("which", ["lex", "quad"])
def test_intersect_treelets_anyhit_matches_jax(which, window):
    """The lex scene has K >= 96 treelets (the two-level cull runs); the
    quad light is one treelet of two triangles, 4.03 or more from the
    camera, so the fixed window of 4.0 occludes nothing there."""
    jscene = lex_scene() if which == "lex" else _quad_light_scene()
    pscene = port_scene(jscene)
    assert (pscene.tre_min.shape[0] >= packets._TWOLEVEL_MIN_K) == (which == "lex")
    ro, rd, t_min, t_limit, active = _anyhit_inputs(window)
    with jax.disable_jit():
        want = np.asarray(jax_anyhit(jscene, ro, rd, jnp.asarray(t_min), jnp.asarray(t_limit),
                                     jnp.asarray(active)))
    got = packets.intersect_treelets_anyhit(
        pscene, Vec3(*(_t(c) for c in ro)), Vec3(*(_t(c) for c in rd)), _t(t_min), _t(t_limit),
        _t(active)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[~active].any()
    if which == "quad" and window == "fixed":
        assert not got.any()
    else:
        assert 0 < got.sum() < active.sum()
