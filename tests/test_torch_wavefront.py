"""The port's wavefront ("streaming") integrator
(``tpupt_torch.render.wavefront``) against its own megakernel
``trace_sample`` and against the JAX package's ``trace_sample_wavefront``
(CPU: the port runs its torch twins).

Held:
  * the wavefront EQUAL to the port's forward ``trace_sample`` bit for bit,
    ray counts included (compaction only reorders lanes and every lane's
    RNG is keyed on its pixel);
  * the port's wavefront against the JAX package's: ray counts EQUAL,
    buffers at rtol 1e-4, atol 1e-5 (``test_torch_render.py``'s IMAGE: the
    packages' float32 sqrt, rsqrt, sin and cos differ in the last bit);
  * ``_partition_perm`` EQUAL to the JAX package's, live count included.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.core.camera import make_camera as jax_make_camera
from tpupt.render.integrator import _partition_perm as jax_partition_perm
from tpupt.render.wavefront import trace_sample_wavefront as jax_wavefront

from test_emissive import _quad_light_scene
from test_torch_scene import port_scene
from tpupt_torch.accel import sweep_kernel
from tpupt_torch.core.camera import make_camera
from tpupt_torch.render import intersect
from tpupt_torch.render.integrator import _partition_perm, trace_sample
from tpupt_torch.render.wavefront import trace_sample_wavefront

torch.set_num_threads(1)

IMAGE = dict(rtol=1e-4, atol=1e-5)
W = H = 32
# (fixture, or None for the quad-light scene; iteration; trace_sample keywords)
CASES = {
    "full_scene": ("full_scene", 2, dict(max_bounces=6)),
    "sphere_rr": ("sphere_scene", 0, dict(max_bounces=8, rr_start=2)),
    "quad_light": (None, 1, dict(max_bounces=4, rr_start=2)),
}


@pytest.fixture(scope="module")
def case_scenes(request):
    out = {}
    for name, (fixture, _, _) in CASES.items():
        js = (request.getfixturevalue(fixture) if fixture
              else _quad_light_scene(extra_sphere_lamp=True))
        out[name] = (js, port_scene(js))
    return out


def _counting(fn):
    """``fn`` that records the lane count and the active lanes of each
    call."""
    def wrapped(scene, ro, rd, t_min, active):
        wrapped.calls.append((ro.x.shape[0], int(active.sum())))
        return fn(scene, ro, rd, t_min, active)

    wrapped.calls = []
    return wrapped


@pytest.mark.parametrize("name", list(CASES))
def test_wavefront_equals_megakernel(case_scenes, name):
    """Bit for bit, on the twins bound explicitly; every bounce of the
    wavefront traces only its live lanes, all of them active."""
    _, pscene = case_scenes[name]
    _, iteration, kw = CASES[name]
    cam = make_camera(vfov=np.pi / 2)
    hit = functools.partial(intersect.intersect_scene_ids,
                            closest_hit=sweep_kernel.treelet_closest_hit_plain)
    mega, wave = _counting(hit), _counting(hit)
    any_hit = sweep_kernel.treelet_any_hit_plain
    a = trace_sample(pscene, cam, W, H, iteration, intersect_fn=mega, any_hit=any_hit, **kw)
    b = trace_sample_wavefront(pscene, cam, W, H, iteration, intersect_fn=wave, any_hit=any_hit,
                               **kw)
    assert int(a[3]) == int(b[3]) > W * H
    for k, x, y in zip(("color", "normal", "depth"), a[:3], b[:3]):
        assert x.shape == y.shape and torch.equal(x, y), k
    # the megakernel passes every lane each bounce, the wavefront its live ones
    assert [lanes for lanes, _ in mega.calls] == [W * H] * len(mega.calls)
    assert [act for _, act in mega.calls] == [lanes for lanes, _ in wave.calls]
    assert all(lanes == act for lanes, act in wave.calls)
    assert wave.calls[-1][0] < W * H and sum(act for _, act in wave.calls) == int(b[3])
    if name == "quad_light":
        assert pscene.s_tri_light_count > 0 and len(pscene.s_light_objs) == 1


@pytest.mark.parametrize("name", ["full_scene", "sphere_rr"])
def test_wavefront_matches_jax(case_scenes, name):
    jscene, pscene = case_scenes[name]
    _, iteration, kw = CASES[name]
    jc, jn, jd, jr = jax_wavefront(jscene, jax_make_camera(vfov=np.pi / 2), W, H, iteration, **kw)
    pc, pn, pd, pr = trace_sample_wavefront(pscene, make_camera(vfov=np.pi / 2), W, H, iteration,
                                            **kw)
    assert int(pr) == int(jr)
    for k, got, want in (("color", pc, jc), ("normal", pn, jn), ("depth", pd, jd)):
        assert np.isfinite(got.numpy()).all(), k
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=k, **IMAGE)


@pytest.mark.parametrize("n,p_live", [(1, 1.0), (257, 0.5), (1000, 0.03), (4096, 0.9),
                                      (513, 0.0)])
def test_partition_perm_matches_jax(n, p_live):
    alive = np.random.default_rng(n).random(n) < p_live
    jperm, jcount = jax_partition_perm(jnp.asarray(alive))
    perm, count = _partition_perm(torch.from_numpy(alive))
    assert int(count) == int(jcount) == int(alive.sum())
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    # stable, live lanes first
    c = int(count)
    assert alive[perm.numpy()[:c]].all() and not alive[perm.numpy()[c:]].any()
    assert (np.diff(perm.numpy()[:c]) > 0).all() and (np.diff(perm.numpy()[c:]) > 0).all()
