"""The port's any-hit sweep against the JAX package's
``intersect_treelets_anyhit``, packet by packet, at the live-lane counts
where the CUDA kernels change route: 0 (nothing to walk), 1 and 13 (one
warp, several threads to a ray), 32 (one warp, one thread a ray), 33 (the
block route, rays compacted into two warps) and 256 (every lane).  Each
count runs below ``_TWOLEVEL_MIN_K`` (two icosphere(2) instances: every
treelet a candidate) and above it (``test_lex_selection``'s two
icosphere(3) instances: the two-level cull).

On the CPU the port runs the kernels' twin, ``treelet_any_hit_plain``;
``tests/test_torch_kernels.py`` holds the kernels to the twin on the card.
The occlusion bits are compared exactly: the JAX reference runs op by op
(``jax.disable_jit()``), so both round every float32 operation once, in
the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpupt.core.math3d as m3
from tpupt.accel.packets import intersect_treelets_anyhit as jax_anyhit
from tpupt.scene.description import SceneDescription
from tpupt.scene.procedural import icosphere

from test_lex_selection import _rays as lex_rays
from test_lex_selection import _scene as lex_scene
from test_torch_scene import port_scene
from tpupt_torch.accel import packets
from tpupt_torch.core.vec import Vec3

# the test tensors are small, so torch's intra-op thread pool only adds
# overhead
torch.set_num_threads(1)

LIVE = (0, 1, 13, 32, 33, 256)


def _small_scene():
    """test_lex_selection's scene at icosphere(2): K < _TWOLEVEL_MIN_K."""
    v, f = icosphere(2)
    d = SceneDescription()
    d.add_material("m", "lambertian", albedo=(1, 1, 1))
    d.add_mesh("mesh", v, f)
    d.add_mesh_object("mesh", np.eye(4), "m")
    d.add_mesh_object("mesh", np.asarray(m3.mat_translate([1.5, 0.3, -1])), "m")
    return d.build()


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX scene, port scene)."""
    out = {}
    for name, build in (("dense_cull", _small_scene), ("two_level", lex_scene)):
        js = build()
        out[name] = (js, port_scene(js))
    return out


def _inputs(n_live, seed=7):
    """test_lex_selection's 32 x 32 pixel-centre rays (4 packets) with
    per-lane window ends from [0.5, 6] and n_live random live lanes in
    every packet."""
    ro, rd, t_min, _, _ = lex_rays()
    n = t_min.shape[0]
    r = np.random.default_rng(seed + n_live)
    t_limit = r.uniform(0.5, 6.0, n).astype(np.float32)
    active = np.zeros(n, bool)
    for p0 in range(0, n, packets.PACKET):
        active[p0 + r.choice(packets.PACKET, n_live, replace=False)] = True
    return ro, rd, np.asarray(t_min), t_limit, active


@pytest.mark.parametrize("n_live", LIVE)
@pytest.mark.parametrize("scene_name", ["dense_cull", "two_level"])
def test_anyhit_matches_jax_by_live_lanes(scenes, scene_name, n_live):
    jscene, pscene = scenes[scene_name]
    assert (pscene.tre_min.shape[0] >= packets._TWOLEVEL_MIN_K) == (scene_name == "two_level")
    ro, rd, t_min, t_limit, active = _inputs(n_live)
    assert active.reshape(-1, packets.PACKET).sum(axis=1).tolist() == [n_live] * 4
    with jax.disable_jit():
        want = np.asarray(jax_anyhit(jscene, ro, rd, jnp.asarray(t_min), jnp.asarray(t_limit),
                                     jnp.asarray(active)))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = packets.intersect_treelets_anyhit(
        pscene, Vec3(*(t(c) for c in ro)), Vec3(*(t(c) for c in rd)), t(t_min), t(t_limit),
        t(active)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[~active].any()
    if n_live >= 13:  # enough rays that some are occluded and some not
        assert 0 < got.sum() < active.sum()
