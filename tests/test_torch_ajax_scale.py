"""The reference-scale scenes through the port (counterpart of
``tests/test_ajax_scale.py``): ajax-white.json's generated bust (81,920
triangles, K ~ 3.7k treelets) and ajax-white-hi.json's (327,680, K =
14,782), built by the port's bench harness (``_scene_ajax``,
``_scene_ajax_hi``) on the CPU.

* Scale: at least 50,000 / 300,000 triangles and 1,000 treelets (the
  two-level cull's regime).
* One render of each (crops of the 720x1280 portrait framing at 27x48, 1
  spp, 4 bounces, roulette from bounce 2) against the JAX package's
  ``render_image`` on its own harness's scene, run as test_ajax_scale.py
  runs it: traced rays EQUAL, buffers at test_torch_render.py's IMAGE
  (rtol 1e-4, atol 1e-5).
* The bust is visible: the frame centre differs from a render with the
  treelet table emptied (sky only) by more than 0.05.
* ``ensure_models`` regenerates a model whose version tag is stale and
  leaves a current one untouched.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tpupt.bench import harness as jh
from tpupt.render.integrator import render_image as jax_render_image

from tpupt_torch.bench import harness as ph
from tpupt_torch.render.integrator import render_image
from tpupt_torch.scene import assets_gen

# the test tensors are small, so torch's intra-op thread pool only adds
# overhead (a ~1k-ray twin sweep: 6.5 s on 8 threads, 0.2 s on one)
torch.set_num_threads(1)

IMAGE = dict(rtol=1e-4, atol=1e-5)
W, H = 27, 48  # the 9:16 portrait framing of the configs' 720x1280
SCALE = {"ajax": (50_000, 1_000), "ajax_hi": (300_000, 1_000)}


@pytest.fixture(scope="module", params=list(SCALE))
def ajax(request):
    """(name, port scene, port camera, port render, JAX render)."""
    name = request.param
    pscene, pcam = ph.CONFIGS[name]["scene"](device="cpu")
    jscene, jcam = jh.CONFIGS[name]["scene"]()
    kw = dict(max_bounces=4, rr_start=2)
    jbuf, jrays = jax_render_image(jscene, jcam, W, H, 1, **kw)
    pbuf, prays = render_image(pscene, pcam, W, H, 1, **kw)
    return name, pscene, pcam, (pbuf, int(prays)), (jbuf, int(jrays))


def test_reference_scale(ajax):
    name, scene, *_ = ajax
    tris, treelets = SCALE[name]
    assert scene.device.type == "cpu"
    assert scene.tri_idx.shape[0] >= tris, scene.tri_idx.shape
    assert scene.tre_min.shape[0] >= treelets, scene.tre_min.shape


def test_render_matches_jax(ajax):
    _, _, _, (pbuf, prays), (jbuf, jrays) = ajax
    assert prays == jrays > W * H
    for key in ("color", "normal", "depth"):
        got, want = getattr(pbuf, key).numpy(), np.asarray(getattr(jbuf, key))
        assert got.shape == want.shape and np.isfinite(got).all(), key
        np.testing.assert_allclose(got, want, err_msg=key, **IMAGE)


def test_bust_visible(ajax):
    _, scene, cam, (pbuf, _), _ = ajax
    empty = dataclasses.replace(scene, tre_min=torch.full((1, 3), 3e37),
                                tre_max=torch.full((1, 3), 3e37), tre_tris=scene.tre_tris[:1])
    sky, _ = render_image(empty, cam, W, H, 1, max_bounces=4, rr_start=2)
    mid = (slice(H // 3, 2 * H // 3), slice(W // 3, 2 * W // 3))
    gap = (pbuf.color.reshape(H, W, 3)[mid] - sky.color.reshape(H, W, 3)[mid]).abs().max()
    assert float(gap) > 0.05, "bust not visible in the render"


def test_ensure_models_regenerates_on_version_bump(tmp_path):
    d = str(tmp_path)
    assets_gen.ensure_models(d)
    p = os.path.join(d, "quad.obj")
    with open(p) as fh:
        assert "tpupt-gen quad.obj v1" in fh.readline()
    # stale tag -> regenerated; current tag -> untouched
    with open(p, "w") as fh:
        fh.write("# tpupt-gen quad.obj v0\nv 0 0 0\n")
    assets_gen.ensure_models(d)
    with open(p) as fh:
        assert "tpupt-gen quad.obj v1" in fh.readline()
    mtime = os.path.getmtime(p)
    assets_gen.ensure_models(d)
    assert os.path.getmtime(p) == mtime
