"""The plain reference against the program's CPU path at a tiny size:
images and segments bit-equal, gradients within float32 summation."""

import json
import os

import pytest
import torch

from h100bench import run
from h100bench.reference import pathtrace as ref
from h100bench.tests.helpers import write_lit_scene


def _scene(name, tmp_path):
    """A configuration's scene file, or (``lit``) the tests' small scene
    with an emissive mesh: the reference's mesh, tie and NEE paths."""
    if name == "lit":
        return write_lit_scene(tmp_path)
    return run.prepare(run.ROOT, run.load_json(run.HERE, "configs", name + ".json"))


@pytest.mark.parametrize("name, w, h, spp", [("three_balls", 32, 18, 2), ("lit", 14, 14, 2)])
def test_forward_bit_equal(tmp_path, name, w, h, spp):
    import tpupt_torch
    from tpupt_torch.scene.json_parser import scene_from_json

    path = _scene(name, tmp_path)
    desc = scene_from_json(path)
    scene = desc.build(leaf_size=32, device="cpu")
    buf, rays = tpupt_torch.render_image(scene, desc.camera, w, h, spp, max_bounces=50,
                                         start_iteration=2**20 + 3)
    color, normal, depth, segs, tied = ref.render_forward(ref.load_scene(path, "cpu"), w, h, spp,
                                                          50, 2**20 + 3, block=100)
    assert int(rays) == int(segs.sum())
    assert not bool(tied.any())
    assert torch.equal(buf.color, color) and torch.equal(buf.normal, normal)
    assert torch.equal(buf.depth, depth)


@pytest.mark.parametrize("name", ["three_balls", "mesh"])
def test_gradient_step(tmp_path, name):
    """The differentiable trip on spheres, and on a mesh (the lit scene
    with its lamp made white: the trip takes scenes without emitters)."""
    import tpupt_torch
    from tpupt_torch.scene.json_parser import scene_from_json

    path = _scene("three_balls" if name == "three_balls" else "lit", tmp_path)
    if name == "mesh":
        lit = json.loads(open(path).read())
        lit["surfaces"][-1]["material"] = "white"
        open(path, "w").write(json.dumps(lit))
    desc = scene_from_json(path)
    scene = desc.build(leaf_size=32, device="cpu")
    p = tpupt_torch.extract_params(scene)
    buf, rays = tpupt_torch.render_image(tpupt_torch.with_params(scene, p), desc.camera, 16, 16, 2,
                                         max_bounces=8, differentiable=True, start_iteration=9)
    loss = torch.sum(buf.color ** 2)
    names = ["sphere_center", "sphere_radius", "positions", "bg_down", "bg_up"]
    mats = ["albedo", "fuzz", "ior", "emission"]
    g = torch.autograd.grad(loss, [p[k] for k in names] + [p["materials"][k] for k in mats],
                            allow_unused=True, materialize_grads=True)
    color, normal, depth, segs, tied, rloss, rg = ref.render_grad(
        ref.load_scene(path, "cpu"), 16, 16, 2, 8, 9, block=100)
    assert int(rays) == int(segs.sum())
    assert torch.equal(buf.color.detach(), color)
    assert abs(float(loss.detach()) - rloss) <= 1e-6 * rloss
    for k, a in zip(names + mats, g):
        b = rg[k]
        # the program sums the leaves' gradients in another order
        assert float((a - b).norm()) <= 1e-5 * max(float(b.norm()), 1e-3), k


def test_ties_are_flagged():
    """Two triangles sharing an edge that a ray crosses exactly: its
    closest t is theirs both."""
    tris = dict(obj=0, p0=ref.V3(*torch.tensor([[0.0, 0.0], [0.0, 0.0], [0.0, 0.0]])),
                e1=ref.V3(*torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]])),
                e2=ref.V3(*torch.tensor([[0.0, 1.0], [1.0, 1.0], [0.0, 0.0]])),
                lo=torch.tensor([-1.0, -1.0, -1.0]), hi=torch.tensor([2.0, 2.0, 1.0]))
    ro = ref.V3(torch.tensor([0.5, 0.2]), torch.tensor([0.5, 0.1]), torch.tensor([1.0, 1.0]))
    rd = ref.V3(torch.tensor([0.0, 0.0]), torch.tensor([0.0, 0.0]), torch.tensor([-1.0, -1.0]))
    ties = torch.zeros(2, dtype=torch.bool)
    hit, t, _ = ref.mesh_closest(tris, ro, rd, torch.zeros(2), torch.full((2,), 10.0),
                                 torch.ones(2, dtype=torch.bool), ties)
    assert hit.tolist() == [True, True] and ties.tolist() == [True, False]
    assert os.path.basename(ref.__file__) == "pathtrace.py"
