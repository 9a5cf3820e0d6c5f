"""Host scene build of the PyTorch port against the JAX package.

Every ``SceneArrays`` leaf the port builds must EQUAL the JAX package's:
the OBJ parse, the SAH BVH (both packages compile the same C++ builder),
the treelet cut and the world bake are all exact host arithmetic.
``port_scene`` is also how the other ``test_torch_*`` files carry a JAX
scene across: leaves become numpy on this side, so the port never sees
JAX.
"""

import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import tpupt.core.math3d as jm3
from tpupt.accel.bvh import build_bvh as jax_build_bvh
from tpupt.scene.description import SceneDescription as JaxDescription
from tpupt.scene.json_parser import scene_from_json as jax_scene_from_json
from tpupt.scene.obj_loader import load_obj as jax_load_obj
from tpupt.scene.procedural import icosphere as jax_icosphere

from tpupt_torch.accel.bvh import build_bvh
from tpupt_torch.core.types import STATIC_FIELDS, scene_from_numpy
from tpupt_torch.scene.assets_gen import ensure_models, locate_asset_path
from tpupt_torch.scene.description import SceneDescription
from tpupt_torch.scene.json_parser import scene_from_json
from tpupt_torch.scene.obj_loader import load_obj
from tpupt_torch.scene.procedural import icosphere

# the test tensors are small, so torch's intra-op thread pool only adds
# overhead (a ~1k-ray twin sweep: 6.5 s on 8 threads, 0.2 s on one)
torch.set_num_threads(1)


def port_scene(jscene, device="cpu"):
    """A JAX ``SceneArrays`` as the port's, through numpy."""
    np_scene = jax.tree_util.tree_map(np.asarray, jscene)
    leaves = {
        f.name: getattr(np_scene, f.name)
        for f in dataclasses.fields(np_scene)
        if f.name not in STATIC_FIELDS and f.name != "materials"
    }
    leaves["materials"] = {
        f.name: getattr(np_scene.materials, f.name)
        for f in dataclasses.fields(np_scene.materials)
    }
    static = {name: getattr(jscene, name) for name in STATIC_FIELDS}
    return scene_from_numpy(leaves, static, device=device)


def assert_scene_equal(jscene, pscene):
    for f in dataclasses.fields(pscene):
        if f.name in STATIC_FIELDS:
            assert getattr(pscene, f.name) == getattr(jscene, f.name), f.name
            continue
        pairs = (
            [(f"materials.{g.name}", getattr(jscene.materials, g.name),
              getattr(pscene.materials, g.name))
             for g in dataclasses.fields(pscene.materials)]
            if f.name == "materials"
            else [(f.name, getattr(jscene, f.name), getattr(pscene, f.name))]
        )
        for name, a, b in pairs:
            a, b = np.asarray(a), b.cpu().numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype, a.shape, b.shape)
            np.testing.assert_array_equal(b, a, err_msg=name)


def full_scene_description(desc_cls, m3):
    """The conftest ``full_scene`` description, for either package."""
    T = lambda t: np.asarray(m3.mat_translate(t), np.float64)
    S = lambda s: np.asarray(m3.mat_scale(s), np.float64)
    d = desc_cls()
    d.add_material("ground", "lambertian", albedo=(0.8, 0.8, 0.0))
    d.add_material("blue", "lambertian", albedo=(0.1, 0.2, 0.5))
    d.add_material("glass", "dielectric", refraction_index=1.5)
    d.add_material("metal", "metal", albedo=(0.8, 0.6, 0.2), fuzz=0.3)
    d.add_sphere(100.0, T([0, -100.5, -1.0]), "ground")
    d.add_sphere(0.5, T([-1, 0, -1.0]), "glass")
    d.add_sphere(0.5, T([1, 0, -1.0]), "metal")
    v, f = icosphere(2)
    d.add_mesh("ico", v, f)
    d.add_mesh_object("ico", T([0, 0, -1.6]) @ S(0.6), "blue")
    v2, f2 = icosphere(1)
    d.add_mesh("ico1", v2, f2)
    d.add_mesh_object("ico1", T([0.3, 0.8, -2.2]) @ S(0.4), "metal")
    return d


SCENES = ["bunny.json", "multi_mesh.json", "cornell.json", "cornell_area.json", "three_balls.json",
          "ajax-white.json", "ajax-white-hi.json"]


@pytest.fixture(scope="module")
def scenes_dir(tmp_path_factory):
    """The shipped scene JSONs beside a private models/ dir: other test
    files generate the shared assets/models concurrently."""
    root = tmp_path_factory.mktemp("assets")
    shutil.copytree(os.path.join(locate_asset_path(), "scenes"), root / "scenes")
    ensure_models(str(root / "models"), names=["bunny.obj", "blob.obj", "knot.obj", "quad.obj",
                                              "ajax.obj", "ajax_hi.obj"])
    return str(root / "scenes")


@pytest.mark.parametrize("name", SCENES)
def test_scene_json_leaves_equal(scenes_dir, name):
    path = os.path.join(scenes_dir, name)
    jdesc = jax_scene_from_json(path)
    pdesc = scene_from_json(path)
    assert_scene_equal(jdesc.build(leaf_size=32), pdesc.build(leaf_size=32, device="cpu"))
    np.testing.assert_array_equal(pdesc.camera.camera_matrix.numpy(), jdesc.camera.camera_matrix)
    assert pdesc.camera.vfov == float(jdesc.camera.vfov)
    assert (pdesc.resolution, pdesc.spp) == (jdesc.resolution, jdesc.spp)


def test_full_scene_leaves_equal(full_scene):
    from tpupt_torch.core import math3d as pm3

    pscene = full_scene_description(SceneDescription, pm3).build(device="cpu")
    assert_scene_equal(full_scene, pscene)
    # and the JAX side of the same description is the conftest fixture
    assert_scene_equal(full_scene_description(JaxDescription, jm3).build(), pscene)


def test_scene_from_numpy_carries_a_jax_scene(full_scene):
    assert_scene_equal(full_scene, port_scene(full_scene))


@pytest.mark.parametrize("model", ["bunny.obj", "knot.obj"])
def test_obj_parse_equal(scenes_dir, model):
    path = os.path.join(os.path.dirname(scenes_dir), "models", model)
    jp, jt = jax_load_obj(path)
    pp, pt = load_obj(path)
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(pt, jt)
    assert pp.dtype == jp.dtype and pt.dtype == jt.dtype


@pytest.mark.parametrize("subdiv", [1, 2, 3])
def test_flat_bvh_equal(subdiv):
    """Meshes of 64 triangles and more go through the native builder."""
    v, f = jax_icosphere(subdiv)
    pv, pf = icosphere(subdiv)
    np.testing.assert_array_equal(pv, v)
    a, b = jax_build_bvh(v, f), build_bvh(pv, pf)
    for k in ("node_min", "node_max", "node_tri", "node_skip"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=k)


def test_small_mesh_bvh_uses_numpy_builder():
    v, f = jax_icosphere(0)  # 20 triangles: below the native threshold
    a, b = jax_build_bvh(v, f), build_bvh(v, f)
    for k in ("node_min", "node_max", "node_tri", "node_skip"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=k)


def test_build_places_scene_on_device():
    d = SceneDescription()
    d.add_material("m", "lambertian", albedo=(1, 1, 1))
    d.add_sphere(1.0, np.eye(4), "m")
    s = d.build(device=torch.device("cpu"))
    assert s.device.type == "cpu" and s.tre_tris.dtype == torch.float32
    assert s.to("cpu").sphere_radius.item() == 1.0
