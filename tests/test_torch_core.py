"""Core math, camera and RNG of the PyTorch port against the JAX package.

Integer results (hash bits) must be EQUAL.  Ray generation and sphere
sampling go through transcendental functions (tan on the host, rsqrt,
sin, cos) whose float32 implementations differ in the last bit between
XLA's CPU backend and torch; hence rtol 1e-6, atol 1e-7.
"""

import ast
import glob
import inspect
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpupt.core.math3d as jm3
from tpupt.core.camera import generate_rays as jax_generate_rays
from tpupt.core.camera import make_camera as jax_make_camera
from tpupt.sampling import rng as jrng
from tpupt.sampling.sphere import random_in_unit_sphere as jax_sphere

from tpupt_torch.core import math3d as pm3
from tpupt_torch.core.camera import generate_rays, make_camera
from tpupt_torch.core.vec import Vec3
from tpupt_torch.sampling import rng
from tpupt_torch.sampling.sphere import random_in_unit_sphere

# the test tensors are small, so torch's intra-op thread pool only adds
# overhead (a ~1k-ray twin sweep: 6.5 s on 8 threads, 0.2 s on one)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAYS = dict(rtol=1e-6, atol=1e-7)


def _u32_inputs():
    a = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    a[:4] = [0, 1, 2**31, 2**32 - 1]
    return a


def test_import_keeps_jax_out():
    code = (
        "import sys, tpupt_torch\n"
        "import tpupt_torch.render.integrator, tpupt_torch.scene.json_parser\n"
        "import tpupt_torch.accel.sweep_kernel, tpupt_torch.accel.step_kernel\n"
        "import tpupt_torch.diff.params, tpupt_torch.denoise.atrous, tpupt_torch.scene.bake\n"
        "import tpupt_torch.render.progressive, tpupt_torch.render.wavefront\n"
        "import tpupt_torch.cli.main, tpupt_torch.interactive.viewer\n"
        "import tpupt_torch.utils.image, tpupt_torch.utils.timer, tpupt_torch.utils.debug\n"
        "import tpupt_torch.dist.sharding, tpupt_torch.dist.bootstrap\n"
        "import tpupt_torch.diff.fit, tpupt_torch.diff.overlap\n"
        "import tpupt_torch.accel.traverse, tpupt_torch.cpu_ref.renderer\n"
        "import tpupt_torch.bench.harness, tpupt_torch.bench.scaling\n"
        "bad = [m for m in sys.modules if m in ('jax', 'optax', 'PIL', 'matplotlib')\n"
        "       or m.startswith(('jax.', 'optax.', 'tpupt.', 'PIL.', 'matplotlib.'))]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT, timeout=120)


def _port_sources():
    pkg = os.path.join(ROOT, "tpupt_torch")
    paths = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    tools = glob.glob(os.path.join(ROOT, "experiments", "torch_*.py"))
    return sorted(paths) + [os.path.join(ROOT, "chip_smoke.py")] + sorted(tools)


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_source_stays_off_the_jax_package(path):
    """No module of the port, not chip_smoke.py and no port script under
    experiments/ imports jax, optax or tpupt or
    names a path under tpupt/ (a "tpupt" path component, or a file path
    such as "tpupt/native/x.cpp"; a "file:line" citation is no path)."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            names = []
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "optax", "tpupt"), (path, name)
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not re.fullmatch(r"tpupt(/[\w.\-]+)*/?", node.value), (path, node.value)


@pytest.mark.parametrize("package", ["tpupt", "tpupt.diff"])
def test_port_exports_the_jax_packages_names(package):
    """Every name the JAX package exports, the port's counterpart exports
    too (``tpupt.trace_sample``, ``tpupt.diff.fit_scene``)."""
    import importlib

    jax_mod = importlib.import_module(package)
    port_mod = importlib.import_module(package.replace("tpupt", "tpupt_torch", 1))
    missing = [name for name in jax_mod.__all__ if not hasattr(port_mod, name)]
    assert not missing, missing
    assert set(jax_mod.__all__) <= set(port_mod.__all__)


def test_native_builder_source_lives_in_the_port():
    from tpupt_torch.accel import native

    pkg = os.path.join(ROOT, "tpupt_torch") + os.sep
    assert os.path.abspath(native._SOURCE).startswith(pkg)
    assert os.path.isfile(native._SOURCE)


def test_entry_points_default_to_the_card():
    """Scenes are built on the card unless the caller names a device; with
    no card the build raises instead of falling back to the CPU.  The
    render follows the scene's device.  So do the bench harness's scene
    builders, ``run_config`` and the scaling measurement."""
    from tpupt_torch.bench import harness, scaling
    from tpupt_torch.core.types import scene_from_numpy
    from tpupt_torch.diff.params import params_from_numpy
    from tpupt_torch.render.integrator import render_image
    from tpupt_torch.scene.description import SceneDescription

    sig = inspect.signature
    assert sig(SceneDescription.build).parameters["device"].default == "cuda"
    assert sig(scene_from_numpy).parameters["device"].default == "cuda"
    assert sig(params_from_numpy).parameters["device"].default == "cuda"
    assert sig(render_image).parameters["device"].default is None
    d = SceneDescription()
    d.add_material("m", "lambertian", albedo=(1, 1, 1))
    d.add_sphere(1.0, np.eye(4), "m")
    builders = [cfg["scene"] for cfg in harness.CONFIGS.values()] + [scaling._flagship_scene]
    for fn in builders + [harness.run_config, scaling.measure]:
        assert sig(fn).parameters["device"].default == "cuda", fn.__name__
    if torch.cuda.is_available():
        assert d.build().device.type == "cuda"
        assert harness._scene_sphere()[0].device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            d.build()
        for fn in (harness._scene_sphere, harness._scene_cornell, scaling._flagship_scene):
            with pytest.raises((AssertionError, RuntimeError)):
                fn()
        with pytest.raises((AssertionError, RuntimeError)):
            harness.run_config("sphere", iters=1)
        with pytest.raises(RuntimeError):
            scaling.measure(2)


def test_wang_hash_bit_equal():
    a = _u32_inputs()
    want = np.asarray(jrng.wang_hash(jnp.asarray(a)))
    got = rng.wang_hash(torch.from_numpy(a.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert got.min() >= 0 and got.max() < 2**32


def test_pixel_seed_and_uniform_bit_equal():
    a = _u32_inputs()
    it = np.arange(4096, dtype=np.int32) % 37
    want_seed = np.asarray(jrng.pixel_seed(jnp.asarray(a), jnp.asarray(it)))
    seed = rng.pixel_seed(torch.from_numpy(a.astype(np.int64)), torch.from_numpy(it))
    np.testing.assert_array_equal(seed.numpy().astype(np.uint32), want_seed)
    # scalar iteration, per-lane and scalar counters
    want = np.asarray(jrng.pixel_seed(jnp.asarray(a), 5))
    np.testing.assert_array_equal(rng.pixel_seed(torch.from_numpy(a.astype(np.int64)), 5).numpy(),
                                  want.astype(np.int64))
    counters = np.arange(4096, dtype=np.int32) * 977 % 819
    for c_j, c_p in ((jnp.asarray(counters), torch.from_numpy(counters)), (3, 3)):
        u_want = np.asarray(jrng.uniform(jnp.asarray(a), c_j))
        u_got = rng.uniform(torch.from_numpy(a.astype(np.int64)), c_p).numpy()
        np.testing.assert_array_equal(u_got, u_want)
        assert u_got.dtype == np.float32


@pytest.mark.parametrize("bounce,lane", [(0, 0), (7, 3), (49, 15)])
def test_bounce_counter(bounce, lane):
    assert rng.bounce_counter(bounce, lane) == int(jrng.bounce_counter(bounce, lane))


def _camera_pair(vfov, position, rotation):
    return (jax_make_camera(position, rotation, vfov), make_camera(position, rotation, vfov))


@pytest.mark.parametrize("w,h,vfov", [(24, 16, np.pi / 2), (37, 53, np.deg2rad(60.0))])
def test_generate_rays_close(w, h, vfov):
    rot = jm3.mat_rotate(0.3, [0.2, 1.0, 0.1])[:3, :3]
    jcam, pcam = _camera_pair(vfov, (0.5, 1.0, 3.0), rot)
    r = np.random.default_rng(1)
    n = w * h
    fx = (np.arange(n) % w + r.random(n)).astype(np.float32)
    fy = (np.arange(n) // w + r.random(n)).astype(np.float32)
    jro, jrd = jax_generate_rays(jcam, w, h, jnp.asarray(fx), jnp.asarray(fy))
    pro, prd = generate_rays(pcam, w, h, torch.from_numpy(fx), torch.from_numpy(fy))
    for a, b in zip((*jro, *jrd), (*pro, *prd)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **RAYS)


def test_random_in_unit_sphere_close():
    seeds = _u32_inputs()
    bounce = np.arange(4096, dtype=np.int32) % 50
    want = jax_sphere(jnp.asarray(seeds), jnp.asarray(bounce))
    got = random_in_unit_sphere(torch.from_numpy(seeds.astype(np.int64)), torch.from_numpy(bounce))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **RAYS)


def test_host_matrices_equal():
    np.testing.assert_array_equal(pm3.mat_translate([1, 2, 3]), jm3.mat_translate([1, 2, 3]))
    np.testing.assert_array_equal(pm3.mat_scale(0.5), jm3.mat_scale(0.5))
    np.testing.assert_array_equal(pm3.mat_rotate(0.7, [1, 2, 3]), jm3.mat_rotate(0.7, [1, 2, 3]))
    np.testing.assert_array_equal(
        pm3.mat_look_at([1, 2, 3], [0, 0, 0], [0, 1, 0]),
        jm3.mat_look_at([1, 2, 3], [0, 0, 0], [0, 1, 0]),
    )
    m = jm3.mat_rotate(0.4, [0, 1, 1]) @ jm3.mat_translate([1, 0, 2])
    for a, b in zip(pm3.transform_aabb_np(m, [-1, -1, -1], [1, 2, 3]),
                    jm3.transform_aabb_np(m, [-1, -1, -1], [1, 2, 3])):
        np.testing.assert_array_equal(a, b)


def test_vec_ops_close():
    r = np.random.default_rng(2)
    a, b = r.standard_normal((2, 3, 64)).astype(np.float32)
    m = jm3.mat_rotate(0.9, [1, 0.5, 0]) @ jm3.mat_translate([0.1, 0.2, 0.3])
    from tpupt.core import vec as jvec
    from tpupt_torch.core import vec as pvec

    ja, jb = jvec.Vec3(*map(jnp.asarray, a)), jvec.Vec3(*map(jnp.asarray, b))
    pa, pb = Vec3(*map(torch.from_numpy, a)), Vec3(*map(torch.from_numpy, b))
    pairs = [
        (ja.normalize(), pa.normalize()),
        (jvec.reflect(ja, jb.normalize()), pvec.reflect(pa, pb.normalize())),
        (jvec.transform_point(jnp.asarray(m), ja), pvec.transform_point(torch.from_numpy(m), pa)),
        (jvec.transform_normal(jnp.asarray(m), ja), pvec.transform_normal(torch.from_numpy(m), pa)),
    ]
    for jv, pv in pairs:
        for x, y in zip(jv, pv):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5, atol=1e-6)
