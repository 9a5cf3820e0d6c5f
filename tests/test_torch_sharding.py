"""Row-band sharding of the PyTorch port over ``torch.distributed``: four
CPU processes of the gloo backend, case for case the counterpart of
``tests/test_sharding.py`` (whose eight-device mesh is a JAX construct).

The four ranks are spawned once per module, rendezvous through a
``file://`` store under ``tmp_path`` (no ports), run every case in one
go (``_rank_cases``) and leave their results in a file each; the tests
below read them and hold them against this process's single-process
renders with the same port.

* The sharded render equals one process's bit for bit, unchained and
  chained (RNG and camera key off the global pixel; a band's lanes are the
  same lanes, and the gather is an all-reduce of bands padded with -0.0,
  which keeps every bit, the sign of zero too).
* Each rank's trips (the forward render's trip route, ``trip_head``) saw
  only its band's lanes.
* The sharded gradients match one process's at test_sharding.py's rtol
  1e-4, atol 1e-5, with the per-bounce placement on ``sphere_scene`` and
  the post-hoc one on ``full_scene``: the sums run in another order.  The
  loss is held at rtol 1e-5, as there.
* On ``sphere_scene`` the top band is all sky and ends after one bounce,
  the others later: post-hoc, each rank stops with its band; per bounce,
  every rank runs as many bounces as the longest band, so that the
  per-bounce collectives pair up.
* ``psum_in_backward`` alone: an identity forward, a sum over the ranks
  backward, on a leaf (the post-hoc placement's scene) and on a computed
  tensor (the per-bounce placement's slot table); one node per bounce
  equal to one node before the loop.  Its test values are small
  integers, so every sum is exact.

This module imports no JAX: the spawned ranks import it.
"""

import datetime
import multiprocessing
import pickle
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpupt_torch.core import math3d as m3
from tpupt_torch.core.camera import make_camera
from tpupt_torch.diff.overlap import psum_in_backward
from tpupt_torch.diff.params import extract_params, with_params
from tpupt_torch.dist.sharding import (
    _gather_bands,
    make_tile_mesh,
    render_image_sharded,
    render_loss_and_grads_sharded,
)
from tpupt_torch.render import integrator, trip_kernel
from tpupt_torch.render.integrator import render_image
from tpupt_torch.scene.description import SceneDescription
from tpupt_torch.scene.procedural import icosphere

# the test tensors are small, so torch's intra-op thread pool only adds
# overhead (a ~1k-ray twin sweep: 6.5 s on 8 threads, 0.2 s on one)
torch.set_num_threads(1)

W = H = 32
WORLD = 4
# (scene, max_bounces) of each placement's gradient case, as test_sharding.py
GRAD_CASES = {"overlap": ("sphere_scene", 4), "posthoc": ("full_scene", 3)}
PSUM_CASES = ("identity", "overlap", "posthoc", "per_bounce_equals_posthoc")
# each rank's band: -0.0 and +0.0 beside its rank, to gather
ZERO_SIGNS = (-0.0, 0.0, -1.5, 2.0)


def _scenes():
    """conftest's ``sphere_scene`` and ``full_scene``, built by the port."""
    T = lambda t: np.asarray(m3.mat_translate(t), np.float64)  # noqa: E731
    S = lambda s: np.asarray(m3.mat_scale(s), np.float64)  # noqa: E731
    d = SceneDescription()
    d.add_material("ground", "lambertian", albedo=(0.8, 0.8, 0.0))
    d.add_material("blue", "lambertian", albedo=(0.1, 0.2, 0.5))
    d.add_sphere(100.0, T([0, -100.5, -1.0]), "ground")
    d.add_sphere(0.5, T([0, 0, -1.0]), "blue")
    sphere = d.build(device="cpu")
    d = SceneDescription()
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
    return {"sphere_scene": sphere, "full_scene": d.build(device="cpu")}


def _cam():
    return make_camera(vfov=np.pi / 2)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else tree


def _psum_cases(group):
    """psum_in_backward on a replicated parameter x = [0, 1, 2], rank r's
    loss weighted by r + 1 (the weights sum to 10 over four ranks)."""
    r = dist.get_rank()
    out = {}
    x = torch.arange(3.0, requires_grad=True)
    y = psum_in_backward({"x": x}, group)["x"]
    out["identity"] = (torch.equal(y, x), y is not x)
    # on a computed tensor (the per-bounce placement's slot table), and on
    # the leaf itself (the post-hoc placement's scene)
    for name, computed in (("overlap", True), ("posthoc", False)):
        x = torch.arange(3.0, requires_grad=True)
        (psum_in_backward(x * 1.0 if computed else x, group) * (r + 1)).sum().backward()
        out[name] = x.grad.numpy()
    # three "bounces" of sum(x^2 (r + b)): one node per bounce, or one
    # before the loop
    grads = []
    for per_bounce in (True, False):
        x = torch.arange(3.0, requires_grad=True)
        once = psum_in_backward(x, group)
        loss = 0.0
        for b in range(3):
            xb = psum_in_backward(x, group) if per_bounce else once
            loss = loss + (xb * xb * (r + b)).sum()
        loss.backward()
        grads.append(x.grad.numpy())
    out["per_bounce_equals_posthoc"] = tuple(grads)
    return out


def _rank_cases(rank):
    scenes, cam = _scenes(), _cam()
    full, sphere = scenes["full_scene"], scenes["sphere_scene"]
    out = {}
    buf, rays = render_image_sharded(full, cam, W, H, 2, max_bounces=5, chain_samples=False)
    out["unchained"] = (buf.color.numpy(), buf.depth.numpy(), int(rays))
    buf, rays = render_image_sharded(full, cam, W, H, 2, max_bounces=5)
    out["chained"] = (buf.color.numpy(), int(rays))

    lanes = []
    head = trip_kernel.trip_head

    def counting(plan, F, *args):
        lanes.append(F.shape[1])
        return head(plan, F, *args)

    trip_kernel.trip_head = counting
    try:
        buf, _ = render_image_sharded(full, cam, W, H, 1, max_bounces=3)
    finally:
        trip_kernel.trip_head = head
    out["lanes"] = (sorted(set(lanes)), buf.color.shape[0])

    # bounces, counted as differentiable hit passes: of this rank's band
    # of sphere_scene alone, and of each sharded step
    bounces = [0]
    traced_diff = integrator.intersect_scene_ids_diff

    def counting_diff(*args, **kw):
        bounces[0] += 1
        return traced_diff(*args, **kw)

    integrator.intersect_scene_ids_diff = counting_diff
    try:
        rows = H // WORLD
        render_image(sphere, cam, W, H, 1, max_bounces=4, differentiable=True, row0=rank * rows,
                     rows=rows)
        out["band_bounces"] = bounces[0]
        for placement, (name, mb) in GRAD_CASES.items():
            bounces[0] = 0
            loss, grads = render_loss_and_grads_sharded(
                scenes[name], cam, np.zeros((W * H, 3), np.float32), W, H, 1, max_bounces=mb,
                overlap_grad_psum=placement == "overlap")
            out[f"grads_{placement}"] = (float(loss), _numpy(grads))
            out[f"bounces_{name}_{placement}"] = bounces[0]
        bounces[0] = 0
        render_loss_and_grads_sharded(sphere, cam, np.zeros((W * H, 3), np.float32), W, H, 1,
                                      max_bounces=4, overlap_grad_psum=False)
        out["bounces_sphere_scene_posthoc"] = bounces[0]
    finally:
        integrator.intersect_scene_ids_diff = traced_diff
    band = torch.tensor(ZERO_SIGNS) * (rank + 1)
    out["gather"] = _gather_bands(band[:, None], rank, WORLD, dist.group.WORLD).numpy()

    try:
        render_image_sharded(sphere, cam, W, 30, 1)
    except ValueError as e:
        out["uneven"] = str(e)
    sub = make_tile_mesh(2)
    out["subset"] = dist.get_world_size(sub) if rank < 2 else dist.get_rank(sub)
    try:
        make_tile_mesh(WORLD + 1)
    except ValueError as e:
        out["too_many"] = str(e)
    out["psum"] = _psum_cases(dist.group.WORLD)
    return out


def _rank_main(rank, store, path):
    """One rank: rendezvous, every case, the results (or the traceback)
    pickled to ``path``."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=WORLD,
                                rank=rank, timeout=datetime.timedelta(seconds=120))
        res = _rank_cases(rank)
    except Exception:  # the parent reports it
        res = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(path, "wb") as fh:
        pickle.dump(res, fh)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results, by rank."""
    tmp = tmp_path_factory.mktemp("gloo")
    ctx = multiprocessing.get_context("spawn")
    paths = [tmp / f"rank{r}.pkl" for r in range(WORLD)]
    procs = [ctx.Process(target=_rank_main, args=(r, str(tmp / "store"), str(paths[r])))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    out = []
    for path in paths:
        with open(path, "rb") as fh:
            res = pickle.load(fh)  # written by the ranks above
        assert "error" not in res, res["error"]
        out.append(res)
    return out


@pytest.fixture(scope="module")
def single():
    """This process's renders and gradients, unsharded."""
    scenes, cam = _scenes(), _cam()
    full = scenes["full_scene"]
    out = {}
    buf, rays = render_image(full, cam, W, H, 2, max_bounces=5, chain_samples=False)
    out["unchained"] = (buf.color.numpy(), buf.depth.numpy(), int(rays))
    buf, rays = render_image(full, cam, W, H, 2, max_bounces=5)
    out["chained"] = (buf.color.numpy(), int(rays))
    for placement, (name, mb) in GRAD_CASES.items():
        params = extract_params(scenes[name])
        buf, _ = render_image(with_params(scenes[name], params), cam, W, H, 1, max_bounces=mb,
                              differentiable=True)
        loss = (buf.color ** 2).sum()
        loss.backward()
        grads = {k: v.grad for k, v in params.items() if k != "materials"}
        grads["materials"] = {k: v.grad for k, v in params["materials"].items()}
        out[f"grads_{placement}"] = (float(loss.detach()), _numpy(grads))
    return out


def test_sharded_render_bit_identical(ranks, single):
    """The unchained sharded render == the single-process render, bit for
    bit, on every rank."""
    color, depth, rays = single["unchained"]
    for res in ranks:
        c, d, r = res["unchained"]
        np.testing.assert_array_equal(c.view(np.int32), color.view(np.int32))
        np.testing.assert_array_equal(d.view(np.int32), depth.view(np.int32))
        assert r == rays


def test_sharded_render_chained_matches(ranks, single):
    """The chained integrator under sharding: the same segment count and,
    the port's bands being the full render's lanes, the same bits."""
    color, rays = single["chained"]
    for res in ranks:
        np.testing.assert_array_equal(res["chained"][0].view(np.int32), color.view(np.int32))
        assert res["chained"][1] == rays


def test_gather_keeps_every_bit(ranks):
    """The band gather keeps the sign of zero: -0.0 pads the bands, and
    +0.0 + -0.0 would be +0.0 were the pad +0.0."""
    want = np.concatenate([np.float32(ZERO_SIGNS) * (r + 1) for r in range(WORLD)])[:, None]
    for res in ranks:
        np.testing.assert_array_equal(res["gather"].view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("placement", sorted(GRAD_CASES))
def test_bands_that_end_apart_pair_up(ranks, placement):
    """Post-hoc, each rank stops when its band dies; per bounce, every
    rank runs the bounces of the longest band (and the gradients of
    test_sharded_grads_match_single_process[overlap] come out right)."""
    own = [res["band_bounces"] for res in ranks]
    assert min(own) < max(own), own
    got = [res[f"bounces_sphere_scene_{placement}"] for res in ranks]
    assert got == (own if placement == "posthoc" else [max(own)] * WORLD), (got, own)


def test_sharded_output_actually_sharded(ranks):
    """Every trip of rank r traced its band's W * H / 4 lanes only; the
    returned buffers hold the whole image."""
    for res in ranks:
        assert res["lanes"] == ([W * H // WORLD], W * H)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("placement", sorted(GRAD_CASES))
def test_sharded_grads_match_single_process(ranks, single, placement):
    loss_1, grads_1 = single[f"grads_{placement}"]
    want = _leaves(grads_1)
    for res in ranks:
        loss_s, grads_s = res[f"grads_{placement}"]
        np.testing.assert_allclose(loss_s, loss_1, rtol=1e-5)
        got = _leaves(grads_s)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            b = np.zeros_like(a) if b is None else b
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_uneven_height_raises(ranks):
    for res in ranks:
        assert "not divisible" in res["uneven"]


def test_mesh_subset(ranks):
    """make_tile_mesh(2) is a group of ranks 0 and 1 (ranks 2 and 3 are not
    in it); more tiles than ranks raise."""
    assert [res["subset"] for res in ranks] == [2, 2, -1, -1]
    for res in ranks:
        assert "only 4 ranks" in res["too_many"]


@pytest.mark.parametrize("case", PSUM_CASES)
def test_psum_in_backward(ranks, case):
    for r, res in enumerate(ranks):
        got = res["psum"][case]
        if case == "identity":
            assert got == (True, True)
        elif case in ("overlap", "posthoc"):
            np.testing.assert_array_equal(got, np.full(3, 10.0))
        else:
            # sum over b of 2 x (r + b) = 2 x (3 r + 3), summed over the
            # ranks: 2 x (18 + 12) = 60 x
            per_bounce, posthoc = got
            np.testing.assert_array_equal(per_bounce, posthoc)
            np.testing.assert_array_equal(per_bounce, 60.0 * np.arange(3.0))
