"""The forward trip as two hand-written CUDA kernels, ``trip_head`` and
``trip_tail`` (``accel/csrc/trip_kernels.cu``), and their torch twins.

In the JAX package the trips of ``_render_chained`` and the bounces of the
forward ``trace_sample`` run in one ``lax.while_loop``, compiled by XLA
into a few fused device kernels (``tpupt/render/integrator.py``).  Here a
trip of a forward render of a scene without emitters is

  ``trip_head``  the sphere pass (``intersect._sphere_pass``) and the
                 closest-hit sweep's packed rows (``packets._pack_rows``);
  ``sweep_kernel.treelet_closest_hit`` on those rows (scenes with a mesh);
  ``trip_tail``  the triangle half of the hit record
                 (``intersect.hit_record``), the no-emitter body of
                 ``integrator._bounce_body`` (background, shading,
                 emission, roulette) and, chained, the fold and restart of
                 ``integrator._chain_step``; it also counts the lanes left
                 to trace into a 4-byte device buffer the host reads.

The lane state lives in two SoA buffers that the kernels update in place,
one lane per thread: ``F`` (len(F_KEYS), N) float32 and ``I``
(len(I_KEYS), N) int32, the seed kept as its uint32 bits.  ``pack_state``
and ``unpack_state`` convert between them and the dicts of
``integrator``.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain twin for CPU tensors; the twins are assembled from the functions
named above, so the CPU tests hold the trip route to the body route and
to the JAX package.  ``integrator``, which runs the trip loop, builds the
plan and the start state and hands the twins its own ``_bounce_body`` and
``_chain_step`` in the plan, so this module does not import it.  Each
wrapper adds one to its count in ``LAUNCHES`` where it launches its kernel
(kept in a dict, so that a caller may wrap the module's functions to
record their inputs).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from tpupt_torch.accel import kernels
from tpupt_torch.accel.packets import _ROW_KEYS, PACKET, _pack_rows
from tpupt_torch.core.camera import viewport
from tpupt_torch.core.types import OBJ_MESH, OBJ_SPHERE, PRIM_NONE, PRIM_SPHERE, Camera, SceneArrays
from tpupt_torch.core.vec import Vec3
from tpupt_torch.render.intersect import _blank_ids, _sphere_pass, hit_record

# the float rows of the lane state: the path's state (ray, radiance,
# throughput, first-hit normal and depth), then the chained loop's running
# averages of colour, normal and depth
F_KEYS = ("rox", "roy", "roz", "rdx", "rdy", "rdz", "t_min", "radx", "rady", "radz",
          "colx", "coly", "colz", "nx", "ny", "nz", "depth",
          "acc_colx", "acc_coly", "acc_colz", "acc_nx", "acc_ny", "acc_nz", "acc_depth")
# the int32 rows: alive, the seed's uint32 bits, the lane's bounce, its
# finished samples, its traced segments, and done
I_KEYS = ("alive", "seed", "bounce", "k", "segs", "done")
_F = {k: i for i, k in enumerate(F_KEYS)}
_I = {k: i for i, k in enumerate(I_KEYS)}
_STATE_VEC = {"ro": ("rox", "roy", "roz"), "rd": ("rdx", "rdy", "rdz"),
              "radiance": ("radx", "rady", "radz"), "color": ("colx", "coly", "colz"),
              "normal": ("nx", "ny", "nz")}
_ACC_VEC = {"color": ("acc_colx", "acc_coly", "acc_colz"), "normal": ("acc_nx", "acc_ny", "acc_nz")}
RADIANCE, COLOR = _STATE_VEC["radiance"], _STATE_VEC["color"]
# the sphere pass's record that trip_head hands trip_tail: t, point,
# normal (float rows) and, in ``hint``, material * 2 + front, -1 where no
# sphere was hit
HREC_ROWS = 7
# a sphere object's row of the kernels' scene table: its inverse matrix's
# rows 0-2, its matrix's rows 0-2, centre, radius, material
SPHERE_ROW = 29
MAT_ROW = 9  # type, albedo, fuzz, ior, emission
_NO_RR = 2**31 - 1  # rr_start for no roulette: no bounce reaches it
LAUNCHES = {"trip_head": 0, "trip_tail": 0}  # kernel launches in this process


def rows(F: torch.Tensor, keys) -> list[torch.Tensor]:
    """The (N,) rows of ``F`` named ``keys``."""
    return [F[_F[k]] for k in keys]


def _seed_bits(seed: torch.Tensor) -> torch.Tensor:
    """uint32 values (int64) as their int32 bit patterns."""
    return torch.where(seed >= 2**31, seed - 2**32, seed).to(torch.int32)


def pack_state(state: dict, seed: torch.Tensor, bounce: torch.Tensor, chain: dict):
    """(F, I) from ``integrator``'s lane state dict, the seeds (uint32
    values as int64), the per-lane bounce and the chained loop's ``chain``
    dict (``integrator._chain_start``)."""
    f = [None] * len(F_KEYS)
    for name, keys in _STATE_VEC.items():
        for key, comp in zip(keys, state[name]):
            f[_F[key]] = comp
    for name, keys in _ACC_VEC.items():
        for key, comp in zip(keys, chain[name]):
            f[_F[key]] = comp
    f[_F["t_min"]], f[_F["depth"]], f[_F["acc_depth"]] = (state["t_min"], state["depth"],
                                                           chain["depth"])
    i = [state["alive"], _seed_bits(seed), bounce, chain["k"], chain["segs"], chain["done"]]
    return (torch.stack(f).contiguous(),
            torch.stack([t.to(torch.int32) for t in i]).contiguous())


def unpack_state(F: torch.Tensor, I: torch.Tensor) -> dict:
    """The inverse of ``pack_state``: {"state", "seed", "bounce", "chain"},
    the integer rows widened to int64 as ``integrator`` keeps them."""
    def vec3(keys):
        return Vec3(*rows(F, keys))

    state = {name: vec3(keys) for name, keys in _STATE_VEC.items()}
    state.update(t_min=F[_F["t_min"]], depth=F[_F["depth"]], alive=I[_I["alive"]] != 0)
    chain = dict(k=I[_I["k"]].long(), segs=I[_I["segs"]].long(), done=I[_I["done"]] != 0,
                 color=vec3(_ACC_VEC["color"]), normal=vec3(_ACC_VEC["normal"]),
                 depth=F[_F["acc_depth"]])
    return dict(state=state, seed=I[_I["seed"]].long() & 0xFFFFFFFF,
                bounce=I[_I["bounce"]].long(), chain=chain)


@dataclasses.dataclass
class TripPlan:
    """One render's trip loop: the scene, the camera, the band of lanes
    and the loop's settings.  ``chained``: the samples chain per lane
    (``spp`` samples from ``iteration``, the fold and restart in
    ``trip_tail``); else one sample, ``iteration``, traced to its end.
    ``body`` and ``fold`` are the body route's functions that the twin of
    ``trip_tail`` is assembled from (``integrator._trip_plan``)."""

    scene: SceneArrays
    camera: Camera
    width: int
    height: int
    pix0: int  # the global pixel index of lane 0 (row0 * width)
    pix: torch.Tensor  # (N,) int64 global pixel index of each lane
    spp: int
    max_bounces: int
    rr_start: int | None
    iteration: int
    chained: bool
    # body(state, seed, bounce, (ids, hit)): ``_bounce_body`` on that hit
    # record, the state after the bounce
    body: Callable
    # fold(state, state after the body, seed, bounce, chain):
    # ``_chain_step``, the next trip's (state, seed, bounce, chain)
    fold: Callable

    @property
    def n(self) -> int:
        return self.pix.shape[0]

    @property
    def n_pad(self) -> int:
        """Lanes of the sweep's packed rows: a packet multiple."""
        return -(-self.n // PACKET) * PACKET

    @property
    def mesh(self) -> bool:
        return any(k == OBJ_MESH for k in self.scene.s_obj_kind)

    @property
    def trips_bound(self) -> int:
        """Every lane is done within this many trips."""
        return self.spp * self.max_bounces if self.chained else self.max_bounces

    @functools.cached_property
    def tables(self):
        """The kernels' constants, built once per render on the scene's
        device: (table, number of sphere objects, offsets of the materials,
        the objects' materials and the background, camera).  ``table`` is
        float32: per sphere object in the scene's order a SPHERE_ROW row,
        per material a MAT_ROW row, each object's material, and bg_down,
        bg_up (ids and tags as floats, exact).  ``camera`` holds the
        viewport's width and height (rounded on the host, as
        ``camera.generate_rays`` rounds them) and the camera-to-world
        matrix's rows 0-2."""
        sc = self.scene
        dev = sc.device
        sph = [(o, p) for o, (k, p) in enumerate(zip(sc.s_obj_kind, sc.s_obj_prim))
               if k == OBJ_SPHERE]
        parts = [torch.cat([sc.obj_inv_m[o, :3].reshape(12), sc.obj_m[o, :3].reshape(12),
                            sc.sphere_center[p], sc.sphere_radius[p].reshape(1),
                            sc.obj_mat[o].float().reshape(1)]) for o, p in sph]
        m = sc.materials
        mats = torch.cat([m.mat_type.float()[:, None], m.albedo, m.fuzz[:, None], m.ior[:, None],
                          m.emission], dim=1).reshape(-1)
        mat_off = SPHERE_ROW * len(sph)
        obj_off = mat_off + mats.shape[0]
        bg_off = obj_off + sc.obj_mat.shape[0]
        table = torch.cat(parts + [mats, sc.obj_mat.float(), sc.bg_down, sc.bg_up])
        vw, vh = viewport(self.camera, self.width, self.height)
        cam = torch.cat([torch.tensor([float(vw), float(vh)], device=dev),
                         self.camera.camera_matrix.to(dev)[:3].reshape(12)])
        return (table.detach().float().contiguous(), len(sph), mat_off, obj_off, bg_off,
                cam.detach().float().contiguous())


@dataclasses.dataclass
class TripBuffers:
    """What one trip's kernels hand each other, allocated once a render:
    ``trip_head``'s sphere record (``hrec`` (HREC_ROWS, N) f32, ``hint``
    (N,) i32) and, for a scene with a mesh, the sweep's rows ((8, np, 256)
    f32, in ``packets._ROW_KEYS`` order) and live mask ((np, 256) bool);
    ``count`` (1,) i32, the lanes left after ``trip_tail``.  A dead lane's
    record and ray rows keep what they held (``trip_head``); they start at
    zero, so the sweep never reads memory no trip wrote."""

    hrec: torch.Tensor
    hint: torch.Tensor
    rows: torch.Tensor | None
    act_p: torch.Tensor | None
    count: torch.Tensor

    @functools.cached_property
    def sweep_rows(self) -> dict:
        """The packed rows as ``treelet_closest_hit`` takes them (views)."""
        return dict(zip(_ROW_KEYS, self.rows.unbind(0)))


def trip_buffers(plan: TripPlan) -> TripBuffers:
    dev, n = plan.scene.device, plan.n
    np_ = plan.n_pad // PACKET
    return TripBuffers(
        hrec=torch.zeros((HREC_ROWS, n), dtype=torch.float32, device=dev),
        hint=torch.zeros((n,), dtype=torch.int32, device=dev),
        rows=torch.zeros((len(_ROW_KEYS), np_, PACKET), dtype=torch.float32, device=dev)
        if plan.mesh else None,
        act_p=torch.zeros((np_, PACKET), dtype=torch.bool, device=dev) if plan.mesh else None,
        count=torch.zeros((1,), dtype=torch.int32, device=dev),
    )


# --- the twins ----------------------------------------------------------------

def trip_head_plain(plan: TripPlan, F, I, buf: TripBuffers) -> TripBuffers:
    """Torch twin of ``trip_head``: ``intersect._sphere_pass`` on the live
    lanes, its record into ``buf.hrec``/``buf.hint``, and
    ``packets._pack_rows`` seeded with its t into ``buf.rows``/``buf.act_p``
    (scenes with a mesh).  A dead lane's record and ray rows keep what
    they held; its seed t is -BIG and its mask False."""
    st = unpack_state(F, I)["state"]
    alive = st["alive"]
    t_best, kind, _, _, point, normal, front, mat = _sphere_pass(
        plan.scene, st["ro"], st["rd"], st["t_min"], alive, *_blank_ids(plan.n, F.device))
    code = torch.where(kind == PRIM_SPHERE, mat * 2 + front.long(), -1)
    buf.hrec.copy_(torch.where(alive, torch.stack([t_best, *point, *normal]), buf.hrec))
    buf.hint.copy_(torch.where(alive, code, buf.hint))
    if plan.mesh:
        packed, act_p = _pack_rows(st["ro"], st["rd"], st["t_min"], t_best, alive)
        lane = torch.arange(plan.n_pad, device=F.device).view(act_p.shape)
        new = torch.stack([packed[k] for k in _ROW_KEYS])
        # live and pad lanes take every row, dead lanes the -BIG seed only
        buf.rows.copy_(torch.where(act_p | (lane >= plan.n), new, buf.rows))
        buf.rows[-1] = new[-1]  # -BIG where not live
        buf.act_p.copy_(act_p)
    return buf


def trip_tail_plain(plan: TripPlan, F, I, buf: TripBuffers, sweep=None):
    """Torch twin of ``trip_tail``: the hit record from ``buf`` and the
    sweep's outputs (``intersect.hit_record``), ``plan.body``
    (``integrator._bounce_body``) on it, and, chained, ``plan.fold``
    (``integrator._chain_step``); F and I updated in
    place, the lanes left to trace into ``buf.count``.  Returns (F, I)."""
    scene, n = plan.scene, plan.n
    cur = unpack_state(F, I)
    st, seed, bounce, chain = cur["state"], cur["seed"], cur["bounce"], cur["chain"]
    hint = buf.hint.long()
    on_sphere = hint >= 0
    # the trip's sphere record keeps no object or primitive id: the body
    # of a scene without emitters reads neither
    none = torch.full((n,), -1, dtype=torch.int64, device=F.device)
    sphere = (buf.hrec[0], torch.where(on_sphere, PRIM_SPHERE, PRIM_NONE).to(torch.int32), none,
              none, Vec3(*buf.hrec[1:4]), Vec3(*buf.hrec[4:7]), on_sphere & (hint & 1 == 1),
              torch.where(on_sphere, hint >> 1, 0))
    mesh = None
    if sweep is not None:
        t, slot, nx, ny, nz, obj = (o.reshape(-1)[:n] for o in sweep)
        mesh = (t, slot, dict(nx=nx, ny=ny, nz=nz, obj=obj))
    ids, hit = hit_record(scene, st["ro"], st["rd"], sphere, mesh)
    st2 = plan.body(st, seed, bounce, (ids, hit))
    if plan.chained:
        st, seed, bounce, chain = plan.fold(st, st2, seed, bounce, chain)
        left = ~chain["done"]
    else:
        chain = dict(chain, segs=chain["segs"] + st["alive"].long())
        st, bounce = st2, bounce + 1
        left = st["alive"]
    F2, I2 = pack_state(st, seed, bounce, chain)
    F.copy_(F2)
    I.copy_(I2)
    buf.count.copy_(left.sum().reshape(1))
    return F, I


# --- the kernels ----------------------------------------------------------------

def _check(name, plan: TripPlan, F, I, buf: TripBuffers):
    """The checks both kernels make of their inputs; returns the library."""
    req = kernels.require
    dev = F.device
    req(F.is_cuda, f"{name}: unsupported device {dev}")
    n = plan.n
    req(tuple(F.shape) == (len(F_KEYS), n) and F.dtype == torch.float32,
        f"{name}: F must be ({len(F_KEYS)}, {n}) float32, got {tuple(F.shape)} {F.dtype}")
    req(tuple(I.shape) == (len(I_KEYS), n) and I.dtype == torch.int32,
        f"{name}: I must be ({len(I_KEYS)}, {n}) int32, got {tuple(I.shape)} {I.dtype}")
    req(tuple(buf.hrec.shape) == (HREC_ROWS, n) and buf.hrec.dtype == torch.float32,
        f"{name}: hrec must be ({HREC_ROWS}, {n}) float32")
    req(tuple(buf.hint.shape) == (n,) and buf.hint.dtype == torch.int32,
        f"{name}: hint must be ({n},) int32")
    req(tuple(buf.count.shape) == (1,) and buf.count.dtype == torch.int32,
        f"{name}: count must be (1,) int32")
    table, *_, cam = plan.tables
    tensors = [F, I, buf.hrec, buf.hint, buf.count, table, cam]
    if plan.mesh:
        np_ = plan.n_pad // PACKET
        req(buf.rows is not None and tuple(buf.rows.shape) == (len(_ROW_KEYS), np_, PACKET)
            and buf.rows.dtype == torch.float32, f"{name}: rows must be (8, {np_}, 256) float32")
        req(tuple(buf.act_p.shape) == (np_, PACKET) and buf.act_p.dtype == torch.bool,
            f"{name}: act_p must be ({np_}, 256) bool")
        tensors += [buf.rows, buf.act_p]
    for t in tensors:
        req(t.device == dev and t.is_contiguous(),
            f"{name}: every input must be contiguous on {dev}")
    req(plan.pix0 + n <= 2**31, f"{name}: pixel index past int32")
    return kernels.load()


def trip_head(plan: TripPlan, F, I, buf: TripBuffers) -> TripBuffers:
    """The sphere pass and the sweep's rows for the lane state (F, I):
    writes ``buf.hrec``, ``buf.hint`` and, for a scene with a mesh,
    ``buf.rows`` and ``buf.act_p``.  Launches are counted in
    ``LAUNCHES["trip_head"]``."""
    if F.device.type == "cpu":
        return trip_head_plain(plan, F, I, buf)
    lib = _check("trip_head", plan, F, I, buf)
    table, n_sph, *_ = plan.tables
    if plan.n:
        err = lib.tpupt_trip_head(
            F.data_ptr(), I.data_ptr(), plan.n, plan.n_pad, table.data_ptr(), n_sph,
            buf.hrec.data_ptr(), buf.hint.data_ptr(),
            buf.rows.data_ptr() if plan.mesh else None,
            buf.act_p.data_ptr() if plan.mesh else None, kernels.stream_of(F))
        kernels.check(lib, err, "trip_head")
        LAUNCHES["trip_head"] += 1
    return buf


def trip_tail(plan: TripPlan, F, I, buf: TripBuffers, sweep=None):
    """The rest of the trip for the lane state (F, I), updated in place:
    the hit record from ``buf`` and ``sweep`` (``treelet_closest_hit``'s
    six outputs on ``buf``'s rows, None for a scene without meshes), the
    body and, chained, the fold and restart; the lanes left to trace into
    ``buf.count``.  Returns (F, I).  Launches are counted in
    ``LAUNCHES["trip_tail"]``."""
    if F.device.type == "cpu":
        return trip_tail_plain(plan, F, I, buf, sweep)
    lib = _check("trip_tail", plan, F, I, buf)
    kernels.require((sweep is not None) == plan.mesh,
                    "trip_tail: the sweep's outputs go with a scene that has a mesh")
    if sweep is not None:
        kernels.require(
            len(sweep) == 6 and all(o.device == F.device and o.is_contiguous()
                                    and o.numel() == plan.n_pad for o in sweep)
            and sweep[1].dtype == torch.int32
            and all(sweep[j].dtype == torch.float32 for j in (0, 2, 3, 4, 5)),
            "trip_tail: sweep must be treelet_closest_hit's (t, slot, nx, ny, nz, obj)")
    table, _, mat_off, obj_off, bg_off, cam = plan.tables
    ptrs = [o.data_ptr() for o in sweep] if sweep is not None else [None] * 6
    rr = _NO_RR if plan.rr_start is None else int(plan.rr_start)
    if plan.n:
        err = lib.tpupt_trip_tail(
            F.data_ptr(), I.data_ptr(), plan.n, buf.hrec.data_ptr(), buf.hint.data_ptr(), *ptrs,
            table.data_ptr(), mat_off, obj_off, bg_off, cam.data_ptr(), plan.pix0,
            plan.width, plan.height, plan.iteration, plan.spp, plan.max_bounces, rr,
            int(plan.chained), buf.count.data_ptr(), kernels.stream_of(F))
        kernels.check(lib, err, "trip_tail")
        LAUNCHES["trip_tail"] += 1
    else:
        buf.count.zero_()
    return F, I


def launch_counts() -> dict[str, int]:
    """Kernel launches so far in this process."""
    return dict(LAUNCHES)
