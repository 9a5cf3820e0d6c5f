"""The forward trip as hand-written CUDA kernels, ``trip_head``,
``trip_nee`` and ``trip_tail`` (``accel/csrc/trip_kernels.cu``), and their
torch twins.

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

A trip of a scene with emitters (next-event estimation, NEE) is

  ``trip_head``  as above;
  ``sweep_kernel.treelet_closest_hit`` (scenes with a mesh);
  ``trip_nee``   the hit record and ``integrator._bounce_shade`` (the body
                 up to NEE's shadow rays: background, the first hit's
                 normal and depth, shading, the MIS-weighted emission and
                 NEE's sample step), then each NEE term's sphere test
                 (``intersect.sphere_occlusion``): its contribution, the
                 mask of the lanes no sphere occludes and, with a mesh, the
                 any-hit sweep's packed rows, each term in a packet-aligned
                 region of one buffer;
  ``sweep_kernel.treelet_any_hit`` on every term's rows in one call
                 (scenes with a mesh);
  ``trip_tail``  in its NEE mode: the lit terms added in
                 ``integrator._nee_resolve``'s order, roulette, the fold
                 and restart, the lanes left.

The lane state lives in two SoA buffers that the kernels update in place,
one lane per thread: ``F`` (len(F_KEYS), N) float32 and ``I``
(len(I_KEYS), N) int32, the seed kept as its uint32 bits.  ``pack_state``
and ``unpack_state`` convert between them and the dicts of
``integrator``.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain twin for CPU tensors; the twins are assembled from the functions
named above, so the CPU tests hold the trip route to the body route and
to the JAX package.  ``integrator``, which runs the trip loop, builds the
plan and the start state and hands the twins its own ``_bounce_shade``,
``_bounce_finish``, ``_nee_resolve`` and ``_chain_step`` in the plan, so
this module does not import it.  Each wrapper adds one to its count in
``LAUNCHES`` where it launches its kernel (kept in a dict, so that a
caller may wrap the module's functions to record their inputs).
"""

from __future__ import annotations

import dataclasses
import functools
import types
from typing import Callable, NamedTuple

import torch

from tpupt_torch.accel import kernels
from tpupt_torch.accel.packets import _ROW_KEYS, PACKET, _pack_rows
from tpupt_torch.core.camera import viewport
from tpupt_torch.core.types import OBJ_MESH, OBJ_SPHERE, PRIM_NONE, PRIM_SPHERE, Camera, SceneArrays
from tpupt_torch.core.vec import Vec3
from tpupt_torch.render.intersect import _blank_ids, _sphere_pass, hit_record, sphere_occlusion

# the float rows of the lane state: the path's state (ray, radiance,
# throughput, first-hit normal and depth), the chained loop's running
# averages of colour, normal and depth, and NEE's solid-angle pdf of the
# last scatter (0 without emitters)
F_KEYS = ("rox", "roy", "roz", "rdx", "rdy", "rdz", "t_min", "radx", "rady", "radz",
          "colx", "coly", "colz", "nx", "ny", "nz", "depth",
          "acc_colx", "acc_coly", "acc_colz", "acc_nx", "acc_ny", "acc_nz", "acc_depth", "pdf_w")
# the int32 rows: alive, the seed's uint32 bits, the lane's bounce, its
# finished samples, its traced segments, done, and NEE's "the last scatter
# was specular" (0 without emitters)
I_KEYS = ("alive", "seed", "bounce", "k", "segs", "done", "spec")
_F = {k: i for i, k in enumerate(F_KEYS)}
_I = {k: i for i, k in enumerate(I_KEYS)}
_STATE_VEC = {"ro": ("rox", "roy", "roz"), "rd": ("rdx", "rdy", "rdz"),
              "radiance": ("radx", "rady", "radz"), "color": ("colx", "coly", "colz"),
              "normal": ("nx", "ny", "nz")}
_ACC_VEC = {"color": ("acc_colx", "acc_coly", "acc_colz"), "normal": ("acc_nx", "acc_ny", "acc_nz")}
RADIANCE, COLOR = _STATE_VEC["radiance"], _STATE_VEC["color"]
# the sphere pass's record that trip_head hands on: t, point, normal (float
# rows) and, in ``hint``, object * 2 + front, -1 where no sphere was hit
HREC_ROWS = 7
# a sphere object's row of the kernels' scene table: its inverse matrix's
# rows 0-2, its matrix's rows 0-2, centre, radius, object id
SPHERE_ROW = 29
MAT_ROW = 9  # type, albedo, fuzz, ior, emission
LIGHT_ROW = 8  # a sphere light: centre, radius, emission, object id
TRI_LIGHT_ROW = 11  # an emissive triangle: p0, e1, e2, object id, material
_NO_RR = 2**31 - 1  # rr_start for no roulette: no bounce reaches it
LAUNCHES = {"trip_head": 0, "trip_nee": 0, "trip_tail": 0}  # kernel launches in this process


def rows(F: torch.Tensor, keys) -> list[torch.Tensor]:
    """The (N,) rows of ``F`` named ``keys``."""
    return [F[_F[k]] for k in keys]


def _seed_bits(seed: torch.Tensor) -> torch.Tensor:
    """uint32 values (int64) as their int32 bit patterns."""
    return torch.where(seed >= 2**31, seed - 2**32, seed).to(torch.int32)


def pack_state(state: dict, seed: torch.Tensor, bounce: torch.Tensor, chain: dict):
    """(F, I) from ``integrator``'s lane state dict, the seeds (uint32
    values as int64), the per-lane bounce and the chained loop's ``chain``
    dict (``integrator._chain_start``).  A state without NEE's ``pdf_w``
    and ``spec`` (a scene without emitters) packs zeros there."""
    f = [None] * len(F_KEYS)
    for name, keys in _STATE_VEC.items():
        for key, comp in zip(keys, state[name]):
            f[_F[key]] = comp
    for name, keys in _ACC_VEC.items():
        for key, comp in zip(keys, chain[name]):
            f[_F[key]] = comp
    zero = torch.zeros_like(state["t_min"])
    f[_F["t_min"]], f[_F["depth"]], f[_F["acc_depth"]] = (state["t_min"], state["depth"],
                                                           chain["depth"])
    f[_F["pdf_w"]] = state.get("pdf_w", zero)
    i = [state["alive"], _seed_bits(seed), bounce, chain["k"], chain["segs"], chain["done"],
         state.get("spec", zero)]
    return (torch.stack(f).contiguous(),
            torch.stack([t.to(torch.int32) for t in i]).contiguous())


def unpack_state(F: torch.Tensor, I: torch.Tensor) -> dict:
    """The inverse of ``pack_state``: {"state", "seed", "bounce", "chain"},
    the integer rows widened to int64 as ``integrator`` keeps them."""
    def vec3(keys):
        return Vec3(*rows(F, keys))

    state = {name: vec3(keys) for name, keys in _STATE_VEC.items()}
    state.update(t_min=F[_F["t_min"]], depth=F[_F["depth"]], alive=I[_I["alive"]] != 0,
                 pdf_w=F[_F["pdf_w"]], spec=I[_I["spec"]] != 0)
    chain = dict(k=I[_I["k"]].long(), segs=I[_I["segs"]].long(), done=I[_I["done"]] != 0,
                 color=vec3(_ACC_VEC["color"]), normal=vec3(_ACC_VEC["normal"]),
                 depth=F[_F["acc_depth"]])
    return dict(state=state, seed=I[_I["seed"]].long() & 0xFFFFFFFF,
                bounce=I[_I["bounce"]].long(), chain=chain)


class Tables(NamedTuple):
    """The kernels' constants (``TripPlan.tables``)."""

    table: torch.Tensor
    n_sph: int  # sphere objects
    mat_off: int  # offsets into ``table`` of the materials,
    obj_off: int  # the objects' materials,
    bg_off: int  # the background
    nee_off: int  # and the light tables
    cam: torch.Tensor


@dataclasses.dataclass
class TripPlan:
    """One render's trip loop: the scene, the camera, the band of lanes
    and the loop's settings.  ``chained``: the samples chain per lane
    (``spp`` samples from ``iteration``, the fold and restart in
    ``trip_tail``); else one sample, ``iteration``, traced to its end.
    ``shade``, ``finish``, ``resolve`` and ``fold`` are the body route's
    functions that the twins are assembled from, ``nee_kinds`` the kinds
    of NEE's terms (``integrator._trip_plan``)."""

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
    # shade(state, seed, bounce, ids, hit): ``_bounce_shade`` on that hit
    # record, (the state after it, the NEE terms)
    shade: Callable
    # finish(state, seed, bounce, nee): ``_bounce_finish``, NEE's sum (or
    # None) and roulette
    finish: Callable
    # resolve(terms, lits, like): ``_nee_resolve``, NEE's sum
    resolve: Callable
    # fold(state, state after the body, seed, bounce, chain):
    # ``_chain_step``, the next trip's (state, seed, bounce, chain)
    fold: Callable
    # the kinds of NEE's terms in ``integrator._nee_samples``'s order
    # (``NeeTerm.kind``; empty without emitters)
    nee_kinds: tuple

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
    def nee(self) -> bool:
        """The scene has emitters: the trip runs ``trip_nee`` and the
        tail's NEE mode."""
        return self.scene.has_nee

    @property
    def trips_bound(self) -> int:
        """Every lane is done within this many trips."""
        return self.spp * self.max_bounces if self.chained else self.max_bounces

    @functools.cached_property
    def sphere_rows(self) -> list:
        """(object, sphere primitive) of each sphere row of ``tables``, in
        the scene's object order."""
        sc = self.scene
        return [(o, p) for o, (k, p) in enumerate(zip(sc.s_obj_kind, sc.s_obj_prim))
                if k == OBJ_SPHERE]

    @functools.cached_property
    def tables(self) -> Tables:
        """The kernels' constants, built once per render on the scene's
        device.  ``table`` is float32: per sphere object in the scene's
        order a SPHERE_ROW row, per material a MAT_ROW row, each object's
        material, and bg_down, bg_up (ids and tags as floats, exact); with
        emitters, per sphere light a LIGHT_ROW row, the float32 1 / (number
        of sphere lights), the emissive triangles' total area and its clamp
        at 1e-30, their area CDF and a TRI_LIGHT_ROW row each.  ``cam``
        holds the viewport's width and height (rounded on the host, as
        ``camera.generate_rays`` rounds them) and the camera-to-world
        matrix's rows 0-2."""
        sc = self.scene
        dev = sc.device
        sph = self.sphere_rows
        parts = [torch.cat([sc.obj_inv_m[o, :3].reshape(12), sc.obj_m[o, :3].reshape(12),
                            sc.sphere_center[p], sc.sphere_radius[p].reshape(1),
                            torch.tensor([float(o)], device=dev)]) for o, p in sph]
        m = sc.materials
        mats = torch.cat([m.mat_type.float()[:, None], m.albedo, m.fuzz[:, None], m.ior[:, None],
                          m.emission], dim=1).reshape(-1)
        mat_off = SPHERE_ROW * len(sph)
        obj_off = mat_off + mats.shape[0]
        bg_off = obj_off + sc.obj_mat.shape[0]
        nee_off = bg_off + 6
        parts += [mats, sc.obj_mat.float(), sc.bg_down, sc.bg_up]
        nl, lt = len(sc.s_light_objs), sc.s_tri_light_count
        if nl:
            emis = m.emission[torch.tensor(sc.s_light_mats, device=dev)]
            objs = torch.tensor(sc.s_light_objs, dtype=torch.float32, device=dev)
            parts += [torch.cat([sc.nee_center[:nl], sc.nee_radius[:nl, None], emis, objs[:, None]],
                                dim=1).reshape(-1)]
        if self.nee:
            area = sc.tri_light_area.reshape(1)
            parts += [torch.tensor([1.0 / max(nl, 1)], dtype=torch.float32, device=dev), area,
                      torch.clamp(area, min=1e-30)]
        if lt:
            parts += [sc.tri_light_cum[:lt], sc.tri_light_pack[:lt].reshape(-1)]
        table = torch.cat(parts)
        vw, vh = viewport(self.camera, self.width, self.height)
        cam = torch.cat([torch.tensor([float(vw), float(vh)], device=dev),
                         self.camera.camera_matrix.to(dev)[:3].reshape(12)])
        return Tables(table.detach().float().contiguous(), len(sph), mat_off, obj_off, bg_off,
                      nee_off, cam.detach().float().contiguous())


@dataclasses.dataclass
class TripBuffers:
    """What one trip's kernels hand each other, allocated once a render:
    ``trip_head``'s sphere record (``hrec`` (HREC_ROWS, N) f32, ``hint``
    (N,) i32) and, for a scene with a mesh, the sweep's rows ((8, np, 256)
    f32, in ``packets._ROW_KEYS`` order) and live mask ((np, 256) bool);
    ``count`` (1,) i32, the lanes left after ``trip_tail``.  A dead lane's
    record and ray rows keep what they held (``trip_head``); they start at
    zero, so the sweep never reads memory no trip wrote.

    With emitters, what ``trip_nee`` hands the any-hit sweep and the tail,
    per NEE term t (``TripPlan.nee_kinds``): ``alive_next`` (N,) bool, the
    lanes alive after the body before roulette; ``nee_contrib`` (T, 3, N)
    f32, the term's contribution on the lanes no sphere occludes (elsewhere
    it keeps what it held); ``nee_mask`` (T * np, 256) bool, those lanes,
    term t in packets [t * np, (t + 1) * np); for a scene with a mesh
    ``nee_rows`` (8, T * np, 256) f32, the shadow rays packed as
    ``packets._pack_rows`` packs them with the window's end as the t cap
    (a lane outside the mask: its -BIG seed only)."""

    hrec: torch.Tensor
    hint: torch.Tensor
    rows: torch.Tensor | None
    act_p: torch.Tensor | None
    count: torch.Tensor
    alive_next: torch.Tensor | None = None
    nee_contrib: torch.Tensor | None = None
    nee_mask: torch.Tensor | None = None
    nee_rows: torch.Tensor | None = None

    @functools.cached_property
    def sweep_rows(self) -> dict:
        """The packed rows as ``treelet_closest_hit`` takes them (views)."""
        return dict(zip(_ROW_KEYS, self.rows.unbind(0)))

    @functools.cached_property
    def shadow_rows(self) -> dict:
        """Every NEE term's packed shadow rows as ``treelet_any_hit`` takes
        them (views)."""
        return dict(zip(_ROW_KEYS, self.nee_rows.unbind(0)))


def trip_buffers(plan: TripPlan) -> TripBuffers:
    dev, n = plan.scene.device, plan.n
    np_ = plan.n_pad // PACKET
    buf = TripBuffers(
        hrec=torch.zeros((HREC_ROWS, n), dtype=torch.float32, device=dev),
        hint=torch.zeros((n,), dtype=torch.int32, device=dev),
        rows=torch.zeros((len(_ROW_KEYS), np_, PACKET), dtype=torch.float32, device=dev)
        if plan.mesh else None,
        act_p=torch.zeros((np_, PACKET), dtype=torch.bool, device=dev) if plan.mesh else None,
        count=torch.zeros((1,), dtype=torch.int32, device=dev),
    )
    if plan.nee:
        t = len(plan.nee_kinds)
        buf.alive_next = torch.zeros((n,), dtype=torch.bool, device=dev)
        buf.nee_contrib = torch.zeros((t, 3, n), dtype=torch.float32, device=dev)
        buf.nee_mask = torch.zeros((t * np_, PACKET), dtype=torch.bool, device=dev)
        if plan.mesh:
            buf.nee_rows = torch.zeros((len(_ROW_KEYS), t * np_, PACKET), dtype=torch.float32,
                                       device=dev)
    return buf


# --- the twins ----------------------------------------------------------------

def _into_rows(plan: TripPlan, rows_buf, mask_buf, packed, act_p):
    """``packets._pack_rows``'s output into packed-row buffers as the
    kernels write them: live and pad lanes take every row, the others the
    -BIG seed only (their ray rows keep what they held)."""
    lane = torch.arange(plan.n_pad, device=act_p.device).view(act_p.shape)
    new = torch.stack([packed[k] for k in _ROW_KEYS])
    rows_buf.copy_(torch.where(act_p | (lane >= plan.n), new, rows_buf))
    rows_buf[-1] = new[-1]  # -BIG where not live
    mask_buf.copy_(act_p)


def trip_head_plain(plan: TripPlan, F, I, buf: TripBuffers) -> TripBuffers:
    """Torch twin of ``trip_head``: ``intersect._sphere_pass`` on the live
    lanes, its record into ``buf.hrec``/``buf.hint``, and
    ``packets._pack_rows`` seeded with its t into ``buf.rows``/``buf.act_p``
    (scenes with a mesh).  A dead lane's record and ray rows keep what
    they held; its seed t is -BIG and its mask False."""
    st = unpack_state(F, I)["state"]
    alive = st["alive"]
    t_best, kind, obj, _, point, normal, front, _ = _sphere_pass(
        plan.scene, st["ro"], st["rd"], st["t_min"], alive, *_blank_ids(plan.n, F.device))
    code = torch.where(kind == PRIM_SPHERE, obj * 2 + front.long(), -1)
    buf.hrec.copy_(torch.where(alive, torch.stack([t_best, *point, *normal]), buf.hrec))
    buf.hint.copy_(torch.where(alive, code, buf.hint))
    if plan.mesh:
        _into_rows(plan, buf.rows, buf.act_p,
                   *_pack_rows(st["ro"], st["rd"], st["t_min"], t_best, alive))
    return buf


def _trip_hit(plan: TripPlan, st, buf: TripBuffers, sweep):
    """The trip's hit record (``intersect.hit_record``): the sphere pass's
    from ``buf`` (the object and material from ``hint``), the sweep's
    winner where a triangle won.  Returns (ids, hit)."""
    scene, n = plan.scene, plan.n
    hint = buf.hint.long()
    on_sphere = hint >= 0
    obj = torch.where(on_sphere, hint >> 1, -1)
    mat = torch.where(on_sphere, scene.obj_mat[obj.clamp(min=0)].long(), 0)
    # the trip's sphere record keeps no primitive id: the forward body
    # reads none
    none = torch.full((n,), -1, dtype=torch.int64, device=hint.device)
    sphere = (buf.hrec[0], torch.where(on_sphere, PRIM_SPHERE, PRIM_NONE).to(torch.int32), obj,
              none, Vec3(*buf.hrec[1:4]), Vec3(*buf.hrec[4:7]), on_sphere & (hint & 1 == 1), mat)
    mesh = None
    if sweep is not None:
        t, slot, nx, ny, nz, sobj = (o.reshape(-1)[:n] for o in sweep)
        mesh = (t, slot, dict(nx=nx, ny=ny, nz=nz, obj=sobj))
    return hit_record(scene, st["ro"], st["rd"], sphere, mesh)


def trip_nee_plain(plan: TripPlan, F, I, buf: TripBuffers, sweep=None):
    """Torch twin of ``trip_nee``: the hit record from ``buf`` and the
    sweep's outputs, ``plan.shade`` (``integrator._bounce_shade``) on it,
    its state written into the live lanes of F and I and its alive into
    ``buf.alive_next``; per NEE term the lanes no sphere occludes
    (``intersect.sphere_occlusion``) into ``buf.nee_mask``, their
    contribution into ``buf.nee_contrib`` and, with a mesh, the term's
    shadow rays (``packets._pack_rows``) into ``buf.nee_rows``.  Returns
    (F, I)."""
    cur = unpack_state(F, I)
    st, seed, bounce = cur["state"], cur["seed"], cur["bounce"]
    alive = st["alive"]
    ids, hit = _trip_hit(plan, st, buf, sweep)
    out, terms = plan.shade(st, seed, bounce, ids, hit)
    F2, I2 = pack_state(dict(out, alive=alive), seed, bounce, cur["chain"])
    F.copy_(torch.where(alive, F2, F))
    I.copy_(torch.where(alive, I2, I))
    buf.alive_next.copy_(torch.where(alive, out["alive"], buf.alive_next))
    np_ = plan.n_pad // PACKET
    for t, term in enumerate(terms):
        t_min = torch.full_like(term.t_limit, 1e-4)
        open_ = term.active & ~sphere_occlusion(plan.scene, term.p, term.direction, t_min,
                                                term.t_limit, term.active, term.light)
        buf.nee_contrib[t].copy_(torch.where(open_, torch.stack(list(term.contrib)),
                                             buf.nee_contrib[t]))
        packed, act_p = _pack_rows(term.p, term.direction, t_min, term.t_limit, open_)
        region = slice(t * np_, (t + 1) * np_)
        if plan.mesh:
            _into_rows(plan, buf.nee_rows[:, region], buf.nee_mask[region], packed, act_p)
        else:
            buf.nee_mask[region].copy_(act_p)
    return F, I


def trip_tail_plain(plan: TripPlan, F, I, buf: TripBuffers, sweep=None, occ=None):
    """Torch twin of ``trip_tail``.  Without emitters: the hit record from
    ``buf`` and the sweep's outputs (``intersect.hit_record``), then
    ``plan.shade`` and ``plan.finish`` (``integrator._bounce_body``'s two
    halves) on it.  In the NEE mode, on the state ``trip_nee`` left: each
    term lit where ``buf.nee_mask`` holds and the any-hit sweep's ``occ``
    (its (T * np, 256) output; None without a mesh) does not,
    ``plan.resolve`` (``integrator._nee_resolve``) of the lit terms and
    ``plan.finish``.  Then, chained, ``plan.fold``
    (``integrator._chain_step``); F and I updated in place, the lanes left
    to trace into ``buf.count``.  Returns (F, I)."""
    cur = unpack_state(F, I)
    st, seed, bounce, chain = cur["state"], cur["seed"], cur["bounce"], cur["chain"]
    if plan.nee:
        n = plan.n
        lit = buf.nee_mask if occ is None else buf.nee_mask & ~occ
        lits = lit.reshape(len(plan.nee_kinds), -1)[:, :n]
        terms = [types.SimpleNamespace(kind=k, contrib=Vec3(*buf.nee_contrib[t]))
                 for t, k in enumerate(plan.nee_kinds)]
        out = dict(st, alive=st["alive"] & buf.alive_next)
        st2 = plan.finish(out, seed, bounce, plan.resolve(terms, lits.unbind(0), st["t_min"]))
    else:
        ids, hit = _trip_hit(plan, st, buf, sweep)
        st2 = plan.finish(plan.shade(st, seed, bounce, ids, hit)[0], seed, bounce, None)
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
    """The checks every trip kernel makes of its inputs; returns the
    library."""
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
    tabs = plan.tables
    tensors = [F, I, buf.hrec, buf.hint, buf.count, tabs.table, tabs.cam]
    np_ = plan.n_pad // PACKET
    if plan.mesh:
        req(buf.rows is not None and tuple(buf.rows.shape) == (len(_ROW_KEYS), np_, PACKET)
            and buf.rows.dtype == torch.float32, f"{name}: rows must be (8, {np_}, 256) float32")
        req(tuple(buf.act_p.shape) == (np_, PACKET) and buf.act_p.dtype == torch.bool,
            f"{name}: act_p must be ({np_}, 256) bool")
        tensors += [buf.rows, buf.act_p]
    if plan.nee:
        t = len(plan.nee_kinds)
        req(buf.alive_next is not None and tuple(buf.alive_next.shape) == (n,)
            and buf.alive_next.dtype == torch.bool, f"{name}: alive_next must be ({n},) bool")
        req(buf.nee_contrib is not None and tuple(buf.nee_contrib.shape) == (t, 3, n)
            and buf.nee_contrib.dtype == torch.float32,
            f"{name}: nee_contrib must be ({t}, 3, {n}) float32")
        req(buf.nee_mask is not None and tuple(buf.nee_mask.shape) == (t * np_, PACKET)
            and buf.nee_mask.dtype == torch.bool, f"{name}: nee_mask must be ({t * np_}, 256) bool")
        tensors += [buf.alive_next, buf.nee_contrib, buf.nee_mask]
        if plan.mesh:
            req(buf.nee_rows is not None
                and tuple(buf.nee_rows.shape) == (len(_ROW_KEYS), t * np_, PACKET)
                and buf.nee_rows.dtype == torch.float32,
                f"{name}: nee_rows must be (8, {t * np_}, 256) float32")
            tensors.append(buf.nee_rows)
    for x in tensors:
        req(x.device == dev and x.is_contiguous(),
            f"{name}: every input must be contiguous on {dev}")
    req(plan.pix0 + n <= 2**31, f"{name}: pixel index past int32")
    return kernels.load()


def _sweep_ptrs(name, plan: TripPlan, F, sweep):
    """The closest-hit sweep's six outputs as the kernels take them (None
    for a scene without meshes)."""
    kernels.require((sweep is not None) == plan.mesh,
                    f"{name}: the sweep's outputs go with a scene that has a mesh")
    if sweep is None:
        return [None] * 6
    kernels.require(
        len(sweep) == 6 and all(o.device == F.device and o.is_contiguous()
                                and o.numel() == plan.n_pad for o in sweep)
        and sweep[1].dtype == torch.int32
        and all(sweep[j].dtype == torch.float32 for j in (0, 2, 3, 4, 5)),
        f"{name}: sweep must be treelet_closest_hit's (t, slot, nx, ny, nz, obj)")
    return [o.data_ptr() for o in sweep]


def trip_head(plan: TripPlan, F, I, buf: TripBuffers) -> TripBuffers:
    """The sphere pass and the sweep's rows for the lane state (F, I):
    writes ``buf.hrec``, ``buf.hint`` and, for a scene with a mesh,
    ``buf.rows`` and ``buf.act_p``.  Launches are counted in
    ``LAUNCHES["trip_head"]``."""
    if F.device.type == "cpu":
        return trip_head_plain(plan, F, I, buf)
    lib = _check("trip_head", plan, F, I, buf)
    tabs = plan.tables
    if plan.n:
        err = lib.tpupt_trip_head(
            F.data_ptr(), I.data_ptr(), plan.n, plan.n_pad, tabs.table.data_ptr(), tabs.n_sph,
            buf.hrec.data_ptr(), buf.hint.data_ptr(),
            buf.rows.data_ptr() if plan.mesh else None,
            buf.act_p.data_ptr() if plan.mesh else None, kernels.stream_of(F))
        kernels.check(lib, err, "trip_head")
        LAUNCHES["trip_head"] += 1
    return buf


def trip_nee(plan: TripPlan, F, I, buf: TripBuffers, sweep=None):
    """The body of a trip of a scene with emitters up to NEE's shadow
    rays, for the lane state (F, I), updated in place on the live lanes:
    the hit record from ``buf`` and ``sweep`` (``treelet_closest_hit``'s
    six outputs on ``buf``'s rows, None for a scene without meshes),
    background, the first hit's normal and depth, shading, the
    MIS-weighted emission and NEE's terms with their sphere tests; writes
    ``buf.alive_next``, ``buf.nee_contrib``, ``buf.nee_mask`` and, with a
    mesh, ``buf.nee_rows``.  Returns (F, I).  Launches are counted in
    ``LAUNCHES["trip_nee"]``."""
    if F.device.type == "cpu":
        return trip_nee_plain(plan, F, I, buf, sweep)
    lib = _check("trip_nee", plan, F, I, buf)
    kernels.require(plan.nee, "trip_nee: the scene has no emitter")
    ptrs = _sweep_ptrs("trip_nee", plan, F, sweep)
    tabs = plan.tables
    if plan.n:
        err = lib.tpupt_trip_nee(
            F.data_ptr(), I.data_ptr(), plan.n, plan.n_pad, buf.hrec.data_ptr(),
            buf.hint.data_ptr(), *ptrs, tabs.table.data_ptr(), tabs.n_sph, tabs.mat_off,
            tabs.obj_off, tabs.bg_off, tabs.nee_off, len(plan.scene.s_light_objs),
            plan.scene.s_tri_light_count, buf.alive_next.data_ptr(), buf.nee_contrib.data_ptr(),
            buf.nee_mask.data_ptr(), buf.nee_rows.data_ptr() if plan.mesh else None,
            kernels.stream_of(F))
        kernels.check(lib, err, "trip_nee")
        LAUNCHES["trip_nee"] += 1
    return F, I


def trip_tail(plan: TripPlan, F, I, buf: TripBuffers, sweep=None, occ=None):
    """The rest of the trip for the lane state (F, I), updated in place,
    and the lanes left to trace into ``buf.count``.  Without emitters: the
    hit record from ``buf`` and ``sweep`` (``treelet_closest_hit``'s six
    outputs on ``buf``'s rows, None for a scene without meshes), the body.
    With emitters (the NEE mode, after ``trip_nee``): the lit terms from
    ``buf`` and ``occ`` (``treelet_any_hit``'s output on ``buf.nee_rows``,
    None for a scene without meshes) added to the radiance, roulette.
    Then, chained, the fold and restart.  Returns (F, I).  Launches are
    counted in ``LAUNCHES["trip_tail"]``."""
    if F.device.type == "cpu":
        return trip_tail_plain(plan, F, I, buf, sweep, occ)
    lib = _check("trip_tail", plan, F, I, buf)
    tabs = plan.tables
    if plan.nee:
        kernels.require(sweep is None, "trip_tail: in the NEE mode trip_nee takes the sweep")
        kernels.require((occ is not None) == plan.mesh,
                        "trip_tail: occ (the any-hit sweep's output) goes with a mesh")
        if occ is not None:
            kernels.require(occ.dtype == torch.bool and occ.shape == buf.nee_mask.shape
                            and occ.device == F.device and occ.is_contiguous(),
                            "trip_tail: occ must be treelet_any_hit's output on buf.nee_rows")
        ptrs = [None] * 6
        nee = [buf.alive_next.data_ptr(), buf.nee_contrib.data_ptr(), buf.nee_mask.data_ptr(),
               occ.data_ptr() if occ is not None else None]
    else:
        kernels.require(occ is None, "trip_tail: occ goes with a scene that has emitters")
        ptrs = _sweep_ptrs("trip_tail", plan, F, sweep)
        nee = [None] * 4
    rr = _NO_RR if plan.rr_start is None else int(plan.rr_start)
    if plan.n:
        err = lib.tpupt_trip_tail(
            F.data_ptr(), I.data_ptr(), plan.n, buf.hrec.data_ptr(), buf.hint.data_ptr(), *ptrs,
            tabs.table.data_ptr(), tabs.mat_off, tabs.obj_off, tabs.bg_off, tabs.cam.data_ptr(),
            plan.pix0, plan.width, plan.height, plan.iteration, plan.spp, plan.max_bounces, rr,
            int(plan.chained), plan.n_pad, len(plan.scene.s_light_objs),
            plan.scene.s_tri_light_count, *nee, buf.count.data_ptr(), kernels.stream_of(F))
        kernels.check(lib, err, "trip_tail")
        LAUNCHES["trip_tail"] += 1
    else:
        buf.count.zero_()
    return F, I


def launch_counts() -> dict[str, int]:
    """Kernel launches so far in this process."""
    return dict(LAUNCHES)
