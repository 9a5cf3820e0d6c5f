"""Plain PyTorch reference of the path tracer that the benchmark measures.

It reads a scene in the upstream CUDA path tracer's JSON schema and the
Wavefront OBJ files it names, and renders it with the semantics the
program under test states: a pinhole camera with jittered primary rays,
lambertian, metal, dielectric and emissive materials, a sky gradient,
next-event estimation with multiple importance sampling toward emissive
triangles, progressive averaging of samples, and a counter-based Wang-hash
RNG keyed on (pixel, sample, bounce, draw).  Closest hits are found by
brute force over every sphere and every triangle; nothing is accelerated
beyond a conservative box test per mesh instance.  Each float operation
runs in the order of the integrator's documented formulas, so that the
two agree bit for bit except where a ray meets two primitives at exactly
the same distance.

Every pixel's samples are independent, so ``render_forward`` traces any
set of pixels, in blocks, one sample at a time; ``render_grad`` takes the
gradient of sum(color^2) block by block and adds the blocks' gradients.
This module imports only torch, numpy and the standard library.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field

import numpy as np
import torch

BIG_T = 3.0e38
MOLLER_EPS = 1e-7
T_MIN_PRIMARY = 1e-4
INV_PI = 0.3183098861837907
TWO_PI = 6.283185307179586
MAT_DIFFUSE, MAT_METAL, MAT_DIELECTRIC, MAT_EMISSIVE = 0, 1, 2, 3
KIND_NONE, KIND_SPHERE, KIND_TRIANGLE = -1, 0, 1
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_TRI_CHUNK = 1 << 25  # ray x triangle pairs per brute-force chunk


# --- vectors -------------------------------------------------------------------

class V3(tuple):
    """Three (N,) tensors, component by component."""

    def __new__(cls, x, y, z):
        return tuple.__new__(cls, (x, y, z))

    x = property(lambda s: s[0])
    y = property(lambda s: s[1])
    z = property(lambda s: s[2])

    def __add__(self, o):
        return V3(self[0] + o[0], self[1] + o[1], self[2] + o[2]) if isinstance(o, V3) \
            else V3(self[0] + o, self[1] + o, self[2] + o)

    def __sub__(self, o):
        return V3(self[0] - o[0], self[1] - o[1], self[2] - o[2]) if isinstance(o, V3) \
            else V3(self[0] - o, self[1] - o, self[2] - o)

    def __mul__(self, o):
        return V3(self[0] * o[0], self[1] * o[1], self[2] * o[2]) if isinstance(o, V3) \
            else V3(self[0] * o, self[1] * o, self[2] * o)

    def __neg__(self):
        return V3(-self[0], -self[1], -self[2])

    def dot(self, o):
        return self[0] * o[0] + self[1] * o[1] + self[2] * o[2]

    def cross(self, o):
        return V3(self[1] * o[2] - self[2] * o[1], self[2] * o[0] - self[0] * o[2],
                  self[0] * o[1] - self[1] * o[0])

    def length(self):
        return torch.sqrt(torch.clamp(self.dot(self), min=1e-30))

    def normalize(self):
        return self * torch.rsqrt(torch.clamp(self.dot(self), min=1e-12))

    def take(self, idx):
        return V3(gather(self[0], idx), gather(self[1], idx), gather(self[2], idx))

    def stack(self):
        return torch.stack(list(self), dim=-1)


def rows(table, idx):
    """``table[idx]`` for a table of a few rows: each row selected where
    the index is its own, so the backward pass is a dense reduction over
    the lanes (the backward of indexing sums each row's many duplicates
    one after another)."""
    if table.shape[0] > 64:
        return gather(table, idx)
    out = None
    for r in range(table.shape[0]):
        sel = (idx == r) if table.dim() == 1 else (idx == r)[:, None]
        out = torch.where(sel, table[r], 0.0 if out is None else out)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.shape = src.shape
        return src[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        out = g.new_zeros(ctx.shape)
        out.index_add_(0, idx, g)
        return out, None


def gather(src, idx):
    """``src[idx]``, its backward an ``index_add_``."""
    return _Gather.apply(src, idx)


def vwhere(mask, a: V3, b: V3) -> V3:
    return V3(torch.where(mask, a[0], b[0]), torch.where(mask, a[1], b[1]),
              torch.where(mask, a[2], b[2]))


def xform_point(m, v: V3) -> V3:
    return V3(m[..., 0, 0] * v[0] + m[..., 0, 1] * v[1] + m[..., 0, 2] * v[2] + m[..., 0, 3],
              m[..., 1, 0] * v[0] + m[..., 1, 1] * v[1] + m[..., 1, 2] * v[2] + m[..., 1, 3],
              m[..., 2, 0] * v[0] + m[..., 2, 1] * v[1] + m[..., 2, 2] * v[2] + m[..., 2, 3])


def xform_vector(m, v: V3) -> V3:
    return V3(m[..., 0, 0] * v[0] + m[..., 0, 1] * v[1] + m[..., 0, 2] * v[2],
              m[..., 1, 0] * v[0] + m[..., 1, 1] * v[1] + m[..., 1, 2] * v[2],
              m[..., 2, 0] * v[0] + m[..., 2, 1] * v[1] + m[..., 2, 2] * v[2])


def xform_normal(inv_m, n: V3) -> V3:
    return V3(inv_m[..., 0, 0] * n[0] + inv_m[..., 1, 0] * n[1] + inv_m[..., 2, 0] * n[2],
              inv_m[..., 0, 1] * n[0] + inv_m[..., 1, 1] * n[1] + inv_m[..., 2, 1] * n[2],
              inv_m[..., 0, 2] * n[0] + inv_m[..., 1, 2] * n[1] + inv_m[..., 2, 2] * n[2])


def reflect(d: V3, n: V3) -> V3:
    return d - n * (2.0 * d.dot(n))


def refract(uv: V3, n: V3, eta) -> V3:
    cos_theta = torch.clamp((-uv).dot(n), max=1.0)
    perp = (uv + n * cos_theta) * eta
    k = 1.0 - perp.dot(perp)
    return perp + n * (-torch.sqrt(torch.clamp(k, min=1e-12)))


# --- random numbers ------------------------------------------------------------

def _u32(a):
    return a.to(torch.int64) & _M32 if isinstance(a, torch.Tensor) else int(a) & _M32


def _mul32(a, b: int):
    return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & _M32


def wang_hash(a):
    a = _u32(a)
    a = (((a + 0x7ED55D16) & _M32) + ((a << 12) & _M32)) & _M32
    a = ((a ^ 0xC761C23C) ^ (a >> 19)) & _M32
    a = (((a + 0x165667B1) & _M32) + ((a << 5) & _M32)) & _M32
    a = (((a + 0xD3A2646C) & _M32) ^ ((a << 9) & _M32)) & _M32
    a = (((a + 0xFD7046C5) & _M32) + ((a << 3) & _M32)) & _M32
    return ((a ^ 0xB55A4F09) ^ (a >> 16)) & _M32


def pixel_seed(pix, iteration):
    return wang_hash(wang_hash(pix) ^ _u32(iteration))


def uniform(seed, counter):
    """U[0, 1): draw ``counter`` of the stream ``seed``."""
    bits = wang_hash(seed + _mul32(_u32(counter), _GOLDEN))
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def draw(seed, bounce: int, lane: int):
    """Bounce draws: lanes 0, 1 the scatter's sphere point, 2 the Fresnel
    choice, 3 roulette, 12-14 the emissive-triangle sample."""
    return uniform(seed, 2 + bounce * 16 + lane)


# --- the scene -----------------------------------------------------------------

def _mat_translate(t):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(t, np.float32)
    return m


def _mat_scale(s):
    s = np.broadcast_to(np.asarray(s, np.float32), (3,))
    return np.diag(np.concatenate([s, np.ones((1,), np.float32)]))


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / max(float(np.linalg.norm(v)), 1e-30)


def _mat_rotate(angle, axis):
    x, y, z = _unit(axis)
    c, s = np.cos(angle), np.sin(angle)
    C = 1.0 - c
    return np.array([[c + x * x * C, x * y * C - z * s, x * z * C + y * s, 0.0],
                     [y * x * C + z * s, c + y * y * C, y * z * C - x * s, 0.0],
                     [z * x * C - y * s, z * y * C + x * s, c + z * z * C, 0.0],
                     [0.0, 0.0, 0.0, 1.0]], dtype=np.float32)


def _mat_look_at(frm, at, up):
    frm = np.asarray(frm, np.float64)
    d = _unit(frm - np.asarray(at, np.float64))
    left = _unit(np.cross(np.asarray(up, np.float64), d))
    new_up = _unit(np.cross(d, left))
    m = np.stack([left, new_up, d, frm], axis=1)
    return np.concatenate([m, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0).astype(np.float32)


def _command(j):
    if "translate" in j:
        return _mat_translate(j["translate"]).astype(np.float64)
    if "o" in j or "origin" in j:
        return _mat_translate(j.get("o", j.get("origin"))).astype(np.float64)
    if "scale" in j:
        return _mat_scale(j["scale"]).astype(np.float64)
    if "rotate" in j:
        return _mat_rotate(math.radians(float(j["rotate"])), j["axis"]).astype(np.float64)
    if "from" in j and "at" in j and "up" in j:
        return _mat_look_at(j["from"], j["at"], j["up"]).astype(np.float64)
    raise ValueError(f"unknown transform command {j}")


def parse_transform(j) -> np.ndarray:
    """An object is one command; a list composes left-multiplied."""
    if isinstance(j, dict):
        return _command(j)
    m = np.eye(4)
    for elem in j:
        m = _command(elem) @ m
    return m


def read_obj(path):
    """(positions (V, 3) float32, triangles (T, 3) int64) of an OBJ file,
    faces fan-triangulated, negative indices counted from the end."""
    pos, tris = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                p = line.split()
                pos.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(pos) + i)
                tris += [(idx[0], idx[k], idx[k + 1]) for k in range(1, len(idx) - 1)]
    return np.asarray(pos, np.float32), np.asarray(tris, np.int64)


@dataclass
class Scene:
    """What the reference renders, on one device.  ``leaves`` are the
    differentiable parameters in the program's layout: sphere_center
    (S, 3), sphere_radius (S,), positions (V, 3) of every mesh in order of
    first use, bg_down, bg_up, and per material albedo, fuzz, ior,
    emission."""

    device: torch.device
    leaves: dict
    mat_type: torch.Tensor
    obj_mat: list
    obj_kind: list  # "sphere" | "mesh" per object, in file order
    obj_prim: list  # the sphere's row or the mesh's index
    obj_m: torch.Tensor  # (O, 4, 4) float32
    obj_inv: torch.Tensor
    mesh_vrange: list  # per mesh (first vertex, vertex count)
    mesh_tris: list  # per mesh (T, 3) int64 vertex ids into its own vertices
    inst: list = field(default_factory=list)  # per mesh object: dict of its world triangles
    light: dict | None = None  # emissive triangles: pack (Lt, 11), cum (Lt,), area ()
    cam_m: torch.Tensor | None = None
    vfov: float = 0.0

    @property
    def has_nee(self) -> bool:
        return self.light is not None


def _world_f64(positions, m):
    return (positions @ np.asarray(m, np.float64)[:3, :3].T + np.asarray(m, np.float64)[:3, 3])


def load_scene(scene_path: str, device) -> Scene:
    """Parse the scene JSON and its OBJ files (paths relative to the
    JSON).  The "background" key is ignored, as upstream."""
    with open(scene_path) as fh:
        j = json.load(fh)
    base = os.path.dirname(os.path.abspath(scene_path))
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    mats = {}
    mtype, albedo, fuzz, ior, emit = [], [], [], [], []
    for m in j["materials"]:
        mats[m["name"]] = len(mats)
        t = m["type"]
        emit.append(m.get("emit", (0.0, 0.0, 0.0)) if t == "diffuse_light" else (0.0, 0.0, 0.0))
        if t == "lambertian":
            mtype.append(MAT_DIFFUSE), albedo.append(m["albedo"]), fuzz.append(0.0), ior.append(1.0)
        elif t == "metal":
            mtype.append(MAT_METAL), albedo.append(m["albedo"])
            fuzz.append(float(m["fuzz"])), ior.append(1.0)
        elif t == "dielectric":
            mtype.append(MAT_DIELECTRIC), albedo.append((1.0, 1.0, 1.0))
            fuzz.append(0.0), ior.append(float(m["refraction_index"]))
        elif t == "diffuse_light":
            mtype.append(MAT_EMISSIVE), albedo.append((0.0, 0.0, 0.0)), fuzz.append(0.0)
            ior.append(1.0)
        else:
            raise ValueError(f"material type {t}")

    mesh_ids, mesh_pos, mesh_tris = {}, [], []
    obj_kind, obj_prim, obj_mat, obj_m = [], [], [], []
    centers, radii = [], []
    for s in j["surfaces"]:
        m = parse_transform(s["transform"])
        obj_mat.append(mats[s["material"]])
        obj_m.append(m)
        if s["type"] == "sphere":
            obj_kind.append("sphere")
            obj_prim.append(len(centers))
            centers.append((0.0, 0.0, 0.0))
            radii.append(float(s["radius"]))
        elif s["type"] == "mesh":
            path = os.path.normpath(os.path.join(base, s["filename"]))
            if path not in mesh_ids:
                mesh_ids[path] = len(mesh_pos)
                p, t = read_obj(path)
                mesh_pos.append(p)
                mesh_tris.append(t)
            obj_kind.append("mesh")
            obj_prim.append(mesh_ids[path])
        else:
            raise ValueError(f"surface type {s['type']}")
    if not centers:
        centers, radii = [(1e9, 1e9, 1e9)], [0.0]
    vrange, v0 = [], 0
    for p in mesh_pos:
        vrange.append((v0, p.shape[0]))
        v0 += p.shape[0]
    positions = np.concatenate(mesh_pos) if mesh_pos else np.full((3, 3), 1e9, np.float32)

    def leaf(a):
        return f32(a).requires_grad_(False)

    leaves = dict(sphere_center=leaf(centers), sphere_radius=leaf(radii), positions=leaf(positions),
                  bg_down=leaf((0.5, 0.7, 1.0)), bg_up=leaf((1.0, 1.0, 1.0)),
                  albedo=leaf(albedo), fuzz=leaf(fuzz), ior=leaf(ior), emission=leaf(emit))
    cam = j["camera"]
    vfov = float(np.float32(math.radians(float(cam["vfov"]))))
    cam_m = (parse_transform(cam["transform"]) if "transform" in cam else np.eye(4))
    scene = Scene(device=torch.device(device), leaves=leaves,
                  mat_type=torch.tensor(mtype, dtype=torch.int64, device=device), obj_mat=obj_mat,
                  obj_kind=obj_kind, obj_prim=obj_prim, obj_m=f32(obj_m),
                  obj_inv=f32([np.linalg.inv(m) for m in obj_m]), mesh_vrange=vrange,
                  mesh_tris=[torch.tensor(t, device=device) for t in mesh_tris],
                  cam_m=f32(cam_m), vfov=vfov)

    # each mesh object's world triangles as the forward pass traces them:
    # world vertices in float64 rounded to float32, edges and the normal's
    # cross product in float32
    lights = []
    for o, kind in enumerate(obj_kind):
        if kind != "mesh":
            continue
        k = obj_prim[o]
        v = _world_f64(mesh_pos[k], obj_m[o]).astype(np.float32)[mesh_tris[k]]
        p0, e1, e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
        cn = np.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                       e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                       e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], axis=1)
        flat = v.reshape(-1, 3)
        span = np.maximum(np.abs(flat).max(axis=0), 1.0) * 1e-4
        scene.inst.append(dict(
            obj=o, mesh=k, p0=V3(*f32(p0).T), e1=V3(*f32(e1).T), e2=V3(*f32(e2).T),
            cn=V3(*f32(cn).T), lo=f32(flat.min(axis=0) - span), hi=f32(flat.max(axis=0) + span)))
        if mtype[obj_mat[o]] == MAT_EMISSIVE:
            w = _world_f64(mesh_pos[k].astype(np.float64), obj_m[o])[mesh_tris[k]]
            le1, le2 = w[:, 1] - w[:, 0], w[:, 2] - w[:, 0]
            area = 0.5 * np.linalg.norm(np.cross(le1, le2), axis=1)
            rows = np.concatenate([w[:, 0], le1, le2, np.full((len(w), 1), float(o)),
                                   np.full((len(w), 1), float(obj_mat[o]))], axis=1)
            lights.append((rows, area))
    if any(mtype[obj_mat[o]] == MAT_EMISSIVE for o, k in enumerate(obj_kind) if k == "sphere"):
        raise NotImplementedError("sphere lights are not in this reference")
    if lights:
        rows = np.concatenate([r for r, _ in lights]).astype(np.float32)
        area = np.concatenate([a for _, a in lights]).astype(np.float64)
        total = float(area.sum())
        scene.light = dict(pack=f32(rows), cum=f32((np.cumsum(area) / max(total, 1e-30))),
                           area=f32(total))
    return scene


def tie_vertices(scene: Scene, tie_tris) -> torch.Tensor:
    """The rows of the positions leaf that the tied triangles use."""
    out = [torch.zeros(0, dtype=torch.int64, device=scene.device)]
    for obj, idx in tie_tris:
        k = scene.obj_prim[obj]
        out.append(scene.mesh_tris[k][idx].reshape(-1) + scene.mesh_vrange[k][0])
    return torch.unique(torch.cat(out))


def params(scene: Scene) -> dict:
    """Fresh leaves that require grad, in the program's layout."""
    return {k: v.detach().clone().requires_grad_(True) for k, v in scene.leaves.items()}


# --- camera --------------------------------------------------------------------

def primary(scene: Scene, width, height, pix, iteration):
    """Jittered primary rays of pixels ``pix`` for sample ``iteration``:
    (origin, unit direction, the sample's RNG seed)."""
    dev = pix.device
    seed = pixel_seed(pix, iteration)
    fx = (pix % width).to(torch.float32) + uniform(seed, 0)
    fy = (pix // width).to(torch.float32) + uniform(seed, 1)
    vfov = np.float32(scene.vfov)
    aspect = np.float32(width / height)
    vh = np.float32(2.0) * np.tan(vfov / np.float32(2.0))
    vw = aspect * vh
    u = fx / torch.tensor(width - 1, dtype=torch.float32, device=dev)
    v = (float(height) - fy) / torch.tensor(height - 1, dtype=torch.float32, device=dev)
    d = V3((u - 0.5) * float(vw), (v - 0.5) * float(vh), torch.full_like(u, -1.0))
    m = scene.cam_m
    rd = xform_vector(m, d).normalize()
    ones = torch.ones_like(u)
    return V3(m[0, 3] * ones, m[1, 3] * ones, m[2, 3] * ones), rd, seed


# --- intersection --------------------------------------------------------------

def _sphere_roots(scene: Scene, lv, o, ro, rd, t_min, t_bound):
    inv = scene.obj_inv[o]
    c = lv["sphere_center"][scene.obj_prim[o]]
    center = V3(c[0], c[1], c[2])
    radius = lv["sphere_radius"][scene.obj_prim[o]]
    oo = xform_point(inv, ro)
    od = xform_vector(inv, rd).normalize()
    oc = oo - center
    a = od.dot(od)
    b = 2.0 * od.dot(oc)
    cc = oc.dot(oc) - radius * radius
    disc = b * b - 4.0 * a * cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    use1 = (t1 >= t_min) & (t1 <= t_bound)
    use2 = (t2 >= t_min) & (t2 <= t_bound)
    return (disc >= 0.0) & (use1 | use2), torch.where(use1, t1, t2), oo, od, center, radius


def _mt(p0, e1, e2, ro, rd, t_min, t_cap):
    """Moller-Trumbore over ray rows (r, 1) and triangle columns (1, T)."""
    hx = rd[1] * e2[2] - rd[2] * e2[1]
    hy = rd[2] * e2[0] - rd[0] * e2[2]
    hz = rd[0] * e2[1] - rd[1] * e2[0]
    a = e1[0] * hx + e1[1] * hy + e1[2] * hz
    f = 1.0 / torch.where(a.abs() < MOLLER_EPS, 1.0, a)
    sx, sy, sz = ro[0] - p0[0], ro[1] - p0[1], ro[2] - p0[2]
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1[2] - sz * e1[1]
    qy = sz * e1[0] - sx * e1[2]
    qz = sx * e1[1] - sy * e1[0]
    v = f * (rd[0] * qx + rd[1] * qy + rd[2] * qz)
    t = f * (e2[0] * qx + e2[1] * qy + e2[2] * qz)
    ok = ((a.abs() >= MOLLER_EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= t_min) & (t <= t_cap))
    return ok, t


def _box_hit(lo, hi, ro, rd, t_min, t_cap):
    """Rays whose slab test meets the (widened) box within their window."""
    near, far = None, None
    for a in range(3):
        inv = 1.0 / rd[a]
        t0, t1 = (lo[a] - ro[a]) * inv, (hi[a] - ro[a]) * inv
        n_, f_ = torch.minimum(t0, t1), torch.maximum(t0, t1)
        near = n_ if near is None else torch.maximum(near, n_)
        far = f_ if far is None else torch.minimum(far, f_)
    # a NaN slab (a ray on a box plane) keeps the ray
    return ~((far < near) | (far < t_min) | (near > t_cap))


def mesh_closest(tris, ro, rd, t_min, t_cap, active, ties=None, tie_tris=None):
    """Brute force over one instance's triangles ``tris`` (V3s of (T,)):
    (hit mask, t, winner index).  A triangle hits at t <= t_cap, so it
    wins an equal t against ``t_cap``.  ``ties`` (bool (N,)), when given,
    gains the lanes whose best t two triangles share, and ``tie_tris`` (a
    list) those triangles, as (object, indices)."""
    n = ro[0].shape[0]
    best_t = torch.full((n,), BIG_T, device=ro[0].device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=ro[0].device)
    lanes = torch.nonzero(active & _box_hit(tris["lo"], tris["hi"], ro, rd, t_min, t_cap)
                          ).reshape(-1)
    if lanes.numel() == 0:
        return best_i >= 0, best_t, best_i
    T = tris["p0"][0].shape[0]
    cols = [c[None, :] for c in (*tris["p0"], *tris["e1"], *tris["e2"])]
    step = max(1, _TRI_CHUNK // T)
    for c0 in range(0, lanes.numel(), step):
        li = lanes[c0:c0 + step]
        r_o = V3(*(c[li][:, None] for c in ro))
        r_d = V3(*(c[li][:, None] for c in rd))
        ok, t = _mt(cols[0:3], cols[3:6], cols[6:9], r_o, r_d, t_min[li][:, None],
                    t_cap[li][:, None])
        tm = torch.where(ok, t, BIG_T)
        bt, bi = tm.min(dim=1)
        got = ok.any(dim=1)
        best_t[li] = torch.where(got, bt, BIG_T)
        best_i[li] = torch.where(got, bi, -1)
        if ties is not None:
            tied = got & ((tm == bt[:, None]).sum(dim=1) > 1)
            ties[li] |= tied
            if tie_tris is not None and bool(tied.any()):
                tie_tris.append((tris["obj"], torch.nonzero(tm[tied] == bt[tied][:, None])[:, 1]))
    return best_i >= 0, best_t, best_i


def closest_hit(scene: Scene, lv, ro, rd, t_min, active, world, ties=None, tie_tris=None):
    """The closest hit over every sphere, then every mesh object, each
    later object replacing an equal t.  ``world`` holds each mesh
    object's triangles.  Returns a dict: kind, obj, prim (the sphere's row
    or the triangle's index in its mesh), t, and for the forward record
    point, normal, front, mat."""
    n = ro[0].shape[0]
    dev = ro[0].device
    t_best = torch.full((n,), BIG_T, device=dev)
    kind = torch.full((n,), KIND_NONE, dtype=torch.int64, device=dev)
    obj = torch.full((n,), -1, dtype=torch.int64, device=dev)
    prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    z = torch.zeros((n,), device=dev)
    point, normal = V3(z, z, z), V3(z, z, z)
    front = torch.zeros((n,), dtype=torch.bool, device=dev)
    with torch.no_grad():
        for o, k in enumerate(scene.obj_kind):
            if k != "sphere":
                continue
            hit, t_obj, oo, od, center, radius = _sphere_roots(scene, lv, o, ro, rd, t_min, t_best)
            pt_obj = oo + od * t_obj
            pw = xform_point(scene.obj_m[o], pt_obj)
            t_w = (pw - ro).length()
            outward = (pt_obj - center) * (1.0 / radius)
            fr = od.dot(outward) < 0.0
            nw = xform_normal(scene.obj_inv[o], vwhere(fr, outward, -outward))
            take = active & hit
            t_best = torch.where(take, t_w, t_best)
            kind = torch.where(take, KIND_SPHERE, kind)
            obj = torch.where(take, o, obj)
            prim = torch.where(take, scene.obj_prim[o], prim)
            point, normal = vwhere(take, pw, point), vwhere(take, nw, normal)
            front = torch.where(take, fr, front)
        mesh_t = torch.full((n,), BIG_T, device=dev)
        mesh_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
        mesh_o = torch.full((n,), -1, dtype=torch.int64, device=dev)
        cap = t_best
        for tris in world:
            hit, t, i = mesh_closest(tris, ro, rd, t_min, cap, active, ties, tie_tris)
            mesh_t = torch.where(hit, t, mesh_t)
            mesh_i = torch.where(hit, i, mesh_i)
            mesh_o = torch.where(hit, tris["obj"], mesh_o)
            cap = torch.where(hit, t, cap)
        take = mesh_i >= 0
        t_best = torch.where(take, mesh_t, t_best)
        kind = torch.where(take, KIND_TRIANGLE, kind)
        obj = torch.where(take, mesh_o, obj)
        prim = torch.where(take, mesh_i, prim)
        if world and "cn" in world[0]:
            outward = V3(*(_pick(world, mesh_o, mesh_i, "cn", c) for c in range(3))).normalize()
            tf = rd.dot(outward) < 0.0
            point = vwhere(take, ro + rd * mesh_t, point)
            normal = vwhere(take, vwhere(tf, outward, -outward), normal)
            front = torch.where(take, tf, front)
        obj_mat = torch.tensor(scene.obj_mat, device=dev)
        mask = kind != KIND_NONE
        mat = torch.where(mask, obj_mat[obj.clamp(min=0)], 0)
    return dict(kind=kind, obj=obj, prim=prim, mask=mask, t=torch.where(mask, t_best, BIG_T),
                point=point, normal=normal, front=front & mask, mat=mat)


def _pick(world, obj, idx, key, comp):
    out = torch.zeros(obj.shape, device=obj.device)
    for tris in world:
        sel = obj == tris["obj"]
        out = torch.where(sel, tris[key][comp][idx.clamp(min=0)], out)
    return out


def occluded(scene: Scene, lv, ro, rd, t_min, t_limit, active):
    """Whether any sphere or triangle meets each shadow ray in
    [t_min, t_limit]."""
    occ = torch.zeros_like(active)
    with torch.no_grad():
        for o, k in enumerate(scene.obj_kind):
            if k == "sphere":
                occ = occ | (active & _sphere_roots(scene, lv, o, ro, rd, t_min, t_limit)[0])
        for tris in scene.inst:
            hit, _, _ = mesh_closest(tris, ro, rd, t_min, t_limit, active & ~occ)
            occ = occ | hit
    return occ


# --- shading -------------------------------------------------------------------

def background(lv, rd: V3) -> V3:
    unit = rd.normalize()
    t = 0.5 * (unit.y + 1.0)
    down, up = lv["bg_down"], lv["bg_up"]
    return V3(down[0] + t * (up[0] - down[0]), down[1] + t * (up[1] - down[1]),
              down[2] + t * (up[2] - down[2]))


def _schlick(cosine, ref_idx):
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    p = 1.0 - cosine
    return r0 + (1.0 - r0) * (p * p * p * p * p)


def _rows(lv, scene, mat):
    m = mat.long()
    alb = rows(lv["albedo"], m)
    em = rows(lv["emission"], m)
    return (scene.mat_type[m], V3(alb[:, 0], alb[:, 1], alb[:, 2]), rows(lv["fuzz"], m),
            rows(lv["ior"], m), V3(em[:, 0], em[:, 1], em[:, 2]))


def shade(scene, lv, hit, ro, rd, t_min, throughput, seed, bounce):
    mtype, albedo, fuzz, ior, emitted_all = _rows(lv, scene, hit["mat"])
    n = hit["normal"]
    u0, u1 = draw(seed, bounce, 0), draw(seed, bounce, 1)
    phi = TWO_PI * u0
    ct = 2.0 * u1 - 1.0
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=1e-12))
    sphere_s = V3(torch.cos(phi) * st, torch.sin(phi) * st, ct)
    u_fresnel = draw(seed, bounce, 2)
    off = hit["point"] - n * (1e-4 * torch.sign(rd.dot(n)))
    d_sum = n + sphere_s
    d_diff = d_sum.normalize()
    degenerate = (d_sum.x.abs() < 1e-8) & (d_sum.y.abs() < 1e-8) & (d_sum.z.abs() < 1e-8)
    d_diff = vwhere(degenerate, n, d_diff)
    d_metal = reflect(rd, n) + sphere_s * fuzz
    zero = V3(torch.zeros_like(fuzz), torch.zeros_like(fuzz), torch.zeros_like(fuzz))
    metal_mult = vwhere(d_metal.dot(n) > 0.0, albedo, zero)
    ratio = torch.where(hit["front"], 1.0 / ior, ior)
    unit_d = rd.normalize()
    cos_theta = torch.clamp((-unit_d).dot(n), max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=1e-12))
    choose_reflect = (ratio * sin_theta > 1.0) | (_schlick(cos_theta, ratio) > u_fresnel)
    d_diel = vwhere(choose_reflect, reflect(unit_d, n), refract(unit_d, n, ratio))
    is_diff, is_metal = mtype == MAT_DIFFUSE, mtype == MAT_METAL
    is_diel, is_emis = mtype == MAT_DIELECTRIC, mtype == MAT_EMISSIVE
    new_rd = vwhere(is_diff, d_diff, vwhere(is_metal, d_metal, d_diel))
    new_ro = vwhere(is_diel, hit["point"], off)
    new_t_min = torch.where(is_diel, 1e-5, t_min)
    one = V3(torch.ones_like(fuzz), torch.ones_like(fuzz), torch.ones_like(fuzz))
    mult = vwhere(is_diff, albedo, vwhere(is_metal, metal_mult, one))
    emitted = vwhere(is_emis, emitted_all, zero)
    pdf_w = torch.where(is_diff, torch.clamp(d_diff.dot(n), min=0.0) * INV_PI, 0.0)
    return (new_ro, new_rd, new_t_min, throughput * mult, emitted, is_emis, is_metal | is_diel,
            pdf_w, albedo, is_diff)


def _nee_mesh(scene, lv, hit, throughput, seed, bounce, diffuse, albedo):
    """One point on the emissive triangles per lane and its shadow ray:
    (contribution, origin, direction, window end, valid)."""
    light = scene.light
    n = hit["normal"]
    p = hit["point"] + n * 1e-4
    u_sel, u1, u2 = draw(seed, bounce, 12), draw(seed, bounce, 13), draw(seed, bounce, 14)
    cum = light["cum"]
    idx = torch.clamp((u_sel[:, None] >= cum[None, :]).sum(dim=1), max=cum.shape[0] - 1)
    pick = light["pack"][idx]
    p0, e1, e2 = (V3(*pick[:, k:k + 3].unbind(1)) for k in (0, 3, 6))
    lmat = pick[:, 10].long()
    su = torch.sqrt(u1)
    x = p0 + e1 * (1.0 - su) + e2 * (u2 * su)
    d = x - p
    dist2 = torch.clamp(d.dot(d), min=1e-12)
    dist = torch.sqrt(dist2)
    direction = d * (1.0 / dist)
    nlv = e1.cross(e2)
    cos_l = direction.dot(nlv).abs() * torch.rsqrt(torch.clamp(nlv.dot(nlv), min=1e-30))
    valid = diffuse & (cos_l > 1e-6)
    t_limit = dist * (1.0 - 1e-3)
    p_b = torch.clamp(n.dot(direction), min=0.0) * INV_PI
    cla = cos_l * light["area"]
    scale = p_b * cla / (dist2 + p_b * cla)
    em = rows(lv["emission"], lmat)
    contrib = throughput * albedo * scale * V3(em[:, 0], em[:, 1], em[:, 2])
    return contrib, p, direction, t_limit, valid


def bounce(scene, lv, st, seed, b, hit):
    """One bounce on its hit record: the state after it (before NEE's
    shadow test) and, with emitters, the NEE term."""
    alive = st["alive"]
    hit_alive = alive & hit["mask"]
    miss = alive & ~hit["mask"]
    radiance = vwhere(miss, st["radiance"] + st["color"] * background(lv, st["rd"]),
                      st["radiance"])
    first_hit = hit["mask"] if b == 0 else torch.zeros_like(hit["mask"])
    normal = vwhere(first_hit, hit["normal"], st["normal"])
    depth = torch.where(first_hit, hit["t"], st["depth"])
    (new_ro, new_rd, new_t_min, new_color, emitted, absorb, specular, new_pdf, albedo,
     is_diff) = shade(scene, lv, hit, st["ro"], st["rd"], st["t_min"], st["color"], seed, b)
    if scene.has_nee:
        light = scene.light
        take = absorb & (hit["kind"] == KIND_TRIANGLE)
        t = torch.where(take, hit["t"], 0.0)
        cos_l = torch.clamp(-st["rd"].dot(hit["normal"]), min=1e-6)
        p_tri = t * t / (cos_l * torch.clamp(light["area"], min=1e-30))
        pl = torch.where(take, p_tri, torch.zeros_like(hit["t"]))
        pb, spec = st["pdf_w"], st["spec"]
        w = torch.where(spec, 1.0, pb / torch.where(spec, 1.0, torch.clamp(pb + pl, min=1e-20)))
        radiance = vwhere(hit_alive & absorb, radiance + st["color"] * emitted * w, radiance)
    else:
        radiance = vwhere(hit_alive, radiance + st["color"] * emitted, radiance)
    out = dict(ro=vwhere(hit_alive, new_ro, st["ro"]), rd=vwhere(hit_alive, new_rd, st["rd"]),
               t_min=torch.where(hit_alive, new_t_min, st["t_min"]), radiance=radiance,
               color=vwhere(hit_alive, new_color, st["color"]), alive=hit_alive & ~absorb,
               normal=normal, depth=depth)
    term = None
    if scene.has_nee:
        out.update(spec=torch.where(hit_alive, specular, st["spec"]),
                   pdf_w=torch.where(hit_alive, new_pdf, st["pdf_w"]))
        diffuse = alive & hit["mask"] & is_diff
        term = _nee_mesh(scene, lv, hit, st["color"], seed, b, diffuse, albedo)
    return out, term


def refine(scene: Scene, lv, ro, rd, t_min, ids, world):
    """The winning hit recomputed in closed form from the leaves: the
    sphere's quadratic through its object's matrices, the triangle's
    distance from its world rows."""
    n = ro[0].shape[0]
    dev = ro[0].device
    kind, obj = ids["kind"], ids["obj"].clamp(min=0)
    mask = kind != KIND_NONE
    m, inv = scene.obj_m[obj], scene.obj_inv[obj]
    s_prim = torch.where(kind == KIND_SPHERE, ids["prim"].clamp(min=0), 0)
    c = rows(lv["sphere_center"], s_prim)
    center = V3(c[:, 0], c[:, 1], c[:, 2])
    radius = rows(lv["sphere_radius"], s_prim)
    oo = xform_point(inv, ro)
    od = xform_vector(inv, rd).normalize()
    oc = oo - center
    a = od.dot(od)
    b = 2.0 * od.dot(oc)
    cc = oc.dot(oc) - radius * radius
    disc = b * b - 4.0 * a * cc
    sq = torch.sqrt(torch.clamp(disc, min=1e-12))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    t_obj = torch.where(t1 >= t_min, t1, t2)
    sp_obj = oo + od * t_obj
    sp_point = xform_point(m, sp_obj)
    sp_t = (sp_point - ro).length()
    sp_out = (sp_obj - center) * (1.0 / radius)
    sp_front = od.dot(sp_out) < 0.0
    sp_normal = xform_normal(inv, vwhere(sp_front, sp_out, -sp_out))

    zf = torch.zeros((n,), device=dev)
    p0, e1, e2 = V3(zf, zf, zf), V3(zf, zf + 1.0, zf), V3(zf, zf, zf + 1.0)
    is_tri = kind == KIND_TRIANGLE
    for tris in world:
        sel = is_tri & (ids["obj"] == tris["obj"])
        i = torch.where(sel, ids["prim"], 0)
        p0 = vwhere(sel, tris["p0"].take(i), p0)
        e1 = vwhere(sel, tris["e1"].take(i), e1)
        e2 = vwhere(sel, tris["e2"].take(i), e2)
    h = rd.cross(e2)
    det = e1.dot(h)
    f = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)
    q = (ro - p0).cross(e1)
    tr_t = f * e2.dot(q)
    tr_point = ro + rd * tr_t
    tr_out = e1.cross(e2).normalize()
    tr_front = rd.dot(tr_out) < 0.0
    tr_normal = vwhere(tr_front, tr_out, -tr_out)
    zero = V3(zf, zf, zf)
    obj_mat = torch.tensor(scene.obj_mat, device=dev)
    return dict(kind=kind, mask=mask,
                t=torch.where(mask, torch.where(is_tri, tr_t, sp_t), BIG_T),
                point=vwhere(mask, vwhere(is_tri, tr_point, sp_point), zero),
                normal=vwhere(mask, vwhere(is_tri, tr_normal, sp_normal), zero),
                front=torch.where(is_tri, tr_front, sp_front) & mask,
                mat=torch.where(mask, obj_mat[obj], 0))


def world_tris(scene: Scene, lv) -> list:
    """Each mesh object's world triangles from the positions leaf, in
    float32 as the differentiable pass traces them (differentiable)."""
    out = []
    pos = lv["positions"]
    for tris in scene.inst:
        o, k = tris["obj"], tris["mesh"]
        v0, nv = scene.mesh_vrange[k]
        idx = scene.mesh_tris[k]
        m = scene.obj_m[o]
        p = pos[v0:v0 + nv]

        def corner(c):
            q = p.index_select(0, idx[:, c])
            return xform_point(m, V3(q[:, 0], q[:, 1], q[:, 2]))

        w0, w1, w2 = corner(0), corner(1), corner(2)
        out.append(dict(obj=o, mesh=k, p0=w0, e1=w1 - w0, e2=w2 - w0, lo=tris["lo"], hi=tris["hi"]))
    return out


def _detached(world):
    return [dict(w, p0=V3(*(c.detach() for c in w["p0"])), e1=V3(*(c.detach() for c in w["e1"])),
                 e2=V3(*(c.detach() for c in w["e2"]))) for w in world]


# --- a sample and a render ------------------------------------------------------

def _take_state(st, keep):
    return {k: (v.take(keep) if isinstance(v, V3) else v[keep]) for k, v in st.items()}


def trace_sample(scene: Scene, lv, width, height, pix, iteration, max_bounces,
                 differentiable=False, ties=None, tie_tris=None):
    """One sample of pixels ``pix``: (color V3, normal V3, depth, segments
    per pixel).  Forward: the hit record of the closest-hit pass;
    ``differentiable``: the hit recomputed from the leaves by ``refine``
    on the ids of a pass over the positions' world triangles.  A forward
    sample drops its finished lanes once they are half of those it
    carries (a finished lane's state no longer changes)."""
    ro, rd, seed = primary(scene, width, height, pix, iteration)
    n = pix.shape[0]
    dev = pix.device
    zf = torch.zeros((n,), device=dev)
    st = dict(ro=ro, rd=rd, t_min=torch.full_like(zf, T_MIN_PRIMARY),
              radiance=V3(zf, zf, zf), color=V3(zf + 1.0, zf + 1.0, zf + 1.0),
              alive=torch.ones((n,), dtype=torch.bool, device=dev), normal=-rd,
              depth=torch.full_like(zf, 1e6))
    if scene.has_nee:
        st.update(spec=torch.ones((n,), dtype=torch.bool, device=dev), pdf_w=zf)
    segs = torch.zeros((n,), dtype=torch.int64, device=dev)
    world = world_tris(scene, lv) if differentiable else scene.inst
    ids_world = _detached(world) if differentiable else world
    lane = torch.arange(n, device=dev)  # the position in pix of each lane carried
    out = None if differentiable else dict(color=[torch.zeros_like(zf) for _ in range(3)],
                                           normal=[torch.zeros_like(zf) for _ in range(3)],
                                           depth=torch.zeros_like(zf))

    def flush(sel):
        """Write the lanes ``sel`` out as finished samples."""
        fin = vwhere(st["alive"][sel], st["radiance"].take(sel) + st["color"].take(sel),
                     st["radiance"].take(sel))
        at = lane[sel]
        for c in range(3):
            out["color"][c][at] = fin[c]
            out["normal"][c][at] = st["normal"][c][sel]
        out["depth"][at] = st["depth"][sel]

    for b in range(max_bounces):
        alive = st["alive"]
        live = int(alive.sum())
        if live == 0:
            break
        if not differentiable and live <= alive.shape[0] // 2:
            flush(torch.nonzero(~alive).reshape(-1))
            keep = torch.nonzero(alive).reshape(-1)
            st, seed, lane = _take_state(st, keep), seed[keep], lane[keep]
            alive = st["alive"]
        segs[lane] += alive.long()
        lane_ties = None if ties is None else torch.zeros_like(alive)
        hit = closest_hit(scene, lv, st["ro"], st["rd"], st["t_min"], alive, ids_world, lane_ties,
                          tie_tris)
        if ties is not None:
            ties[lane] |= lane_ties
        if differentiable:
            hit = refine(scene, lv, st["ro"], st["rd"], st["t_min"], hit, world)
        st2, term = bounce(scene, lv, st, seed, b, hit)
        if term is not None:
            contrib, p, direction, t_limit, valid = term
            t0 = torch.full_like(t_limit, 1e-4)
            lit = valid & ~occluded(scene, lv, p, direction, t0, t_limit, valid)
            zero = V3(torch.zeros_like(t_limit), torch.zeros_like(t_limit),
                      torch.zeros_like(t_limit))
            st2["radiance"] = st2["radiance"] + vwhere(lit, contrib, zero)
        st = st2
    if differentiable:
        final = vwhere(st["alive"], st["radiance"] + st["color"], st["radiance"])
        return final, st["normal"], st["depth"], segs
    flush(torch.arange(lane.shape[0], device=dev))
    return V3(*out["color"]), V3(*out["normal"]), out["depth"], segs


def _fold(old, new, git):
    """The progressive average after sample ``git`` (0-based, global)."""
    if git == 0:
        return new
    nf = torch.tensor(float(git + 1), device=new.device)
    return (old * (nf - 1.0) + new) / nf


def render(scene: Scene, width, height, spp, max_bounces, start_iteration, pix,
           differentiable=False, lv=None, ties=None, lanes=1 << 23, tie_tris=None):
    """``spp`` samples from ``start_iteration`` of pixels ``pix``, folded
    into progressive averages: (color (n, 3), normal (n, 3), depth (n,),
    segments per pixel (n,)).  Samples are traced together, as many as
    ``lanes`` lanes hold, a lane a (sample, pixel) pair."""
    lv = scene.leaves if lv is None else lv
    n = pix.shape[0]
    group = max(1, min(spp, lanes // max(1, n)))
    color = normal = depth = None
    segs = torch.zeros(pix.shape, dtype=torch.int64, device=pix.device)
    for k0 in range(0, spp, group):
        g = min(group, spp - k0)
        its = start_iteration + k0 + torch.arange(g, device=pix.device).repeat_interleave(n)
        lane_ties = None if ties is None else torch.zeros(g * n, dtype=torch.bool,
                                                          device=pix.device)
        c, nrm, d, sg = trace_sample(scene, lv, width, height, pix.repeat(g), its, max_bounces,
                                     differentiable, lane_ties, tie_tris)
        c, nrm = c.stack().reshape(g, n, 3), nrm.stack().reshape(g, n, 3)
        d = d.reshape(g, n)
        segs = segs + sg.reshape(g, n).sum(dim=0)
        if ties is not None:
            ties |= lane_ties.reshape(g, n).any(dim=0)
        for j in range(g):
            git = start_iteration + k0 + j
            if color is None:
                if git == 0:
                    color, normal, depth = c[j], nrm[j], d[j]
                    continue
                color, normal, depth = (torch.zeros_like(c[j]), torch.zeros_like(nrm[j]),
                                        torch.zeros_like(d[j]))
            color, normal = _fold(color, c[j], git), _fold(normal, nrm[j], git)
            depth = _fold(depth, d[j], git)
    return color, normal, depth, segs


def render_forward(scene: Scene, width, height, spp, max_bounces, start_iteration,
                   block=1 << 21, pix=None):
    """The whole image, or its pixels ``pix``, forward, in blocks of
    pixels: (color (N, 3), normal (N, 3), depth (N,), segments per pixel
    (N,), tied (N,): pixels one of whose rays met two triangles at exactly
    its closest t)."""
    dev = scene.device
    if pix is None:
        pix = torch.arange(width * height, dtype=torch.int64, device=dev)
    outs = []
    with torch.no_grad():
        for p0 in range(0, len(pix), block):
            part = pix[p0:p0 + block]
            ties = torch.zeros(part.shape, dtype=torch.bool, device=dev)
            outs.append((*render(scene, width, height, spp, max_bounces, start_iteration, part,
                                 ties=ties), ties))
    return tuple(torch.cat([o[i] for o in outs]) for i in range(5))


def render_grad(scene: Scene, width, height, spp, max_bounces, start_iteration, block=1 << 19,
                tie_tris=None):
    """The gradient step: the image, the loss sum(color^2) (float64) and
    its gradient to every leaf, block by block of pixels: (color, normal,
    depth, segments per pixel, tied, loss, {leaf: gradient}).  ``tie_tris``
    (a list) gains the triangles of each exact-t tie."""
    n = width * height
    dev = scene.device
    lv = params(scene)
    grads = {k: torch.zeros_like(v) for k, v in lv.items()}
    loss = 0.0
    outs = []
    for p0 in range(0, n, block):
        pix = torch.arange(p0, min(n, p0 + block), dtype=torch.int64, device=dev)
        ties = torch.zeros(pix.shape, dtype=torch.bool, device=dev)
        color, normal, depth, segs = render(scene, width, height, spp, max_bounces,
                                            start_iteration, pix, True, lv, ties,
                                            tie_tris=tie_tris)
        part = torch.sum(color ** 2)
        got = torch.autograd.grad(part, list(lv.values()), allow_unused=True)
        for k, g in zip(lv, got):
            if g is not None:
                grads[k] += g
        loss += float(part.detach().double())
        outs.append((color.detach(), normal.detach(), depth.detach(), segs, ties))
    return (*(torch.cat([o[i] for o in outs]) for i in range(5)), loss, grads)
