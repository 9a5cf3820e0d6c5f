"""Core scene and render types (counterpart of ``tpupt/core/types.py``).

The JAX package holds its scene as ``flax.struct`` pytrees.  Here the same
records are plain dataclasses of tensors: float tensors are float32 and
integer ids int64 or int32 exactly as listed below; the ``s_*`` fields are
static Python tuples and ints, as they are in the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

# Object type tags.
OBJ_SPHERE = 0
OBJ_MESH = 1

# Material type tags.
MAT_DIFFUSE = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_EMISSIVE = 3

# Primitive-kind tags used in hit records.
PRIM_NONE = -1
PRIM_SPHERE = 0
PRIM_TRIANGLE = 1


def _to(obj, device):
    """Copy of a dataclass of tensors with every tensor moved to ``device``."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(device)
        elif dataclasses.is_dataclass(v):
            v = _to(v, device)
        kw[f.name] = v
    return type(obj)(**kw)


@dataclass
class Camera:
    """Pinhole camera: ``camera_matrix`` is camera-to-world (4, 4) float32;
    ``vfov`` is in radians and rounded to float32 like the JAX package's."""

    camera_matrix: torch.Tensor  # (4, 4) f32
    vfov: float

    def to(self, device) -> "Camera":
        return _to(self, device)


@dataclass
class Materials:
    """SoA of the BSDF types; ``mat_type`` selects which fields are live."""

    mat_type: torch.Tensor  # (M,) i32
    albedo: torch.Tensor  # (M, 3) f32
    fuzz: torch.Tensor  # (M,) f32
    ior: torch.Tensor  # (M,) f32
    emission: torch.Tensor  # (M, 3) f32


@dataclass
class SceneArrays:
    """The whole scene as device tensors; field for field the JAX package's
    ``SceneArrays`` (see there for what each table holds)."""

    obj_mat: torch.Tensor  # (O,) i32
    obj_m: torch.Tensor  # (O, 4, 4) f32
    obj_inv_m: torch.Tensor  # (O, 4, 4) f32
    obj_aabb_min: torch.Tensor  # (O, 3) f32
    obj_aabb_max: torch.Tensor  # (O, 3) f32
    sphere_center: torch.Tensor  # (S, 3) f32
    sphere_radius: torch.Tensor  # (S,) f32
    positions: torch.Tensor  # (V, 3) f32
    tri_idx: torch.Tensor  # (T, 3) i32
    node_min: torch.Tensor  # (B, 3) f32
    node_max: torch.Tensor  # (B, 3) f32
    node_tri: torch.Tensor  # (B,) i32
    node_skip: torch.Tensor  # (B,) i32
    tre_min: torch.Tensor  # (K, 3) f32 world AABB per treelet
    tre_max: torch.Tensor  # (K, 3) f32
    tre_tris: torch.Tensor  # (K, 13*L) f32 component-major blocks
    slot_src: torch.Tensor  # (K*L,) i32
    slot_obj: torch.Tensor  # (K*L,) i32
    materials: Materials
    bg_down: torch.Tensor  # (3,) f32
    bg_up: torch.Tensor  # (3,) f32
    nee_center: torch.Tensor  # (Ls, 3) f32
    nee_radius: torch.Tensor  # (Ls,) f32
    tri_light_pack: torch.Tensor  # (Lt, 11) f32
    tri_light_cum: torch.Tensor  # (Lt,) f32
    tri_light_area: torch.Tensor  # () f32

    s_obj_kind: tuple = ()
    s_obj_prim: tuple = ()
    s_mesh_root: tuple = ()
    s_mesh_tri_range: tuple = ()
    s_leaf_size: int = 64
    s_light_objs: tuple = ()
    s_light_mats: tuple = ()
    s_tri_light_count: int = 0

    @property
    def device(self) -> torch.device:
        return self.tre_tris.device

    @property
    def has_nee(self) -> bool:
        """Emitters present: the renderer then runs next-event
        estimation."""
        return len(self.s_light_objs) > 0 or self.s_tri_light_count > 0

    def to(self, device) -> "SceneArrays":
        return _to(self, device)


STATIC_FIELDS = tuple(
    f.name for f in dataclasses.fields(SceneArrays) if f.name.startswith("s_")
)

# per-object, per-material and per-sphere tables up to this many rows are
# read per lane through a one-hot product while autograd records
_ONEHOT_MAX_ROWS = 512


def table_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a small per-object, per-material or per-sphere
    table and an (N,) index.

    While autograd records and the table needs a gradient, the rows come
    from onehot(idx) @ table: the same values (one product by 1.0 plus
    zeros; TF32 is off), and the backward pass is the product's transpose,
    a dense reduction over the lanes.  The VJP of plain indexing scatters
    with a sort and sums each index's run of duplicates serially; with a
    million lanes reading a handful of rows that took ~200 ms per gather on
    an H100.  Otherwise it indexes."""
    n_rows = table.shape[0]
    if not (torch.is_grad_enabled() and table.requires_grad) or n_rows > _ONEHOT_MAX_ROWS:
        return table[idx]
    onehot = (idx[:, None] == torch.arange(n_rows, device=idx.device)).to(table.dtype)
    return (onehot @ table.reshape(n_rows, -1)).reshape(idx.shape + table.shape[1:])


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a contiguous copy; keeps 0-dim arrays 0-dim
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device)


def scene_from_numpy(leaves: dict[str, Any], static: dict, device="cuda") -> SceneArrays:
    """Build a ``SceneArrays`` on ``device`` (the card unless the caller
    names another) from numpy leaves and static fields.

    ``leaves`` maps every non-static field name to a numpy array, except
    ``materials``, which maps to a dict of the ``Materials`` field names.
    ``static`` maps the ``s_*`` names to their values.  This is how a scene
    built by the JAX package crosses over: its caller converts the leaves to
    numpy on its own side, so this package never sees JAX."""
    mats = Materials(
        **{f.name: _tensor(leaves["materials"][f.name], device)
           for f in dataclasses.fields(Materials)}
    )
    kw = {
        f.name: _tensor(leaves[f.name], device)
        for f in dataclasses.fields(SceneArrays)
        if f.name != "materials" and f.name not in STATIC_FIELDS
    }
    return SceneArrays(materials=mats, **kw, **{name: static[name] for name in STATIC_FIELDS})


@dataclass
class Hit:
    """Forward hit record over a flat ray batch (point/normal are Vec3)."""

    mask: torch.Tensor  # (N,) bool
    t: torch.Tensor  # (N,) f32
    point: Any  # Vec3 of (N,)
    normal: Any  # Vec3 of (N,) — faces against the incident ray
    front: torch.Tensor  # (N,) bool
    mat_id: torch.Tensor  # (N,) i64


@dataclass
class HitIds:
    """Discrete intersection result: which primitive won."""

    kind: torch.Tensor  # (N,) i32 in {PRIM_NONE, PRIM_SPHERE, PRIM_TRIANGLE}
    obj_id: torch.Tensor  # (N,) i64 — winning object, -1 on miss
    prim_id: torch.Tensor  # (N,) i64 — sphere pool index or global triangle id
    t: torch.Tensor  # (N,) f32


@dataclass
class RenderBuffers:
    """Progressive accumulation targets, flat row-major y*W + x."""

    color: torch.Tensor  # (N, 3) f32
    normal: torch.Tensor  # (N, 3) f32
    depth: torch.Tensor  # (N,) f32
    iteration: int = 0

    @classmethod
    def create(cls, n_pixels: int, device=None, iteration: int = 0) -> "RenderBuffers":
        """Zeroed buffers for ``n_pixels``, at sample ``iteration``."""
        return cls(
            color=torch.zeros((n_pixels, 3), device=device),
            normal=torch.zeros((n_pixels, 3), device=device),
            depth=torch.zeros((n_pixels,), device=device),
            iteration=iteration,
        )
