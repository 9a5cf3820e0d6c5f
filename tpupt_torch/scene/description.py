"""CPU-side scene description and device-tensor build (counterpart of
``tpupt/scene/description.py``).

The analogue of the reference SceneDescription + build_scene
(src/lib/scene_description.{hpp,cpp}): named materials, a named mesh cache,
objects as (shape, transform, material), then a build step that bakes
everything into flat device arrays.

Two deliberate upgrades over the reference:
  * ALL meshes are uploaded into one concatenated vertex/triangle/BVH pool
    with per-mesh ranges — the reference silently uploads only the first
    mesh and shares it across every mesh object
    (src/lib/scene_description.cpp:95, SURVEY.md §2.1 #23).
  * materials keep insertion order (the reference's std::map sorts by name;
    indices are internal either way).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from tpupt_torch.accel.bvh import build_bvh
from tpupt_torch.accel.treelets import build_treelets
from tpupt_torch.core.camera import make_camera
from tpupt_torch.core.types import (
    Camera,
    Materials,
    OBJ_MESH,
    OBJ_SPHERE,
    MAT_DIELECTRIC,
    MAT_DIFFUSE,
    MAT_EMISSIVE,
    MAT_METAL,
    SceneArrays,
)
from tpupt_torch.core import math3d


def _np_transform_point(m, p):
    v = m @ np.append(p, 1.0)
    return v[:3] / v[3]


def _np_transform_vector(m, v):
    return (m[:3, :3] @ v).astype(np.float64)


@dataclass
class MeshData:
    positions: np.ndarray  # (V, 3) f32
    tris: np.ndarray  # (T, 3) i32
    aabb_min: np.ndarray = field(init=False)
    aabb_max: np.ndarray = field(init=False)

    def __post_init__(self):
        self.positions = np.asarray(self.positions, np.float32)
        self.tris = np.asarray(self.tris, np.int32)
        self.aabb_min = self.positions.min(axis=0)
        self.aabb_max = self.positions.max(axis=0)


@dataclass
class SceneDescription:
    """Builder mirroring the reference's public surface
    (src/lib/scene_description.hpp:19-49)."""

    filename: str = ""
    resolution: tuple[int, int] = (800, 600)  # (width, height)
    spp: int = 1
    camera: Camera = None  # set in __post_init__

    _materials: dict = field(default_factory=dict)  # name -> (type, params)
    _material_order: list = field(default_factory=list)
    _meshes: dict = field(default_factory=dict)  # name -> MeshData
    _mesh_order: list = field(default_factory=list)
    _objects: list = field(default_factory=list)  # (kind, key, transform, mat)

    # background endpoints; reference hardcodes the sky gradient
    # (src/lib/path_tracer.cu:29-34).
    bg_down: tuple = (0.5, 0.7, 1.0)
    bg_up: tuple = (1.0, 1.0, 1.0)

    def __post_init__(self):
        if self.camera is None:
            self.camera = make_camera()

    # --- materials -----------------------------------------------------
    def add_material(self, name: str, mtype: str, **params) -> None:
        """lambertian / metal / dielectric (reference json_parser.cpp:101-122)
        plus diffuse_light (emissive extension)."""
        if name in self._materials:
            raise ValueError(f"duplicate material {name!r}")
        if mtype not in ("lambertian", "metal", "dielectric", "diffuse_light"):
            raise ValueError(f"unsupported material type {mtype!r}")
        self._materials[name] = (mtype, params)
        self._material_order.append(name)

    # --- meshes --------------------------------------------------------
    def get_mesh(self, name: str) -> Optional[MeshData]:
        return self._meshes.get(name)

    def add_mesh(self, name: str, positions, tris) -> str:
        if name in self._meshes:
            raise ValueError(f"duplicate mesh {name!r}")
        self._meshes[name] = MeshData(positions, tris)
        self._mesh_order.append(name)
        return name

    # --- objects -------------------------------------------------------
    def add_sphere(self, radius: float, transform, material: str, center=(0.0, 0.0, 0.0)):
        """Unit-center sphere like the JSON schema
        (src/lib/assets/json_parser.cpp:144-147)."""
        self._objects.append(
            ("sphere", (np.asarray(center, np.float64), float(radius)),
             np.asarray(transform, np.float64), material)
        )

    def add_mesh_object(self, mesh_name: str, transform, material: str):
        if mesh_name not in self._meshes:
            raise KeyError(f"unknown mesh {mesh_name!r}")
        self._objects.append(
            ("mesh", mesh_name, np.asarray(transform, np.float64), material)
        )

    # --- build ---------------------------------------------------------
    def build(self, leaf_size: int = 32, device="cpu") -> SceneArrays:
        """Bake to flat tensors on ``device`` (reference build_scene,
        src/lib/scene_description.cpp:12-117) + the world-space treelet
        table for the packet intersector (accel/treelets.py)."""
        mat_index = {n: i for i, n in enumerate(self._material_order)}
        mesh_index = {n: i for i, n in enumerate(self._mesh_order)}

        # material SoA
        mtypes, albedos, fuzzes, iors, emissions = [], [], [], [], []
        for name in self._material_order:
            mtype, p = self._materials[name]
            emissions.append(p.get("emit", (0.0, 0.0, 0.0)))
            if mtype == "lambertian":
                mtypes.append(MAT_DIFFUSE)
                albedos.append(p["albedo"])
                fuzzes.append(0.0)
                iors.append(1.0)
            elif mtype == "metal":
                mtypes.append(MAT_METAL)
                albedos.append(p["albedo"])
                fuzzes.append(p.get("fuzz", 0.0))
                iors.append(1.0)
            elif mtype == "dielectric":
                mtypes.append(MAT_DIELECTRIC)
                albedos.append((1.0, 1.0, 1.0))
                fuzzes.append(0.0)
                iors.append(p["refraction_index"])
            else:  # diffuse_light
                mtypes.append(MAT_EMISSIVE)
                albedos.append((0.0, 0.0, 0.0))
                fuzzes.append(0.0)
                iors.append(1.0)
        if not mtypes:  # keep pools non-empty for safe gathers
            mtypes, albedos, fuzzes, iors, emissions = (
                [MAT_DIFFUSE], [(0.5,) * 3], [0.0], [1.0], [(0.0,) * 3]
            )

        # mesh pool: concatenate vertices/triangles/BVHs with offsets
        all_pos, all_tris = [], []
        all_nmin, all_nmax, all_ntri, all_nskip = [], [], [], []
        mesh_roots = []
        mesh_tri_ranges = []
        v_off = t_off = n_off = 0
        for name in self._mesh_order:
            md = self._meshes[name]
            bvh = build_bvh(md.positions, md.tris)
            mesh_tri_ranges.append((t_off, t_off + md.tris.shape[0]))
            all_pos.append(md.positions)
            all_tris.append(md.tris.astype(np.int64) + v_off)
            all_nmin.append(bvh.node_min)
            all_nmax.append(bvh.node_max)
            tri_g = bvh.node_tri.astype(np.int64)
            all_ntri.append(np.where(tri_g >= 0, tri_g + t_off, -1))
            skip = bvh.node_skip.astype(np.int64)
            all_nskip.append(np.where(skip >= 0, skip + n_off, -1))
            mesh_roots.append(n_off)
            v_off += md.positions.shape[0]
            t_off += md.tris.shape[0]
            n_off += bvh.num_nodes
        if not all_pos:  # dummy far-away degenerate mesh so pools are non-empty
            all_pos.append(np.full((3, 3), 1e9, np.float32))
            all_tris.append(np.array([[0, 1, 2]], np.int64))
            all_nmin.append(np.full((1, 3), 1e9, np.float32))
            all_nmax.append(np.full((1, 3), 1e9, np.float32))
            all_ntri.append(np.array([0], np.int64))
            all_nskip.append(np.array([-1], np.int64))

        # sphere pool + per-object tables
        sph_c, sph_r = [], []
        obj_kind, obj_prim, obj_mat = [], [], []
        obj_m, obj_inv, obj_bmin, obj_bmax = [], [], [], []
        for kind, key, transform, material in self._objects:
            if material not in mat_index:
                raise KeyError(f"Cannot find material {material}")
            obj_mat.append(mat_index[material])
            obj_m.append(transform)
            obj_inv.append(np.linalg.inv(transform))
            if kind == "sphere":
                center, radius = key
                obj_kind.append(OBJ_SPHERE)
                obj_prim.append(len(sph_c))
                sph_c.append(center)
                sph_r.append(radius)
                # world AABB like the reference: transformed center ±
                # |M·(1,0,0)|·r (src/lib/scene_description.cpp:27-36)
                tc = _np_transform_point(transform, center)
                tr = np.linalg.norm(_np_transform_vector(transform, np.array([1.0, 0, 0]))) * radius
                obj_bmin.append(tc - tr)
                obj_bmax.append(tc + tr)
            else:
                md = self._meshes[key]
                obj_kind.append(OBJ_MESH)
                obj_prim.append(mesh_index[key])
                bmin, bmax = math3d.transform_aabb_np(
                    transform, md.aabb_min, md.aabb_max
                )
                obj_bmin.append(bmin)
                obj_bmax.append(bmax)
        if not sph_c:
            sph_c.append(np.array([1e9, 1e9, 1e9]))
            sph_r.append(0.0)
        if not self._objects:
            obj_mat.append(0)
            obj_m.append(np.eye(4))
            obj_inv.append(np.eye(4))
            obj_bmin.append(np.zeros(3))
            obj_bmax.append(np.zeros(3))

        # NEE light list: world-space emissive-sphere GEOMETRY (uniform-
        # scale transforms assumed, like the reference's sphere AABB math).
        # Emission radiance is NOT baked here — NEE reads it live from
        # materials.emission via s_light_mats so emission stays one
        # differentiable parameter for both estimator terms.
        light_objs, light_mats, l_centers, l_radii = [], [], [], []
        for o, (kind, key, transform, material) in enumerate(self._objects):
            if kind != "sphere" or material not in mat_index:
                continue
            mtype, p = self._materials[material]
            if mtype != "diffuse_light":
                continue
            center, radius = key
            light_objs.append(o)
            light_mats.append(mat_index[material])
            l_centers.append(_np_transform_point(transform, center))
            l_radii.append(
                np.linalg.norm(_np_transform_vector(transform, np.array([1.0, 0, 0])))
                * radius
            )
        if not light_objs:
            l_centers, l_radii = [np.zeros(3)], [0.0]
        # one-hot matmul NEE fetches SUM matching table rows — a duplicate
        # object id would silently produce garbage light geometry, so the
        # uniqueness precondition is enforced where the table is baked
        if len(set(light_objs)) != len(light_objs):
            raise ValueError(
                f"duplicate object ids in NEE light table: {light_objs}"
            )

        # Triangle-area lights: world-baked triangles of emissive MESH
        # instances for NEE sampling (packed [p0, e1, e2, obj, mat] rows
        # + an area CDF; emission stays live in materials.emission).
        TRI_LIGHT_MAX = 512  # (N, Lt) selection + one-hot fetch bound
        tl_rows, tl_areas = [], []
        for o, (kind, key, transform, material) in enumerate(self._objects):
            if kind != "mesh" or material not in mat_index:
                continue
            mtype, p = self._materials[material]
            if mtype != "diffuse_light":
                continue
            md = self._meshes[key]
            m = np.asarray(transform, np.float64)
            wp = md.positions @ m[:3, :3].T + m[:3, 3]
            v = wp[md.tris]  # (T, 3, 3) world-space
            p0 = v[:, 0]
            e1 = v[:, 1] - v[:, 0]
            e2 = v[:, 2] - v[:, 0]
            area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
            objc = np.full((len(p0), 1), float(o))
            matc = np.full((len(p0), 1), float(mat_index[material]))
            tl_rows.append(np.concatenate([p0, e1, e2, objc, matc], axis=1))
            tl_areas.append(area)
        if tl_rows:
            tl_pack = np.concatenate(tl_rows).astype(np.float32)
            tl_area = np.concatenate(tl_areas).astype(np.float64)
            n_tl = int(tl_pack.shape[0])
            if n_tl > TRI_LIGHT_MAX:
                raise ValueError(
                    f"{n_tl} emissive-mesh light triangles exceed the "
                    f"supported cap of {TRI_LIGHT_MAX} (the NEE sampler "
                    "does a dense per-lane CDF selection + one-hot fetch "
                    "over the light-triangle table)"
                )
            tl_total = float(tl_area.sum())
            tl_cum = (np.cumsum(tl_area) / max(tl_total, 1e-30)).astype(
                np.float32
            )
        else:
            tl_pack = np.zeros((1, 11), np.float32)
            tl_cum = np.ones((1,), np.float32)
            tl_total, n_tl = 0.0, 0

        # world-space treelet table over all mesh instances
        mesh_data = [
            (self._meshes[name].positions, self._meshes[name].tris)
            for name in self._mesh_order
        ] or [(np.full((3, 3), 1e9, np.float32), np.array([[0, 1, 2]], np.int32))]
        instances = [
            (mesh_index[key], transform, o)
            for o, (kind, key, transform, _mat) in enumerate(self._objects)
            if kind == "mesh"
        ]
        tri_offsets = [r[0] for r in mesh_tri_ranges] or [0]
        treelets = build_treelets(
            mesh_data, instances, leaf_size=leaf_size, tri_id_offsets=tri_offsets
        )

        def f32(x):
            return torch.from_numpy(np.array(np.asarray(x), np.float32)).to(device)

        def i32(x):
            return torch.from_numpy(np.array(np.asarray(x), np.int32)).to(device)

        return SceneArrays(
            obj_mat=i32(obj_mat),
            obj_m=f32(obj_m),
            obj_inv_m=f32(obj_inv),
            obj_aabb_min=f32(obj_bmin),
            obj_aabb_max=f32(obj_bmax),
            sphere_center=f32(sph_c),
            sphere_radius=f32(sph_r),
            positions=f32(np.concatenate(all_pos)),
            tri_idx=i32(np.concatenate(all_tris)),
            node_min=f32(np.concatenate(all_nmin)),
            node_max=f32(np.concatenate(all_nmax)),
            node_tri=i32(np.concatenate(all_ntri)),
            node_skip=i32(np.concatenate(all_nskip)),
            tre_min=f32(treelets.tre_min),
            tre_max=f32(treelets.tre_max),
            tre_tris=f32(treelets.tre_tris),
            slot_src=i32(treelets.slot_src),
            slot_obj=i32(treelets.slot_obj),
            materials=Materials(
                mat_type=i32(mtypes),
                albedo=f32(albedos),
                fuzz=f32(fuzzes),
                ior=f32(iors),
                emission=f32(emissions),
            ),
            bg_down=f32(self.bg_down),
            bg_up=f32(self.bg_up),
            nee_center=f32(l_centers),
            nee_radius=f32(l_radii),
            tri_light_pack=f32(tl_pack),
            tri_light_cum=f32(tl_cum),
            tri_light_area=f32(tl_total),
            s_obj_kind=tuple(obj_kind),
            s_obj_prim=tuple(obj_prim),
            s_mesh_root=tuple(mesh_roots) if mesh_roots else (0,),
            s_mesh_tri_range=tuple(mesh_tri_ranges) if mesh_tri_ranges else ((0, 1),),
            s_leaf_size=leaf_size,
            s_light_objs=tuple(light_objs),
            s_light_mats=tuple(light_mats),
            s_tri_light_count=n_tl,
        )
