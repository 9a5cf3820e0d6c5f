"""Treelet decomposition and world-space baking (counterpart of
``tpupt/accel/treelets.py``).

Each mesh instance is baked to world space and gets its own SAH BVH, which
is cut at subtrees of at most L triangles ("treelets").  Every treelet owns
one padded block of 13 component-major runs of L floats:
[p0(3), e1(3), e2(3), cn(3) = unnormalized float32 cross(e1, e2), obj(1)].
All instances' treelets form one global table; the closest-hit sweep
(``accel/packets.py``) walks it per 256-ray packet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpupt_torch.accel.bvh import FlatBVH, build_bvh

# Components per packed block: [p0(3), e1(3), e2(3), cn(3), obj(1)].
BLOCK_COMPONENTS = 13


@dataclass
class TreeletTable:
    """Global packed treelet geometry (numpy, host-side; one per scene)."""

    # per-treelet
    tre_min: np.ndarray  # (K, 3) f32 world-space AABB
    tre_max: np.ndarray  # (K, 3) f32
    # packed triangle data, COMPONENT-major per row:
    # [p0x*L, p0y*L, p0z*L, e1x*L, ..., e2z*L, cnx*L, cny*L, cnz*L, obj*L]
    # so block[:, c*L:(c+1)*L] is one (L,) component — the layout the
    # component-SoA sweep slices without any minor-dim-3 arrays.
    tre_tris: np.ndarray  # (K, BLOCK_COMPONENTS*L) f32, padded w/ degenerates
    # per-slot metadata (parallel to the packed layout, flattened (K*L,))
    slot_src: np.ndarray  # (K*L,) i32 original global triangle id, -1 = pad
    slot_obj: np.ndarray  # (K*L,) i32 owning object id, -1 = pad


def _cut_bvh(bvh: FlatBVH, max_tris: int) -> list[np.ndarray]:
    """Cut a flat DFS BVH into subtrees holding <= max_tris triangles;
    returns the list of triangle-id arrays (DFS leaf order per treelet)."""
    B = bvh.num_nodes

    # subtree sizes: DFS pre-order with skip links => the subtree of node i
    # spans [i, skip_target) where skip_target = node_skip[i] (or B).
    def subtree_end(i: int) -> int:
        s = bvh.node_skip[i]
        return B if s < 0 else int(s)

    treelets = []
    stack = [0]
    while stack:
        i = stack.pop()
        end = subtree_end(i)
        tris = bvh.node_tri[i:end]
        tris = tris[tris >= 0]
        if len(tris) <= max_tris or bvh.node_tri[i] >= 0:
            treelets.append(tris.astype(np.int64))
        else:
            left = i + 1
            right = subtree_end(left)
            stack.append(right)
            stack.append(left)  # left first: preserves front-split order
    return treelets


def build_treelets(
    meshes: list[tuple[np.ndarray, np.ndarray]],  # per mesh: (positions, tris)
    instances: list[tuple[int, np.ndarray, int]],  # (mesh_id, 4x4 world matrix, obj_id)
    leaf_size: int = 64,
    tri_id_offsets: list[int] | None = None,
) -> TreeletTable:
    """Bake every mesh instance to world space and build the global table.

    ``tri_id_offsets[mesh_id]`` maps mesh-local triangle ids to global ids
    (the concatenated tri_idx pool used by the differentiable refine pass).
    """
    if tri_id_offsets is None:
        offs, acc = [], 0
        for pos, tris in meshes:
            offs.append(acc)
            acc += tris.shape[0]
        tri_id_offsets = offs

    tre_min, tre_max, tre_blocks, slot_src, slot_obj = [], [], [], [], []

    for mesh_id, world_m, obj_id in instances:
        if obj_id >= 2**24:
            raise ValueError(
                f"object id {obj_id} >= 2^24: ids ride in f32 block lanes"
            )
        positions, tris = meshes[mesh_id]
        m = np.asarray(world_m, np.float64)
        wpos = (positions @ m[:3, :3].T + m[:3, 3]).astype(np.float32)

        bvh = build_bvh(wpos, tris)  # world-space BVH for this instance
        for tri_ids in _cut_bvh(bvh, leaf_size):
            v = wpos[np.asarray(tris)[tri_ids]]  # (n, 3, 3)
            p0 = v[:, 0]
            e1 = v[:, 1] - v[:, 0]
            e2 = v[:, 2] - v[:, 0]
            # single-rounded f32 cross, the JAX package's elementwise math
            cn = np.stack(
                [
                    e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                    e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                    e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0],
                ],
                axis=1,
            )
            n = len(tri_ids)
            pad = leaf_size - n
            objc = np.full((n, 1), float(obj_id), np.float32)
            block = np.concatenate([p0, e1, e2, cn, objc], axis=1)  # (n, 13)
            if pad:
                # degenerate far-away triangles never hit
                filler = np.zeros((pad, BLOCK_COMPONENTS), np.float32)
                filler[:, :3] = 3e37
                filler[:, 12] = -1.0
                block = np.concatenate([block, filler], axis=0)
            # component-major packing: 13 contiguous (L,) component runs
            tre_blocks.append(block.T.reshape(-1).astype(np.float32))
            tre_min.append(v.reshape(-1, 3).min(axis=0))
            tre_max.append(v.reshape(-1, 3).max(axis=0))
            src = np.full(leaf_size, -1, np.int64)
            src[:n] = tri_ids + tri_id_offsets[mesh_id]
            slot_src.append(src)
            obj = np.full(leaf_size, -1, np.int64)
            obj[:n] = obj_id
            slot_obj.append(obj)

    if not tre_blocks:  # keep arrays non-empty for jit-safe gathers
        tre_min = [np.full(3, 3e37, np.float32)]
        tre_max = [np.full(3, 3e37, np.float32)]
        blk = np.zeros((leaf_size, BLOCK_COMPONENTS), np.float32)
        blk[:, :3] = 3e37
        blk[:, 12] = -1.0
        tre_blocks = [blk.T.reshape(-1)]
        slot_src = [np.full(leaf_size, -1, np.int64)]
        slot_obj = [np.full(leaf_size, -1, np.int64)]

    return TreeletTable(
        tre_min=np.asarray(tre_min, np.float32),
        tre_max=np.asarray(tre_max, np.float32),
        tre_tris=np.asarray(tre_blocks, np.float32),
        slot_src=np.concatenate(slot_src).astype(np.int32),
        slot_obj=np.concatenate(slot_obj).astype(np.int32),
    )
