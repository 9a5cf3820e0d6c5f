"""SAH BVH construction on the host (counterpart of ``tpupt/accel/bvh.py``).

Split policy: one triangle per leaf; split axis = largest extent of the
centroid bounds; 2 leaves -> inner node with children ordered by centroid;
<= 4 -> median split; else 12-bucket SAH with cost
0.125 + sum(count_i * SA_i) / SA.  Flattened depth-first pre-order with
skip links.

The numpy builder and the native one (``accel/native.py``) can order the
children of small nodes differently (argpartition vs nth_element), and the
treelet table depends on that order.  ``build_bvh`` therefore dispatches
exactly as the JAX package does: the native builder, compiled from the
same C++ source with the same flags, for meshes of 64 triangles and more,
the numpy builder below that or when no C++ compiler is found.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_BUCKETS = 12
_SENTINEL = -1


@dataclass
class FlatBVH:
    """Flattened depth-first BVH over one mesh's triangles.

    node_tri[i] >= 0  => leaf holding global triangle id node_tri[i]
    node_skip[i]      => next node in traversal order when skipping the
                         subtree rooted at i (mesh-local; -1 = done)
    The first child of an inner node i is always i + 1 (pre-order).
    """

    node_min: np.ndarray  # (B, 3) f32
    node_max: np.ndarray  # (B, 3) f32
    node_tri: np.ndarray  # (B,) i32
    node_skip: np.ndarray  # (B,) i32

    @property
    def num_nodes(self) -> int:
        return int(self.node_tri.shape[0])


def _max_extent_axis(ext: np.ndarray) -> int:
    """Reference AABB::max_extent tie-breaking (src/lib/aabb.hpp:46-50)."""
    if ext[0] > ext[1] and ext[0] > ext[2]:
        return 0
    return 1 if ext[1] > ext[2] else 2


def build_bvh(positions: np.ndarray, tris: np.ndarray) -> FlatBVH:
    """Build a flat BVH. positions: (V, 3) float, tris: (T, 3) int."""
    if len(tris) >= 64:
        from tpupt_torch.accel import native

        flat = native.build_bvh_native(positions, tris)
        if flat is not None:
            return flat
    return _build_bvh_numpy(positions, tris)


def _build_bvh_numpy(positions: np.ndarray, tris: np.ndarray) -> FlatBVH:
    positions = np.asarray(positions, np.float32)
    tris = np.asarray(tris, np.int64)
    T = tris.shape[0]
    if T == 0:
        raise ValueError("Cannot create BVH for empty mesh")

    v = positions[tris]  # (T, 3, 3)
    leaf_min = v.min(axis=1).astype(np.float64)
    leaf_max = v.max(axis=1).astype(np.float64)
    return build_bvh_from_aabbs(leaf_min, leaf_max)


def build_bvh_from_aabbs(leaf_min: np.ndarray, leaf_max: np.ndarray) -> FlatBVH:
    """Build the flat DFS+skip BVH over arbitrary leaf AABBs; ``node_tri``
    holds the leaf index."""
    T = leaf_min.shape[0]
    leaf_min = np.asarray(leaf_min, np.float64)
    leaf_max = np.asarray(leaf_max, np.float64)
    centers = (leaf_min + leaf_max) * 0.5

    # --- recursive build over a permutation, explicit stack ----------------
    # tree node arrays (grown as python lists, converted at the end)
    n_is_leaf: list[bool] = []
    n_tri: list[int] = []
    n_left: list[int] = []
    n_right: list[int] = []
    n_min: list[np.ndarray] = []
    n_max: list[np.ndarray] = []

    def new_node(is_leaf: bool, tri: int = -1) -> int:
        n_is_leaf.append(is_leaf)
        n_tri.append(tri)
        n_left.append(-1)
        n_right.append(-1)
        n_min.append(None)  # patched later for inner nodes
        n_max.append(None)
        return len(n_is_leaf) - 1

    perm = np.arange(T)

    # Stack entries: (lo, hi, parent, is_left). parent == -1 for the root.
    stack = [(0, T, -1, False)]
    root = -1
    while stack:
        lo, hi, parent, is_left = stack.pop()
        count = hi - lo
        sub = perm[lo:hi]

        if count == 1:
            t = int(sub[0])
            nid = new_node(True, t)
            n_min[nid] = leaf_min[t]
            n_max[nid] = leaf_max[t]
        else:
            # centroid bounds -> split axis
            c = centers[sub]
            cb_min, cb_max = c.min(axis=0), c.max(axis=0)
            axis = _max_extent_axis(cb_max - cb_min)
            key = c[:, axis]

            if count == 2:
                # order the two children by centroid (bvh.cpp:88-95)
                if key[0] > key[1]:
                    perm[lo], perm[hi - 1] = perm[hi - 1], perm[lo]
                mid = lo + 1
            elif count <= 4:
                # median split via argpartition (≈ std::nth_element,
                # bvh.cpp:98-108)
                half = count // 2
                order = np.argpartition(key, half)
                perm[lo:hi] = sub[order]
                mid = lo + half
            else:
                # 12-bucket SAH (bvh.cpp:115-182)
                extent = cb_max[axis] - cb_min[axis]
                if extent <= 0.0:
                    mid = lo + count // 2  # degenerate: all centroids equal
                else:
                    offs = (key - cb_min[axis]) / extent
                    b = np.minimum(
                        (offs * _BUCKETS).astype(np.int64), _BUCKETS - 1
                    )
                    # per-bucket counts and bounds
                    counts = np.bincount(b, minlength=_BUCKETS)
                    bkt_min = np.full((_BUCKETS, 3), np.inf)
                    bkt_max = np.full((_BUCKETS, 3), -np.inf)
                    np.minimum.at(bkt_min, b, leaf_min[sub])
                    np.maximum.at(bkt_max, b, leaf_max[sub])

                    # prefix/suffix unions -> SAH cost after each bucket
                    pre_min = np.minimum.accumulate(bkt_min, axis=0)
                    pre_max = np.maximum.accumulate(bkt_max, axis=0)
                    suf_min = np.minimum.accumulate(bkt_min[::-1], axis=0)[::-1]
                    suf_max = np.maximum.accumulate(bkt_max[::-1], axis=0)[::-1]
                    pre_cnt = np.cumsum(counts)

                    def area(bmin, bmax):
                        d = np.maximum(bmax - bmin, 0.0)
                        return 2.0 * (
                            d[..., 0] * d[..., 1]
                            + d[..., 0] * d[..., 2]
                            + d[..., 1] * d[..., 2]
                        )

                    total_area = area(
                        leaf_min[sub].min(axis=0), leaf_max[sub].max(axis=0)
                    )
                    a0 = area(pre_min[:-1], pre_max[:-1])
                    a1 = area(suf_min[1:], suf_max[1:])
                    c0 = pre_cnt[:-1]
                    c1 = count - c0
                    cost = 0.125 + (c0 * a0 + c1 * a1) / max(total_area, 1e-30)
                    split = int(np.argmin(cost))

                    left_mask = b <= split
                    nl = int(left_mask.sum())
                    if nl == 0 or nl == count:
                        mid = lo + count // 2  # degenerate partition fallback
                        order = np.argpartition(key, count // 2)
                        perm[lo:hi] = sub[order]
                    else:
                        order = np.argsort(~left_mask, kind="stable")
                        perm[lo:hi] = sub[order]
                        mid = lo + nl

            nid = new_node(False)
            # children pushed right-then-left so left pops (and builds) first;
            # order does not matter for correctness here, only node ids.
            stack.append((mid, hi, nid, False))
            stack.append((lo, mid, nid, True))

        if parent < 0:
            root = nid
        elif is_left:
            n_left[parent] = nid
        else:
            n_right[parent] = nid

    # --- inner AABBs: children always have larger ids than parents ----------
    for i in range(len(n_is_leaf) - 1, -1, -1):
        if not n_is_leaf[i]:
            l, r = n_left[i], n_right[i]
            n_min[i] = np.minimum(n_min[l], n_min[r])
            n_max[i] = np.maximum(n_max[l], n_max[r])

    # --- depth-first pre-order flatten with skip links ----------------------
    n_count = np.zeros(len(n_is_leaf), np.int64)  # triangle count per subtree
    for i in range(len(n_is_leaf) - 1, -1, -1):
        n_count[i] = 1 if n_is_leaf[i] else n_count[n_left[i]] + n_count[n_right[i]]

    B = 2 * T - 1
    out_min = np.empty((B, 3), np.float32)
    out_max = np.empty((B, 3), np.float32)
    out_tri = np.empty((B,), np.int32)
    out_skip = np.empty((B,), np.int32)

    # (node, skip) pre-order emit; first child of i sits at i+1, right child
    # at i + 1 + size(left) with size = 2*count - 1.
    emit = [(root, _SENTINEL)]
    pos = 0
    while emit:
        node, skip = emit.pop()
        out_min[pos] = n_min[node]
        out_max[pos] = n_max[node]
        out_skip[pos] = skip
        if n_is_leaf[node]:
            out_tri[pos] = n_tri[node]
        else:
            out_tri[pos] = -1
            right_pos = pos + 1 + (2 * int(n_count[n_left[node]]) - 1)
            emit.append((n_right[node], skip))
            emit.append((n_left[node], right_pos))
        pos += 1
    assert pos == B

    return FlatBVH(out_min, out_max, out_tri, out_skip)
