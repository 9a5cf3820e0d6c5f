"""Per-packet closest-hit walk over the world treelet table (counterpart
of ``tpupt/accel/pallas_sweep.py``).

``treelet_closest_hit`` launches the CUDA kernel
``treelet_closest_hit_kernel`` (``csrc/treelet_kernels.cu``), which
replaces the Pallas ``_sweep_kernel`` together with the XLA cull that fed
it: one 256-thread block per packet computes its treelet entry distances,
then walks its treelets front to back, each thread folding its ray over
the treelet's L triangles.  For CPU tensors it runs
``treelet_closest_hit_plain``, the lockstep loop described below.
"""

from __future__ import annotations

import torch

from tpupt_torch.accel import kernels
from tpupt_torch.accel.packets import _ROW_KEYS, BIG, PACKET, _entry_dense
from tpupt_torch.accel.step_kernel import winner_step_plain


def treelet_closest_hit_plain(rows, act_p, tre_min, tre_max, tre_tris, leaf):
    """Torch twin of ``treelet_closest_hit``: a lockstep loop, vectorized
    over packets, that advances every live packet by ONE treelet per step
    (argmin over the remaining entries, lowest index on exact ties), runs
    the dense step over its L pairs and keeps the closest hit.  A packet
    whose next entry lies beyond every live lane's best t is done; it stays
    done because neither its entries nor its t change any more."""
    np_, p = rows["rox"].shape
    K = tre_min.shape[0]
    dev = tre_tris.device
    entry = _entry_dense(tre_min, tre_max, rows, act_p)
    t = rows["t"].clone()
    slot = torch.full((np_, p), -1, dtype=torch.int32, device=dev)
    nx, ny, nz = (torch.zeros((np_, p), device=dev) for _ in range(3))
    obj = torch.full((np_, p), -1.0, device=dev)
    blocks = tre_tris.view(K, 13, leaf)
    ar = torch.arange(np_, device=dev)
    iota_l = torch.arange(leaf, dtype=torch.int32, device=dev)
    for _ in range(K):
        ent, tid = torch.min(entry, dim=1)  # first index on ties
        valid = (ent < BIG) & (ent <= t.amax(dim=1))
        if not bool(valid.any()):
            break
        entry[ar, tid] = torch.where(valid, BIG, ent)
        safe = torch.where(valid, tid, 0)
        w = winner_step_plain(
            dict(rows, t=t), blocks[safe], valid[:, None].expand(np_, leaf).float(),
            safe[:, None].to(torch.int32) * leaf + iota_l,
        )
        got = w[0] < BIG  # a later visit replaces an equal t
        t = torch.where(got, w[0], t)
        slot = torch.where(got, w[1], slot)
        nx = torch.where(got, w[2], nx)
        ny = torch.where(got, w[3], ny)
        nz = torch.where(got, w[4], nz)
        obj = torch.where(got, w[5], obj)
    return t, slot, nx, ny, nz, obj


def treelet_closest_hit(rows, act_p, tre_min, tre_max, tre_tris, leaf):
    """Closest hit per lane for packed rays (``packets._pack_rows``).

    rows: dict of rox..rdz, tmin, t (seed best t, -BIG on dead lanes), each
    (np, 256) f32.  act_p: (np, 256) bool.  tre_min/tre_max: (K, 3) f32.
    tre_tris: (K, 13 * leaf) f32.  Returns (t, slot, nx, ny, nz, obj), each
    (np, 256): lanes without a mesh hit keep their seed t, slot -1, normal
    0 and obj -1.
    """
    if tre_tris.device.type == "cpu":
        return treelet_closest_hit_plain(rows, act_p, tre_min, tre_max, tre_tris, leaf)
    req = kernels.require
    req(tre_tris.is_cuda, f"treelet_closest_hit: unsupported device {tre_tris.device}")
    np_, p = rows["rox"].shape
    K = tre_min.shape[0]
    req(p == PACKET, f"treelet_closest_hit: packets must be {PACKET} wide, got {p}")
    req(tuple(tre_min.shape) == (K, 3) and tuple(tre_max.shape) == (K, 3),
        "treelet_closest_hit: tre_min/tre_max must be (K, 3)")
    req(tuple(tre_tris.shape) == (K, 13 * leaf),
        f"treelet_closest_hit: tre_tris {tuple(tre_tris.shape)} != ({K}, {13 * leaf})")
    req(tuple(act_p.shape) == (np_, p) and act_p.dtype == torch.bool,
        "treelet_closest_hit: act_p must be (np, 256) bool")
    f32 = [rows[k] for k in _ROW_KEYS] + [tre_min, tre_max, tre_tris]
    for k in _ROW_KEYS:
        req(tuple(rows[k].shape) == (np_, p), f"treelet_closest_hit: rows[{k!r}] shape")
    for a in f32 + [act_p]:
        req(a.device == tre_tris.device and a.is_contiguous(),
            "treelet_closest_hit: every input must be contiguous on one device")
    req(all(a.dtype == torch.float32 for a in f32),
        "treelet_closest_hit: float32 inputs required")

    lib = kernels.load()
    smem = lib.tpupt_treelet_smem_bytes(K, leaf)
    limit = torch.cuda.get_device_properties(tre_tris.device).shared_memory_per_block_optin
    req(smem <= limit,
        f"treelet_closest_hit: {K} treelets need {smem} B of shared memory > {limit}")
    dev = tre_tris.device
    out = [torch.empty((np_, p), dtype=dt, device=dev)
           for dt in (torch.float32, torch.int32) + (torch.float32,) * 4]
    if np_:
        err = lib.tpupt_treelet_closest_hit(
            *[rows[k].data_ptr() for k in _ROW_KEYS], act_p.data_ptr(),
            tre_min.data_ptr(), tre_max.data_ptr(), tre_tris.data_ptr(),
            np_, K, leaf, *[o.data_ptr() for o in out], kernels.stream_of(tre_tris),
        )
        kernels.check(lib, err, "treelet_closest_hit")
        treelet_closest_hit.launches += 1
    return tuple(out)


treelet_closest_hit.launches = 0
