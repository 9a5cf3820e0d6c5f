"""The slot table's gradient from the winner triangles' cotangents: the
hand-written CUDA kernel ``slot_scatter_kernel``
(``csrc/diff_trip_kernels.cu``) and its torch twin.

It replaces the XLA scatter of the JAX package's ``_fetch_tri_rows``
backward (``tpupt/render/intersect.py:436``): each lane's (9,) cotangent
of its winner triangle's p0, e1, e2 is added into row ``slot`` of the
(K*L, 9) slot table's gradient.  Lanes without a triangle (slot -1) add
nothing: their cotangent is zero, and clamped to row 0 they would all
contend for one row.

It serves the body route's ``intersect._FetchTriRows`` (lit
differentiable renders, and any intersector passed in).  The
differentiable trip runs the same scatter inside ``diff_trip_bwd``'s
kernel and launches this one never.

The kernel is bound by its 4-byte slot a lane and a triangle lane's row
(most lanes have none: 90% of bunny's first bounce): a persistent grid,
each thread's four slots read in one 16-byte load and passed round the
warp so that each round holds 32 neighbouring lanes; a warp with no row in
a round leaves at once, only a lane with a row reads it, and the runs of
one slot over neighbouring lanes sum their rows by a segmented shuffle
tree before one lane of each run makes the row's 9 atomics.
"""

from __future__ import annotations

import torch

from tpupt_torch.accel import kernels
from tpupt_torch.utils import trace


def slot_scatter_plain(g: torch.Tensor, slot: torch.Tensor, cot: torch.Tensor) -> torch.Tensor:
    """Torch twin of ``slot_scatter``: ``index_add_`` of the rows with
    slot >= 0."""
    keep = slot >= 0
    return g.index_add_(0, slot[keep].long(), cot[keep])


def slot_scatter(g: torch.Tensor, slot: torch.Tensor, cot: torch.Tensor) -> torch.Tensor:
    """``g[slot[i]] += cot[i]`` for every lane i with slot[i] >= 0, in
    place; returns ``g``.

    g: (rows, 9) float32, contiguous.  slot: (N,) integer.  cot: (N, 9)
    float32 with any strides (``_FetchTriRows``' (N, 9) stack, or a (9, N)
    buffer as its transpose).  A slot past g's rows
    is an error, as in ``index_add_`` (the kernel's assert fails the
    launch).  Atomic adds: the sum of a row's lanes comes in no fixed
    order.  Launches are counted under "slot_scatter" (``utils.trace``)."""
    if g.device.type == "cpu":
        return slot_scatter_plain(g, slot, cot)
    req = kernels.require
    n = slot.shape[0]
    req(g.is_cuda and g.dtype == torch.float32 and g.dim() == 2 and g.shape[1] == 9
        and g.is_contiguous(), "slot_scatter: g must be contiguous (rows, 9) float32 on the card")
    req(tuple(cot.shape) == (n, 9) and cot.dtype == torch.float32 and cot.device == g.device,
        f"slot_scatter: cot must be ({n}, 9) float32 on {g.device}")
    req(slot.dim() == 1 and not slot.is_floating_point() and slot.device == g.device,
        f"slot_scatter: slot must be (N,) integers on {g.device}")
    req(g.shape[0] < 2**31 and max(n * abs(cot.stride(0)), 9 * abs(cot.stride(1))) < 2**31,
        "slot_scatter: past int32")
    slot = slot.to(torch.int32).contiguous()
    if n:
        lib = kernels.load()
        err = lib.tpupt_slot_scatter(g.data_ptr(), g.shape[0], slot.data_ptr(), cot.data_ptr(), n,
                                     cot.stride(0), cot.stride(1), kernels.stream_of(g))
        kernels.check(lib, err, "slot_scatter")
        trace.launched("slot_scatter")
    return g
