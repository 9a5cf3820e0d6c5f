"""One dense closest-hit step over pre-gathered pairs (counterpart of
``tpupt/accel/pallas_step.py``).

``winner_step`` launches the CUDA kernel ``winner_step_kernel``
(``csrc/treelet_kernels.cu``), which replaces the Pallas ``_step_kernel``:
a grid of as many 128-thread CTAs as fit on the card strides over the
rows, copying the next row's 13 x RL pair components, live flags and
slots into shared memory (cp.async, double-buffered) while it folds the
current one, two rays per thread, with the MT routine that the
closest-hit sweep also runs.  For CPU tensors it runs
``winner_step_plain``.
"""

from __future__ import annotations

import torch

from tpupt_torch.accel import kernels
from tpupt_torch.accel.packets import _ROW_KEYS, BIG, _dense_mt, _winner_fold


def winner_step_plain(rows, comps, live, slots):
    """Torch twin of ``winner_step``: MT over (sz, RL, p) pairs, then the
    strict-`<` fold over RL."""
    tri = [comps[:, c, :, None] for c in range(9)]
    ray = {k: rows[k][:, None, :] for k in _ROW_KEYS}
    ok, t = _dense_mt(tri, ray, ray["t"])
    ok = ok & (live[:, :, None] > 0.0)
    return _winner_fold(torch.where(ok, t, BIG), slots, *comps[:, 9:13].unbind(1))


def winner_step(rows, comps, live, slots):
    """One dense sweep step, the contract of ``winner_step_pallas``.

    rows: dict of rox..rdz, tmin, t (the per-lane t cap), each (sz, p) f32.
    comps: (sz, 13, RL) f32 component-major pair data.  live: (sz, RL) f32
    1/0 pair validity.  slots: (sz, RL) i32 global slot ids.
    Returns (t, slot, nx, ny, nz, obj), each (sz, p): the raw winner, with
    t = BIG and (0, 0, 0, 0, -1) where no pair hit.
    """
    if comps.device.type == "cpu":
        return winner_step_plain(rows, comps, live, slots)
    req = kernels.require
    req(comps.is_cuda, f"winner_step: unsupported device {comps.device}")
    sz, p = rows["rox"].shape
    rl = comps.shape[2]
    req(0 < p <= 1024, f"winner_step: row width {p} not in (0, 1024]")
    req(rl >= 1, "winner_step: a row needs at least one pair")
    req(tuple(comps.shape) == (sz, 13, rl), f"winner_step: comps {tuple(comps.shape)}")
    req(tuple(live.shape) == (sz, rl) and tuple(slots.shape) == (sz, rl),
        "winner_step: live/slots must be (sz, RL)")
    for k in _ROW_KEYS:
        req(tuple(rows[k].shape) == (sz, p), f"winner_step: rows[{k!r}] shape")
    f32 = [rows[k] for k in _ROW_KEYS] + [comps, live]
    for a in f32 + [slots]:
        req(a.device == comps.device and a.is_contiguous(),
            "winner_step: every input must be contiguous on the kernel's device")
    req(all(a.dtype == torch.float32 for a in f32) and slots.dtype == torch.int32,
        "winner_step: float32 rows/comps/live and int32 slots required")

    lib = kernels.load()
    smem = lib.tpupt_winner_step_smem_bytes(rl)
    limit = torch.cuda.get_device_properties(comps.device).shared_memory_per_block_optin
    req(smem <= limit, f"winner_step: {rl} pairs a row need {smem} B of shared memory > {limit}")
    out = [torch.empty((sz, p), dtype=dt, device=comps.device)
           for dt in (torch.float32, torch.int32) + (torch.float32,) * 4]
    if sz:
        err = lib.tpupt_winner_step(
            *[a.data_ptr() for a in f32], slots.data_ptr(), sz, p, rl,
            *[o.data_ptr() for o in out], kernels.stream_of(comps),
        )
        kernels.check(lib, err, "winner_step")
        winner_step.launches += 1
    return tuple(out)


winner_step.launches = 0
