"""Joining a ``torch.distributed`` process group (counterpart of
``tpupt/dist/bootstrap.py``).

Every process of a sharded render calls ``init_distributed`` first, then
the entry points of ``dist.sharding`` on every rank:

    from tpupt_torch.dist.bootstrap import init_distributed
    init_distributed("localhost:29500", num_processes=2, process_id=rank)
"""

from __future__ import annotations

import torch.distributed as dist


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str = "nccl") -> None:
    """Rendezvous at ``coordinator`` ("host:port", a TCP store that rank 0
    opens) as rank ``process_id`` of ``num_processes``, with ``backend``
    ("nccl" for CUDA tensors on one card per rank, "gloo" for CPU tensors
    or several ranks on one card).  A no-op when ``coordinator`` and
    ``num_processes`` are both None (one process, no group)."""
    if coordinator is None and num_processes is None:
        return
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
