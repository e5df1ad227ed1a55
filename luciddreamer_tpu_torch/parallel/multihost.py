"""Multi-process set-up on ``torch.distributed``, the twin of
``luciddreamer_tpu/parallel/multihost.py``: ``initialize`` creates the
default process group (NCCL for CUDA, gloo for the CPU), and the helpers
split host-side work (cameras, frames) by process.

Nothing here discovers a cluster: the coordinator's address, the number of
processes and this process's rank come from the arguments or from the
variables ``torchrun`` sets (``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``; ``LOCAL_RANK`` picks the card).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from luciddreamer_tpu_torch.device import resolve_device


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device=None) -> bool:
    """``init_process_group`` at ``tcp://<coordinator_address>`` (host:port)
    for ``num_processes`` ranks.  Returns False and does nothing with no
    coordinator and at most one process.  The backend is NCCL on CUDA
    (``device=None``) and gloo for ``device="cpu"``; a missing NCCL
    raises, there is no fallback."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes in (None, 1):
        return False
    if coordinator_address is None or num_processes is None:
        raise ValueError("a process group needs a coordinator address and "
                         "the number of processes")
    if process_id is None:
        if num_processes != 1:
            raise ValueError("process_id is needed with several processes")
        process_id = 0
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL backend")
        local = int(os.environ.get("LOCAL_RANK",
                                   process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {dev}")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def local_shard(items: list, axis_size: int | None = None,
                index: int | None = None) -> list:
    """Round-robin split of host-side work across processes."""
    grouped = dist.is_initialized()
    n = axis_size if axis_size is not None else (
        dist.get_world_size() if grouped else 1)
    i = index if index is not None else (dist.get_rank() if grouped else 0)
    return items[i::n]


def global_mesh(data: int = 1, tiles: int | None = None, device=None):
    """A (data, tiles) mesh over every process of the job."""
    from luciddreamer_tpu_torch.parallel.sharded import make_mesh

    return make_mesh(data=data, tiles=tiles, device=device)
