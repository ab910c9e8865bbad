"""Multi-process execution over a ``torch.distributed`` process group.

Counterpart of ``multimodalpromptretrieval_tpu/parallel/multihost.py``.
The processes form one default process group; data parallelism
(``parallel/mesh.py``) runs over it. The execution contract is the JAX
package's multi-controller one:

* every process runs the same program over the same host-side data (the
  data layer is deterministic per seed, so each process builds the same
  batches) and takes its own block of each batch's rows;
* every process makes the same sequence of collective calls;
* host artifacts (checkpoints, logs) are written by process 0 only
  (:func:`is_primary`), and :func:`barrier` orders a write before the
  other processes read it.

The backend is NCCL when each process has a card of its own, else gloo:
on the CPU, and for several processes that share one card (NCCL refuses
two ranks on one device). gloo's CUDA support covers ``broadcast`` and
``all_reduce`` only, so the port's collectives are written with
``all_reduce`` alone (a gather is the sum of zero-filled buffers).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device: Optional[str] = None) -> None:
    """Form (or join) the process group. Call once per process, before an
    experiment is built. Arguments left out come from torchrun's
    environment: ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK``.
    ``device="cpu"`` (or no CUDA) runs gloo on the host; otherwise the
    process's card is ``cuda:(LOCAL_RANK % device_count)`` (``LOCAL_RANK``
    defaults to the rank), made the current device, and the backend is
    NCCL when the processes on this host (``LOCAL_WORLD_SIZE``, default
    the world size) have a card each, else gloo."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                               f"{env['MASTER_PORT']}")
    world = int(env["WORLD_SIZE"] if num_processes is None
                else num_processes)
    rank = int(env["RANK"] if process_id is None else process_id)
    on_card = (device is None or torch.device(device).type == "cuda") \
        and torch.cuda.is_available()
    backend = "gloo"
    if on_card:
        torch.cuda.set_device(local_device_index(rank))
        local = int(env.get("LOCAL_WORLD_SIZE", world))
        if local <= torch.cuda.device_count():
            backend = "nccl"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)


def local_device_index(rank: Optional[int] = None) -> int:
    """This process's card: ``LOCAL_RANK`` (default ``rank``, default this
    process's rank) modulo the number of cards."""
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        local = process_index() if rank is None else rank
    return int(local) % torch.cuda.device_count()


def shutdown() -> None:
    """Leave the process group (a no-op when there is none)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    """The world size of the default group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns host artifacts (checkpoints, logs);
    also in an ordinary single-process run."""
    return process_index() == 0


def barrier() -> None:
    """Block until every process reaches this point: between a primary-only
    write and its use by the others. A no-op for one process."""
    if process_count() > 1:
        dist.barrier()
