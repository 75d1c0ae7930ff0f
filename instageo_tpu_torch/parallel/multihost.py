"""The processes of a run: one per card, started by ``torchrun``.

Counterpart of ``instageo_tpu/parallel/multihost.py``. ``torchrun``
(``python -m torch.distributed.run --nproc-per-node N ...``) starts one
process per card and gives each ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``
and ``MASTER_ADDR``/``MASTER_PORT``; ``initialize_multihost`` joins them
into one process group (NCCL on ``cuda``, gloo on the CPU). A process that
``torchrun`` did not start (no ``WORLD_SIZE``) is a run of its own, and the
call does nothing. Under ``torchrun`` a failed initialisation raises: the
JAX package carries on single-process after logging the failure, which
would have N processes each train the whole run on its own.

``host_local_to_global`` gives a rank its rows of the global batch, and
``aggregate_metrics`` sums metric accumulators over the ranks that hold
different rows, in float64 for floats (exact integers up to 2^53) and in
int64 for counts.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Any, Iterable, Optional

import torch
import torch.distributed as dist

from instageo_tpu_torch.parallel.mesh import collectives, shard_batch

log = logging.getLogger(__name__)


def initialize_multihost(device_type: str = "cuda", init_method: Optional[str] = None,
                         world_size: Optional[int] = None, rank: Optional[int] = None) -> bool:
    """Join the run's process group; True when one exists after the call.

    ``world_size`` and ``rank`` default to ``torchrun``'s ``WORLD_SIZE`` and
    ``RANK``, ``init_method`` to ``env://`` (``MASTER_ADDR``/``PORT``). On
    ``cuda`` the process takes card ``LOCAL_RANK`` and NCCL; on the CPU,
    gloo. Idempotent. Without a world size (no ``torchrun``) it does
    nothing and returns False."""
    if dist.is_initialized():
        return True
    env_world = os.environ.get("WORLD_SIZE")
    if world_size is None and env_world is None:
        return False
    world_size = int(env_world if world_size is None else world_size)
    rank = int(os.environ.get("RANK", "0") if rank is None else rank)
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"initialize_multihost runs on cuda or cpu, not {device_type}")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(minutes=10))
    log.info("torch.distributed initialised: rank %d of %d (%s)", rank, world_size, backend)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0, or a process outside any group: the one that writes the run
    directory, the checkpoints and the logs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def host_local_to_global(batch: Any, mesh, accum: int = 1) -> Any:
    """This rank's rows of a global batch (an array or a tuple of them):
    ``mesh.shard_batch``. Without a mesh, the batch as it is."""
    return shard_batch(batch, mesh, accum)


def aggregate_metrics(tensors: Iterable[torch.Tensor], group=None) -> None:
    """Sum metric accumulators over ``group`` (every rank by default), in
    place: floating tensors in float64, integer tensors in int64, then back
    in their own dtype; one all-reduce per kind. Without a process group,
    nothing."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return
    tensors = list(tensors)
    for wide in (torch.float64, torch.int64):
        picked = [t for t in tensors if t.is_floating_point() == (wide == torch.float64)]
        if not picked:
            continue
        flat = torch.cat([t.reshape(-1).to(wide) for t in picked])
        dist.all_reduce(flat, group=group)
        collectives["all_reduce"].add()
        offset = 0
        for t in picked:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n
