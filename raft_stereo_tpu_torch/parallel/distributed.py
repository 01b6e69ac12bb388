"""The process group of data-parallel training (the JAX package's
``parallel/distributed.py``, over ``torch.distributed``).

One process per card: ``torchrun --nproc_per_node=N`` starts them and
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/
``MASTER_PORT``; ``initialize()`` forms the group from those (or from
explicit arguments), and each process trains its contiguous slice of
every global batch (``loader_shard_kwargs``) on a model wrapped in
``DistributedDataParallel``, which all-reduces the gradients.

    from raft_stereo_tpu_torch.parallel import distributed
    distributed.initialize()        # a no-op in a plain one-process run
    loader = StereoLoader(ds, batch_size=global_batch,
                          **distributed.loader_shard_kwargs())

The backend is NCCL for a card and gloo for the CPU unless the caller
names one.  A failed initialization raises: nothing falls back to another
backend or device.  NCCL runs one rank per card; gloo can also run
several ranks on one card (it reduces CUDA tensors through the host).
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# How long a collective may wait for a missing rank before it raises.
TIMEOUT = timedelta(minutes=10)


def _env_topology_present() -> bool:
    """A launcher started this process: torchrun's ``RANK`` and
    ``WORLD_SIZE``, or a rendezvous address with a world size."""
    return all(os.environ.get(k) for k in ("RANK", "WORLD_SIZE")) or bool(
        os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"))


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None,
               device: Union[None, str, torch.device] = None) -> None:
    """Form the process group; idempotent, and a no-op in a plain
    one-process run (no arguments, no launcher environment).

    ``init_method`` (e.g. ``tcp://localhost:29500``), ``world_size`` and
    ``rank`` default to torchrun's environment (``env://``).  ``backend``
    defaults to NCCL where ``device`` is a card (the card by default when
    there is one) and gloo otherwise.  With NCCL and ``LOCAL_RANK`` set,
    this process's current card becomes ``cuda:LOCAL_RANK``."""
    if dist.is_initialized():
        return
    if (init_method is None and world_size is None and rank is None
            and not _env_topology_present()):
        return
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    local_rank = os.environ.get("LOCAL_RANK")
    if device.type == "cuda" and local_rank is not None:
        torch.cuda.set_device(int(local_rank))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank,
                            timeout=TIMEOUT)
    log.info("distributed: rank %d of %d over %s", dist.get_rank(),
             dist.get_world_size(), backend)


def shutdown() -> None:
    """Destroy the process group where there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def collective_device() -> torch.device:
    """Where this group's small collectives place their tensors: the
    current card under NCCL, the CPU under gloo."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def any_process(flag: bool) -> bool:
    """Global OR of a per-process bool.

    A collective in a group of more than one: every process must call it
    as many times as the others.  The train loop calls it once per turn,
    with its own loader's exhaustion folded into ``flag``, so a stop
    requested on one process (SIGTERM) or a shorter loader makes every
    process leave the loop at the same step, before the checkpoint save
    that every process meets (otherwise the ranks that kept stepping
    would wait in the gradient all-reduce forever)."""
    if process_count() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def barrier() -> None:
    """Every process meets here (a no-op in one process)."""
    if process_count() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def local_devices_stable() -> List[torch.device]:
    """This process's devices in a stable order: the cards by index, or
    the CPU where there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def device_groups(group_size: int, n_groups: Optional[int] = None,
                  devices: Optional[Sequence[torch.device]] = None,
                  skip: int = 0) -> List[Tuple[torch.device, ...]]:
    """Disjoint ordered groups of ``group_size`` local devices after the
    first ``skip``; ``n_groups`` of them (None: as many as fit).  An empty
    list, never an error, when the devices cannot supply ``n_groups``
    full groups: the caller decides whether that is fatal."""
    if group_size < 1:
        raise ValueError(f"group_size={group_size} must be >= 1")
    if skip < 0:
        raise ValueError(f"skip={skip} must be >= 0")
    if devices is None:
        devices = local_devices_stable()
    pool = list(devices)[skip:]
    n_avail = len(pool) // group_size
    want = n_avail if n_groups is None else int(n_groups)
    if want < 0 or want > n_avail:
        return []
    return [tuple(pool[i * group_size:(i + 1) * group_size])
            for i in range(want)]


def loader_shard_kwargs() -> Dict[str, int]:
    """``StereoLoader`` arguments by which this process decodes only its
    contiguous slice of every global batch."""
    return {"process_index": process_index(),
            "process_count": process_count()}
