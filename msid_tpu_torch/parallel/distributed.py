"""Process-group entry of the port: counterpart of ``msid_tpu/parallel/distributed.py``.

``torchrun --nproc_per_node N -m msid_tpu_torch.scripts.train ...`` starts
N processes with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
and ``MASTER_PORT`` set; ``initialize_from_env`` joins them into one
process group, NCCL for cards and gloo for the CPU, each rank on the card
``cuda:LOCAL_RANK``. With none of these variables set it returns False:
the single-process path, as the JAX function does.

One deliberate divergence: when the variables are set and joining fails
(a rank whose card is missing, an address no rank answers at, a rank that
does not arrive within ``timeout_s``), it raises, where the JAX function
warns and carries on as one process. Under torchrun a silent single
process would train on one device's rows as if they were the batch, and
hide the fault.

The JAX module's ``host_local_batch_to_global`` has no counterpart: a
rank never assembles the global batch, it keeps its own rows of it
(``data/pipeline.py`` loads them, ``parallel.mesh.shard_batch`` cuts them
from a global batch).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 300.0
_rank_device: Optional[torch.device] = None


def rank_device() -> Optional[torch.device]:
    """This rank's device, once ``initialize_from_env`` has joined a group."""
    return _rank_device


def initialize_from_env(device: str | torch.device = "cuda", backend: Optional[str] = None,
                        timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group torchrun's environment describes. Returns
    True when this process is a rank of one (also when it already was),
    False when the environment describes none. ``device`` is the kind of
    device a rank runs on: ``cuda`` gives rank ``cuda:LOCAL_RANK`` and the
    NCCL backend, ``cpu`` gloo (``backend`` overrides). Every collective,
    the rendezvous included, fails after ``timeout_s``. Raises when the
    card is missing or joining fails."""
    global _rank_device
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ and "WORLD_SIZE" not in os.environ:
        return False
    missing = [v for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if not os.environ.get(v)]
    if missing:
        raise RuntimeError(f"torchrun environment incomplete: {missing} not set")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available() or local >= torch.cuda.device_count():
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise RuntimeError(f"rank {rank}: no card cuda:{local} (this machine has "
                               f"{have}); pass --device cpu for gloo on the CPU")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _rank_device = device
    logger.info("distributed: rank %d/%d on %s over %s", rank, world, device, backend)
    return True


def joined_from_env(device: str | torch.device) -> tuple[str | torch.device, bool]:
    """For a CLI: ``initialize_from_env(device)``, then ``(the device to run
    on, whether this call joined a group)``: the rank's device under
    torchrun, ``device`` as given otherwise (or when a group was already
    up, whose owner then leaves it)."""
    already = dist.is_available() and dist.is_initialized()
    joined = initialize_from_env(device) and not already
    return (rank_device() or device), joined


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    global _rank_device
    if dist.is_initialized():
        dist.destroy_process_group()
    _rank_device = None
