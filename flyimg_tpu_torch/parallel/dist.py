"""Multi-process initialisation.

The port of ``flyimg_tpu/parallel/dist.py``: ``initialize_multihost`` joins
this process to a ``torch.distributed`` process group (``nccl`` between
CUDA processes, ``gloo`` between CPU ones) when a group is configured, and
``local_batch_slice`` is this process's share of a global batch. The
configuration is explicit — arguments, or the environment of the JAX
package (``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID``) or of
torchrun (``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``) — and
with none of it this is a single-process run. There is no cloud metadata
probe: NVIDIA hosts have no peer-discovery service to ask.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from flyimg_tpu_torch.device import resolve_device


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: Union[str, torch.device] = "cuda",
    timeout_s: Optional[float] = None,
) -> bool:
    """Join the process group of ``num_processes`` processes whose rank 0
    listens at ``coordinator_address`` (``host:port``); this process is
    rank ``process_id``. Arguments fall back to COORDINATOR_ADDRESS /
    NUM_PROCESSES / PROCESS_ID, then to torchrun's MASTER_ADDR /
    MASTER_PORT / WORLD_SIZE / RANK. Returns False, doing nothing, when
    none is configured; True once joined (or when already joined). The
    backend is ``nccl`` for a CUDA ``device``, ``gloo`` for the CPU."""
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = _env_int("NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("PROCESS_ID")
    if coordinator_address is None and num_processes is None:
        if "MASTER_ADDR" not in os.environ or "WORLD_SIZE" not in os.environ:
            return False
        coordinator_address = (
            f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        )
        num_processes = _env_int("WORLD_SIZE")
        process_id = _env_int("RANK")
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a process group needs a coordinator address, a process count and "
            f"this process's id; got {coordinator_address!r}, {num_processes!r}, "
            f"{process_id!r}"
        )
    if dist.is_initialized():
        return True
    dev = resolve_device(device)
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id), **kwargs,
    )
    return True


def local_batch_slice(global_batch: int) -> slice:
    """The slice of a global request batch this process owns (rank 0 of 1
    when no process group is joined)."""
    if dist.is_available() and dist.is_initialized():
        n, idx = dist.get_world_size(), dist.get_rank()
    else:
        n, idx = 1, 0
    per = global_batch // n
    return slice(idx * per, (idx + 1) * per)
