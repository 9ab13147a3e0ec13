"""Process-group set-up, the JAX package's parallel/multihost.py for
torch.distributed: one process a device, NCCL between cards (gloo only when
the caller asks for the CPU).

Usage (per process; torchrun sets the environment itself):
    from dcae_tpu_torch.parallel import multihost
    device = multihost.initialize(coordinator="10.0.0.1:9876",
                                  num_processes=2, process_id=<rank>)
    mesh = make_mesh(device=device)      # parallel/mesh.py
    batch, global_b = multihost.local_batch_to_global(local_batch, mesh)
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dcae_tpu_torch.models.codec import resolve_device


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return None


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None) -> torch.device:
    """torch.distributed.init_process_group with the JAX package's
    environment fallbacks (COORDINATOR_ADDRESS "host:port", NUM_PROCESSES,
    PROCESS_ID) and torchrun's (MASTER_ADDR / MASTER_PORT, WORLD_SIZE,
    RANK, LOCAL_RANK). device: cuda (default: NCCL, this process on card
    LOCAL_RANK, else process_id modulo the cards) or cpu (gloo). Returns
    this process's device."""
    d = resolve_device(device)
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = _env_int("NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("PROCESS_ID", "RANK")
    if num_processes is None or process_id is None:
        raise ValueError("initialize needs the number of processes and "
                         "this process's id (arguments, NUM_PROCESSES / "
                         "PROCESS_ID, or torchrun's WORLD_SIZE / RANK)")
    if d.type == "cuda":
        local = _env_int("LOCAL_RANK")
        index = (d.index if d.index is not None else
                 local if local is not None
                 else process_id % torch.cuda.device_count())
        d = torch.device("cuda", index)
        torch.cuda.set_device(d)
    init = (f"tcp://{coordinator}" if coordinator else "env://")
    dist.init_process_group("nccl" if d.type == "cuda" else "gloo",
                            init_method=init, world_size=num_processes,
                            rank=process_id)
    return d


def is_primary() -> bool:
    """Rank 0 (or no process group): the process that checkpoints and
    logs."""
    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0


def local_batch_to_global(local_batch, mesh) -> Tuple[torch.Tensor, int]:
    """This process's rows of the global batch, on its device, and the
    global batch size (local rows x dp): each rank keeps its own rows, and
    together they are the batch a one-device program would take."""
    t = torch.as_tensor(np.asarray(local_batch)) \
        if not torch.is_tensor(local_batch) else local_batch
    return t.to(mesh.device), int(t.shape[0]) * mesh.dp
