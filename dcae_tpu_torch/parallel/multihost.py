"""Process-group set-up, the JAX package's parallel/multihost.py for
torch.distributed: one process a device, NCCL between cards (gloo only when
the caller asks for the CPU); the (dp, sp) mesh's groups; and the
transports that carry a rank's tensors through the collectives.

Usage (per process; torchrun sets the environment itself):
    from dcae_tpu_torch.parallel import multihost
    device = multihost.initialize(coordinator="10.0.0.1:9876",
                                  num_processes=2, process_id=<rank>)
    mesh = make_mesh(device=device)      # parallel/mesh.py
    batch, global_b = multihost.local_batch_to_global(local_batch, mesh)
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

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


def mesh_groups(dp: int, sp: int):
    """(dp group, sp group) of this rank on a (dp, sp) mesh over the whole
    process group, rank = dp_rank * sp + sp_rank (the JAX mesh's
    reshape(dp, sp)): the dp group holds the ranks of this sp index, the
    sp group those of this dp index. Every rank creates every group, in
    one order, as torch.distributed requires. An axis of one rank has no
    group (None); an axis of every rank is the whole group."""
    if sp == 1 or dp == 1:
        world = dist.group.WORLD
        return (world if dp > 1 else None), (world if sp > 1 else None)
    rank = dist.get_rank()
    for s in range(sp):
        g = dist.new_group([d * sp + s for d in range(dp)])
        if rank % sp == s:
            dp_group = g
    for d in range(dp):
        g = dist.new_group([d * sp + s for s in range(sp)])
        if rank // sp == d:
            sp_group = g
    return dp_group, sp_group


class Transport:
    """How a rank's tensors go through the collectives: as they are, on
    their own device (NCCL with cards, gloo with the CPU). `name` says
    which."""

    def __init__(self, name: str):
        self.name = name

    def all_reduce_(self, t: torch.Tensor, group) -> None:
        """t <- its sum over the group, in place."""
        dist.all_reduce(t, group=group)

    def all_gather(self, t: torch.Tensor, group) -> List[torch.Tensor]:
        """Every rank's t (of one shape), in group rank order."""
        out = [torch.empty_like(t)
               for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, t, group=group)
        return out

    def exchange(self, sends: Sequence[Tuple[int, torch.Tensor]],
                 recvs: Sequence[Tuple[int, torch.Tensor]], group) -> None:
        """Point to point: each (peer, tensor) of sends goes to the peer
        (a global rank), each of recvs is filled from its peer; every
        rank of the group calls it, with matching pairs."""
        ops = [dist.P2POp(dist.isend, t, peer, group) for peer, t in sends]
        ops += [dist.P2POp(dist.irecv, t, peer, group) for peer, t in recvs]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()


class HostStaged(Transport):
    """gloo with the ranks' tensors on cards. gloo's all-reduce and
    all-gather take card tensors (they stage through the host inside
    gloo), but its point-to-point sends and receives do not
    (chip_smoke.py's sp phase probes each), so the halo exchange copies
    each tensor to the host, sends it there, and copies what comes back
    to its card. The ranks' tensors and every kernel stay on the card;
    only the exchanged rows cross. This is how two ranks share one card,
    which NCCL refuses."""

    def __init__(self):
        super().__init__("gloo-host-staged")

    def exchange(self, sends, recvs, group) -> None:
        host = [(peer, torch.empty(t.shape, dtype=t.dtype))
                for peer, t in recvs]
        super().exchange([(peer, t.cpu()) for peer, t in sends], host,
                         group)
        for (_, t), (_, h) in zip(recvs, host):
            t.copy_(h)


def transport(device: torch.device) -> Transport:
    """The process group's transport for tensors on `device`: host-staged
    for gloo with card tensors, direct otherwise."""
    backend = dist.get_backend()
    if backend == "gloo" and device.type == "cuda":
        return HostStaged()
    return Transport(backend)
