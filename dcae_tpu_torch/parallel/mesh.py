"""Data-parallel steps over torch.distributed, the dp axis of the JAX
package's parallel/mesh.py.

There XLA partitions a jitted step over a (dp, sp) mesh and inserts the
gradient psum. Here every process holds one device and a full copy of the
parameters; a dp step runs the one-device step on this rank's rows, then
all-reduces the gradients as a mean over dp, after the backward and before
the clip and the two Adams, in buckets of BUCKET_BYTES. The training noise
is drawn for the global batch and cut to this rank's rows
(entropy/ops.py: dp_noise), so a dp step equals the one-device step on the
whole batch, as the partitioned program does. Metrics are reduced to the
global batch's. Rank batches must be of one size: a mean of rank means is
the global mean only then.

The sp (spatial) axis is not ported (ROADMAP.md, Queue A). Entropy coding
stays dp-only by design, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from dcae_tpu_torch.entropy.ops import dp_noise
from dcae_tpu_torch.models.codec import resolve_device

BUCKET_BYTES = 25 << 20


@dataclasses.dataclass(frozen=True)
class Mesh:
    """dp: processes on the axis; rank: this process's place on it;
    group: the process group of the axis (None: one process without a
    process group, and no collective); device: this process's device."""
    dp: int
    rank: int
    group: Optional[object]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "sp": 1}


def make_mesh(n_devices: Optional[int] = None, sp: int = 1,
              device=None) -> Mesh:
    """The dp axis over every process of the process group (one device a
    process), or over this process alone when there is no group. device:
    this process's (default: its current card under NCCL, the CPU under
    gloo, else cuda)."""
    if sp != 1:
        raise NotImplementedError(
            "sp > 1: the spatial axis is not ported yet (ROADMAP.md, "
            "Queue A)")
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"n_devices {n_devices}: the dp axis spans every "
                         f"process of the group ({world}), one device each")
    if device is None:
        device = (("cuda" if dist.get_backend() == "nccl" else "cpu")
                  if grouped else None)
    d = resolve_device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dp=world, rank=dist.get_rank() if grouped else 0,
                group=dist.group.WORLD if grouped else None, device=d)


def shard_rows(batch, mesh: Mesh):
    """This rank's rows of a global batch (B % dp == 0): block `rank`."""
    b = batch.shape[0] // mesh.dp
    return batch[mesh.rank * b:(mesh.rank + 1) * b]


def broadcast(value, mesh: Mesh):
    """The primary rank's `value` (any picklable object) on every rank."""
    if mesh.group is None:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def _buckets(tensors: List[torch.Tensor], nbytes: int):
    bucket, size = [], 0
    for t in tensors:
        if bucket and (size + t.numel() * t.element_size() > nbytes
                       or t.dtype != bucket[0].dtype):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel() * t.element_size()
    if bucket:
        yield bucket


def all_reduce_mean_(tensors: List[torch.Tensor], mesh: Mesh) -> None:
    """tensors <- their mean over dp, in place, a bucket at a time (one
    flatten, one all-reduce and one multi-tensor copy a bucket: a step
    reduces some 1130 gradients, and the host sets its pace)."""
    for bucket in _buckets(tensors, BUCKET_BYTES):
        flat = _flatten_dense_tensors(bucket)
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.dp)
        torch._foreach_copy_(bucket, _unflatten_dense_tensors(flat, bucket))


@contextlib.contextmanager
def _gradients_averaged(model: torch.nn.Module, mesh: Mesh):
    """Inside: a backward through `model` ends with its gradients
    all-reduced as a mean over dp. The first accumulated gradient queues
    the reduction as the backward's final callback, so it runs once,
    after every gradient and before backward() returns."""
    params = [p for p in model.parameters() if p.requires_grad]
    queued = [False]

    def reduce_all() -> None:
        queued[0] = False
        all_reduce_mean_([p.grad for p in params if p.grad is not None],
                         mesh)

    def hook(_) -> None:
        if not queued[0]:
            queued[0] = True
            torch.autograd.Variable._execution_engine.queue_callback(
                reduce_all)

    handles = [p.register_post_accumulate_grad_hook(hook) for p in params]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _mean_metrics(metrics: Dict[str, torch.Tensor], mesh: Mesh
                  ) -> Dict[str, torch.Tensor]:
    """Rank means -> the global batch's: the mean over dp; a PSNR through
    its MSE (the global PSNR is that of the global MSE)."""
    keys = sorted(metrics)
    vals = torch.stack([
        10.0 ** (-metrics[k].float() / 10.0) if k == "psnr"
        else metrics[k].float() for k in keys])
    all_reduce_mean_([vals], mesh)
    return {k: (-10.0 * torch.log10(v) if k == "psnr" else v)
            for k, v in zip(keys, vals)}


def shard_train_step(train_step: Callable, mesh: Mesh) -> Callable:
    """train_step(state, batch) of make_train_step, run data-parallel: the
    batch is this rank's rows, the noise the global batch's, the gradients
    averaged over dp before the update, the metrics the global batch's.
    Without a process group it is train_step itself."""
    if mesh.group is None:
        return train_step

    def step(state, batch):
        with _gradients_averaged(state.model, mesh), \
                dp_noise(mesh.rank, mesh.dp):
            state, metrics = train_step(state, batch)
        return state, _mean_metrics(metrics, mesh)

    return step


def shard_eval_step(eval_step: Callable, mesh: Mesh) -> Callable:
    """eval_step(batch) of make_eval_step on this rank's rows, its metrics
    reduced to the global batch's."""
    if mesh.group is None:
        return eval_step

    def step(batch):
        return _mean_metrics(eval_step(batch), mesh)

    return step

