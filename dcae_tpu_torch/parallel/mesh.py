"""Data- and spatial-parallel steps over torch.distributed, the (dp, sp)
mesh of the JAX package's parallel/mesh.py.

There XLA partitions a jitted step over the mesh and inserts the gradient
psum and the halo exchanges. Here every process holds one device and a
full copy of the parameters; rank = dp_rank * sp + sp_rank. A step runs
the one-device step on this dp index's rows of the batch; with sp > 1 the
sp ranks of one dp index hold those rows whole and split g_a and g_s over
image rows (parallel/spatial.py), while everything between them runs alike
on every sp rank. After the backward and before the clip and the two
Adams, the gradients are all-reduced as a mean over the whole world, in
buckets of BUCKET_BYTES: every sp rank back-propagates the whole,
replicated loss, so a parameter's gradients summed over an sp group are
sp times the one-device gradient of those rows, and the world's mean is
the mean over dp (tests/test_torch_spatial.py holds this rule). The
training noise is drawn for the global batch and cut to the dp index's
rows (entropy/ops.py: dp_noise), so a step equals the one-device step on
the whole batch, as the partitioned program does. Metrics are reduced
over dp to the global batch's. Rank batches must be of one size: a mean
of rank means is the global mean only then.

Entropy coding stays dp-only by design, as in the JAX package.
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
from dcae_tpu_torch.parallel import multihost
from dcae_tpu_torch.parallel.spatial import bands
from dcae_tpu_torch.train.step_graph import after_backward
from dcae_tpu_torch.utils.profiling import span

BUCKET_BYTES = 25 << 20


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, sp) mesh of processes, one device each. dp_rank / sp_rank:
    this process's place; group: the whole process group (None: one
    process without a process group, and no collective); dp_group: the
    ranks of this sp index, sp_group: those of this dp index (None for an
    axis of one); device: this process's device; transport: how its
    tensors go through the collectives (multihost.Transport)."""
    dp: int
    sp: int
    dp_rank: int
    sp_rank: int
    group: Optional[object]
    dp_group: Optional[object]
    sp_group: Optional[object]
    device: torch.device
    transport: Optional[multihost.Transport]

    @property
    def rank(self) -> int:
        """The process's rank in the whole group."""
        return self.dp_rank * self.sp + self.sp_rank

    @property
    def world(self) -> int:
        return self.dp * self.sp

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "sp": self.sp}


def make_mesh(n_devices: Optional[int] = None, sp: int = 1,
              device=None) -> Mesh:
    """The (dp, sp) mesh over every process of the process group (one
    device a process; dp = world / sp), or this process alone when there
    is no group (then sp must be 1). device: this process's (default: its
    current card under NCCL, the CPU under gloo, else cuda). Raises when
    sp does not divide the world."""
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"n_devices {n_devices}: the mesh spans every "
                         f"process of the group ({world}), one device each")
    if sp < 1 or world % sp:
        raise ValueError(f"sp = {sp} does not divide the {world} processes "
                         "of the group (one device a process)")
    if device is None:
        device = (("cuda" if dist.get_backend() == "nccl" else "cpu")
                  if grouped else None)
    d = resolve_device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    if not grouped:
        return Mesh(dp=1, sp=1, dp_rank=0, sp_rank=0, group=None,
                    dp_group=None, sp_group=None, device=d, transport=None)
    dp = world // sp
    rank = dist.get_rank()
    dp_group, sp_group = multihost.mesh_groups(dp, sp)
    return Mesh(dp=dp, sp=sp, dp_rank=rank // sp, sp_rank=rank % sp,
                group=dist.group.WORLD, dp_group=dp_group, sp_group=sp_group,
                device=d, transport=multihost.transport(d))


def shard_rows(batch, mesh: Mesh):
    """This dp index's rows of a global batch (B % dp == 0): block
    dp_rank, whole on every sp rank of it."""
    b = batch.shape[0] // mesh.dp
    return batch[mesh.dp_rank * b:(mesh.dp_rank + 1) * b]


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


def all_reduce_mean_(tensors: List[torch.Tensor], mesh: Mesh,
                     group=None, n: Optional[int] = None) -> None:
    """tensors <- their mean over `group` of n ranks (default: the whole
    world), in place, a bucket at a time (one flatten, one all-reduce and
    one multi-tensor copy a bucket: a step reduces some 1130 gradients,
    and the host sets its pace)."""
    if group is None:
        group, n = mesh.group, mesh.world
    for bucket in _buckets(tensors, BUCKET_BYTES):
        flat = _flatten_dense_tensors(bucket)
        mesh.transport.all_reduce_(flat, group)
        flat.div_(n)
        torch._foreach_copy_(bucket, _unflatten_dense_tensors(flat, bucket))


@contextlib.contextmanager
def _gradients_averaged(model: torch.nn.Module, mesh: Mesh):
    """Inside: a train step through `model` all-reduces its gradients as
    a mean over the world once they all exist, before its update. On a
    card with sp == 1 the step runs the reduction itself, between its
    backward and its update (train/step_graph.py: after_backward), so that
    no collective runs inside a backward that it replays from a CUDA
    graph. Otherwise (sp > 1, whose halo exchanges keep the step eager,
    or the CPU) the first accumulated gradient queues the reduction as the
    backward's final callback, so it runs once, after every gradient and
    before backward() returns."""
    params = [p for p in model.parameters() if p.requires_grad]
    queued = [False]

    def reduce_all() -> None:
        queued[0] = False
        with span("train.allreduce"):
            all_reduce_mean_([p.grad for p in params if p.grad is not None],
                             mesh)

    if mesh.sp == 1 and mesh.device.type == "cuda":
        with after_backward(reduce_all):
            yield
        return

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
    """Rank means -> the global batch's: the mean over dp (the sp ranks
    of one dp index hold the same metrics); a PSNR through its MSE (the
    global PSNR is that of the global MSE)."""
    if mesh.dp_group is None:
        return metrics
    keys = sorted(metrics)
    vals = torch.stack([
        10.0 ** (-metrics[k].float() / 10.0) if k == "psnr"
        else metrics[k].float() for k in keys])
    all_reduce_mean_([vals], mesh, mesh.dp_group, mesh.dp)
    return {k: (-10.0 * torch.log10(v) if k == "psnr" else v)
            for k, v in zip(keys, vals)}


def _bands(mesh: Mesh):
    return bands(mesh) if mesh.sp > 1 else contextlib.nullcontext()


def shard_train_step(train_step: Callable, mesh: Mesh) -> Callable:
    """train_step(state, batch) of make_train_step over the mesh: the
    batch is this dp index's rows, g_a and g_s split over image rows by
    the sp ranks, the noise the global batch's, the gradients averaged
    over the world before the update, the metrics the global batch's.
    Without a process group it is train_step itself."""
    if mesh.group is None:
        return train_step

    def step(state, batch):
        with _gradients_averaged(state.model, mesh), \
                dp_noise(mesh.dp_rank, mesh.dp), _bands(mesh):
            state, metrics = train_step(state, batch)
        return state, _mean_metrics(metrics, mesh)

    return step


def shard_eval_step(eval_step: Callable, mesh: Mesh) -> Callable:
    """eval_step(batch) of make_eval_step on this dp index's rows, g_a and
    g_s split over image rows as in shard_train_step, its metrics reduced
    to the global batch's."""
    if mesh.group is None:
        return eval_step

    def step(batch):
        with _bands(mesh):
            metrics = eval_step(batch)
        return _mean_metrics(metrics, mesh)

    return step

