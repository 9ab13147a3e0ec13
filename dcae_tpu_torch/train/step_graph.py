"""A CUDA graph of the training step's forward and backward.

make_train_step's step sets the gradients to None, runs the forward
(model, rate-distortion loss, aux loss and, where it is on, the precision
penalty) and loss.backward(), then clips and updates both parameter
groups. At 8 crops of 256x256 in f32 the forward and backward queue
thousands of small launches (autograd's, cuDNN's dgrad and wgrad, the
hand kernels' recompute backwards: ops/kernels/_grad.py), and the host's
time to queue them, not the device, sets the step's pace. Neither reads
the device from the host and their shapes follow from the batch's, so on
the card they are captured once a key as a torch.cuda.CUDAGraph and
replayed on every later step. The clip and the two fused Adams stay
eager, reading the gradients in place, so the schedule's learning rate
is read as before:

  key      the batch's shape, strides, dtype and card, the training
           noise's dp shard (entropy/ops.py: dp_noise), the matmul / cuDNN
           flags and the identity of the noise generator
  warm-up  a key's first call: an eager step on a side stream (lazy
           inits: cuBLAS workspaces, cuDNN plans, the kernels' modules and
           device-side constants, AccumulateGrad); it updates the state
           like any step
  capture  its second call: the generator registered with the graph, the
           gradients set to None and the forward and backward captured on
           that stream, into one memory pool that all keys share (the
           gradients are allocated there), then one replay: a capture runs
           nothing
  replay   copy the batch into the key's static input, replay, point each
           parameter's .grad at its static gradient and return clones of
           the metrics: no later step overwrites what a caller holds
  keep     the LRU_KEYS keys used last; all are dropped when a parameter
           or buffer changes storage or requires_grad (`.to()`,
           `load_state_dict(assign=True)`, freezing). Adam's in-place
           updates change neither, and a replay reads them.

It engages on what a call can observe (eager_reason): grad mode on, the
model in train mode, no row bands (an sp > 1 step exchanges halo rows
inside g_a and g_s), and the batch and every parameter on one card. The
CPU always runs eagerly. No collective runs inside a graph: on a card with
sp == 1, shard_train_step (parallel/mesh.py) hands the data-parallel mean
all-reduce to `after_backward`, and the step runs it between the replay
(or the eager backward) and the update, over the same gradients.

A replay draws the training noise from the registered generator where it
stands, as the eager step would, and advances it alike: a replayed step
runs the eager step's kernels on the same noise. The kernel wrappers'
launch counters and the sinks' launch records are stepped by what the
capture launched, once a replay; spans inside the forward and backward
(train.forward, train.backward, tcm.*) time host work that a replay does
not do, and are not recorded. Records (utils/profiling.py): span
`train.graph` (copy in and replay), counts `train.graph.captured`,
`train.graph.replayed` and `train.graph.eager` (a step on the card run
eagerly).
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Callable, Dict, Optional

import torch

from dcae_tpu_torch.entropy.ops import noise_shard
from dcae_tpu_torch.models import entropy_graph
from dcae_tpu_torch.parallel import spatial
from dcae_tpu_torch.utils import profiling
from dcae_tpu_torch.utils.profiling import count, span

# keys kept: a trainer steps on one batch shape; a second one (TF32 turned
# on for a comparison, a last short batch) finds its graph still there
LRU_KEYS = 4

# on this thread: .fn, what a step runs once its gradients exist (the dp
# mean all-reduce), else None
_after = threading.local()


@contextlib.contextmanager
def after_backward(fn: Callable[[], None]):
    """Inside: a train step calls fn() once its gradients exist (after the
    eager backward or the replay) and before its update."""
    before = getattr(_after, "fn", None)
    _after.fn = fn
    try:
        yield
    finally:
        _after.fn = before


def run_after_backward() -> None:
    """fn of the enclosing after_backward, if any."""
    fn = getattr(_after, "fn", None)
    if fn is not None:
        fn()


def eager_reason(model: torch.nn.Module, batch: torch.Tensor
                 ) -> Optional[str]:
    """Why a step of `model` on `batch` runs eagerly, or None where it may
    be replayed from a graph (StepGraphs then checks that the parameters
    are on the batch's card)."""
    if not torch.is_grad_enabled():
        return "grad mode is off"
    if not model.training:
        return "the model is in eval mode"
    if spatial.active() is not None:
        return "g_a and g_s run on row bands, exchanging halo rows"
    if not batch.is_cuda:
        return "the batch is not on a card"
    return None


def key(batch: torch.Tensor, generator: torch.Generator) -> tuple:
    """The graph key of a step (module docstring)."""
    return (batch.device, tuple(batch.shape), batch.stride(), batch.dtype,
            noise_shard(), id(generator),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.get_float32_matmul_precision())


def weight_slots(model: torch.nn.Module) -> list:
    """(dict, name) of every parameter and buffer slot of `model`. A slot
    sees the tensor that `load_state_dict(assign=True)` puts in it."""
    return [(d, k) for m in model.modules()
            for d in (m._parameters, m._buffers) for k in d]


def weights(slots: list) -> tuple:
    """(storage, requires_grad) of the tensors in `slots`."""
    return tuple((d[k].data_ptr(), d[k].requires_grad) for d, k in slots
                 if d[k] is not None)


class _Graph:
    """One key's captured forward and backward: its static input,
    gradients and metrics, and what it launches."""

    def __init__(self, model, fn, batch, generator, pool, side):
        from dcae_tpu_torch.ops.kernels import wrappers

        self.x = torch.empty_like(batch)
        # held, so that no other generator takes its id
        self.generator = generator
        self.wrappers = wrappers()
        start = {n: f.launches for n, f in self.wrappers.items()}
        sinks = list(profiling.sinks)
        self.record = entropy_graph._Record()
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        try:
            profiling.sinks[:] = [self.record]
            with torch.cuda.stream(side):
                self.graph.capture_begin(pool=pool,
                                         capture_error_mode="thread_local")
                try:
                    self.outs = fn(self.x, generator)
                finally:
                    self.graph.capture_end()
            self.launches = {n: f.launches - start[n]
                             for n, f in self.wrappers.items()
                             if f.launches != start[n]}
        finally:
            profiling.sinks[:] = sinks
            for n, f in self.wrappers.items():
                f.launches = start[n]
        self.grads = [(p, p.grad) for p in model.parameters()]
        count("train.graph.captured")

    def replay(self, batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        with span("train.graph"):
            self.x.copy_(batch)
            self.graph.replay()
        for p, g in self.grads:
            if p.grad is not g:
                p.grad = g
        for n, k in self.launches.items():
            self.wrappers[n].launches += k
        self.record.replay()
        count("train.graph.replayed")
        return {k: v.clone() for k, v in self.outs.items()}


class StepGraphs:
    """fn(batch, generator) -> metrics, the forward and backward of one
    model's train step, replayed from a graph where it engages and run
    eagerly otherwise (module docstring). The keys' graphs, the least
    recently used dropped first."""

    def __init__(self, model: torch.nn.Module, fn: Callable):
        self.model, self.fn = model, fn
        self.graphs: "collections.OrderedDict[tuple, _Graph]" = \
            collections.OrderedDict()
        self._warm = set()            # keys whose warm-up step has run
        self._slots: Optional[list] = None
        self._weights: Optional[tuple] = None
        self._device: Optional[torch.device] = None
        self._pool = None
        self._side: Optional[torch.cuda.Stream] = None
        # the stream of the last replay: a step on another stream waits
        # for it, since a graph's buffers and the pool are reused
        self._stream = None

    def _engages(self, batch: torch.Tensor) -> bool:
        if eager_reason(self.model, batch) is not None:
            return False
        if self._slots is None:
            self._slots = weight_slots(self.model)
        w = weights(self._slots)
        if w != self._weights:
            self.graphs.clear()
            self._warm.clear()
            self._weights = w
            devices = {p.device for p in self.model.parameters()}
            self._device = devices.pop() if len(devices) == 1 else None
        return self._device == batch.device

    def run(self, batch: torch.Tensor, generator: torch.Generator
            ) -> Dict[str, torch.Tensor]:
        """The metrics of one forward and backward on `batch`, the
        gradients left on the parameters."""
        if not self._engages(batch):
            if batch.is_cuda:
                count("train.graph.eager")
            return self.fn(batch, generator)
        stream = torch.cuda.current_stream(batch.device)
        if self._stream is not None and self._stream != stream:
            stream.wait_stream(self._stream)
        self._stream = stream
        k = key(batch, generator)
        g = self.graphs.get(k)
        if g is not None:
            self.graphs.move_to_end(k)
            return g.replay(batch)
        if self._side is None or self._side.device != batch.device:
            self._side = torch.cuda.Stream(batch.device)
        self._side.wait_stream(stream)
        if k not in self._warm:
            with torch.cuda.stream(self._side):
                out = self.fn(batch, generator)
            stream.wait_stream(self._side)
            self._warm.add(k)
            return out
        if not self.graphs:
            # a pool is released with the last graph that holds it
            self._pool = torch.cuda.graph_pool_handle()
        g = self.graphs[k] = _Graph(self.model, self.fn, batch, generator,
                                    self._pool, self._side)
        stream.wait_stream(self._side)
        while len(self.graphs) > LRU_KEYS:
            self.graphs.popitem(last=False)
        return g.replay(batch)
