"""CUDA graphs of the entropy model's channel-autoregressive pass.

ChannelARModel.decode_device_streams (models/base.py) runs the hyper
synthesis, every slice context, the Gaussian indexes, the lane decoder,
the patch scatter and the LRP: some 1,500 small launches at batch 8 of
768x512, most of them shorter on the card than the host's time to queue
them. The pass never reads the device from the host and its shapes follow
from the call's, so on the card it is captured once a key as a
torch.cuda.CUDAGraph and replayed on every later call:

  key      the direction (override), the stream layout (chained, K), the
           shapes, strides and dtypes of the tensor arguments, the stream
           words padded to compress_device's bound on a slice's words (its
           symbols + 1), the patch list padded to a power of two, the
           identity of the constant tables and the matmul / cuDNN flags; a
           stream's length, or a patch count within its bucket, does not
           change it
  capture  on a key's first call: one eager pass on a side stream (lazy
           inits: cuBLAS workspaces, cuDNN plans, the kernels' modules and
           device-side constants), then the capture on that stream, into
           one memory pool that all graphs share
  replay   copy the arguments into the key's static buffers (the words
           after the stream zeroed, the patch list after the stream's
           patches filled with -1, which the scatter drops), replay, and
           copy the four outputs out: no later call overwrites what a
           caller holds
  keep     the LRU_KEYS keys used last; all are dropped when a parameter
           or buffer outside g_a / h_a / g_s changes storage or version
           (`.to()`, `load_state_dict`, an in-place update)

It engages on what a call can observe: every tensor argument on z_hat's
card, grad mode off and no argument wanting a gradient. The CPU and
autograd run the pass eagerly. A replay runs the captured kernels at the
captured shapes on equal arguments, so its outputs equal the eager pass's
bit for bit. The kernel wrappers' launch counters (`.launches`) and the
sinks' launch records are stepped by what the capture launched, once a
replay (the lane decoder's records count its padded word buffer); spans
inside the pass (tcm.mix, tcm.swatten) time host work that a replay does
not do, and are not recorded. Records (utils/profiling.py): span
`codec.entropy.graph` (copy in, replay, copy out), counts
`codec.entropy.captured`, `codec.entropy.replayed` and
`codec.entropy.eager` (a pass on the card run eagerly).
"""

from __future__ import annotations

import collections
import threading
from typing import Optional

import torch

from dcae_tpu_torch.utils import profiling
from dcae_tpu_torch.utils.profiling import count, span

# keys kept: the encoder's and the decoder's of a shape, and the patch
# buckets that the decoder meets among a few distinct requests
LRU_KEYS = 8

# the arguments that are copied into static buffers, by direction
_ENCODE_INPUTS = ("z_hat", "true_y")
_DECODE_INPUTS = ("z_hat", "words", "n_words", "states", "patch_pos",
                  "patch_val")


def _tensor_args(a: dict) -> tuple:
    consts = ("scale_table",) if a["override"] else (
        "lut_sym", "lut_sf", "scale_table")
    return (_ENCODE_INPUTS if a["override"] else _DECODE_INPUTS) + consts


def _sig(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.stride(), t.dtype


def patch_bucket(n: int) -> int:
    """The padded length of a patch list of n entries: the least power of
    two >= n (0 for none)."""
    return 0 if n <= 0 else 1 << (n - 1).bit_length()


def words_width(cfg, z_hat: torch.Tensor) -> int:
    """compress_device's bound on a slice's stream words at z_hat's
    shape: the slice's symbols + 1."""
    B, zh, zw, _ = z_hat.shape
    r = cfg.hyper_ratio
    return B * zh * r * zw * r * cfg.slice_dim + 1


def engages(cfg, a: dict) -> bool:
    """Whether a call of the pass with arguments `a` is replayed from a
    graph (module docstring)."""
    if torch.is_grad_enabled():
        return False
    z = a["z_hat"]
    for name in _tensor_args(a):
        t = a[name]
        if not torch.is_tensor(t) or t.device != z.device or t.requires_grad:
            return False
    # conv2d_nhwc picks its vector loads by the input's alignment, and a
    # static buffer is aligned
    if not z.is_cuda or z.data_ptr() % 16:
        return False
    return a["override"] or (a["words"].dim() == 2 and
                             a["words"].shape[1] <= words_width(cfg, z))


def key(cfg, a: dict) -> tuple:
    """The graph key of a call (module docstring)."""
    z, st = a["z_hat"], a["scale_table"]
    k = (bool(a["override"]), bool(a["chained"]), z.device, _sig(z), id(st),
         _sig(st), torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark, torch.get_float32_matmul_precision())
    if a["override"]:
        return k + (_sig(a["true_y"]),)
    w, pp, pv = a["words"], a["patch_pos"], a["patch_val"]
    return k + ((w.dtype, w.shape[0], words_width(cfg, z)),
                _sig(a["n_words"]), _sig(a["states"]),
                (pp.dtype, pv.dtype, pp.shape[0], patch_bucket(pp.shape[1])),
                id(a["lut_sym"]), _sig(a["lut_sym"]), id(a["lut_sf"]),
                _sig(a["lut_sf"]))


def static_inputs(cfg, a: dict) -> dict:
    """Buffers for the arguments of a key: z_hat and true_y as they are,
    the words at words_width, the patch lists at their bucket."""
    if a["override"]:
        return {n: torch.empty_like(a[n]) for n in _ENCODE_INPUTS}
    S = a["words"].shape[0]
    P = patch_bucket(a["patch_pos"].shape[1])
    return {"z_hat": torch.empty_like(a["z_hat"]),
            "words": a["words"].new_empty((S, words_width(cfg, a["z_hat"]))),
            "n_words": torch.empty_like(a["n_words"]),
            "states": torch.empty_like(a["states"]),
            "patch_pos": a["patch_pos"].new_empty((S, P)),
            "patch_val": a["patch_val"].new_empty((S, P))}


def fill(bufs: dict, a: dict) -> dict:
    """Copy a call's arguments into its key's buffers: the words followed
    by zeros (the lane decoder reads none past a stream's count), the
    patches followed by position -1 (which the scatter drops). Returns
    `a` with the buffers in place of those arguments."""
    for name in ("z_hat", "true_y", "n_words", "states"):
        if name in bufs:
            bufs[name].copy_(a[name])
    if "words" in bufs:
        W, P = a["words"].shape[1], a["patch_pos"].shape[1]
        bufs["words"][:, :W].copy_(a["words"])
        bufs["words"][:, W:].zero_()
        bufs["patch_pos"][:, :P].copy_(a["patch_pos"])
        bufs["patch_pos"][:, P:].fill_(-1)
        bufs["patch_val"][:, :P].copy_(a["patch_val"])
        bufs["patch_val"][:, P:].zero_()
    return {**a, **bufs}


def weight_slots(model) -> list:
    """(dict, name) of every parameter and buffer slot the pass may read:
    all but those of the one-sided transforms. A slot sees the tensor that
    `load_state_dict(assign=True)` puts in it."""
    from dcae_tpu_torch.models.base import HALF_TRANSFORMS

    mods = [model] + [m for name, child in model.named_children()
                      if name not in HALF_TRANSFORMS for m in child.modules()]
    return [(d, k) for m in mods for d in (m._parameters, m._buffers)
            for k in d]


def weights(slots: list) -> tuple:
    """(storage, version) of the tensors in `slots` (weight_slots)."""
    return tuple((d[k].data_ptr(), d[k]._version) for d, k in slots
                 if d[k] is not None)


class _Record(profiling.Sink):
    """The launches of one captured pass, told again to the registered
    sinks at each replay."""

    def __init__(self):
        self.launches = []

    def launch(self, name: str, flops: int, nbytes: int) -> None:
        self.launches.append((name, flops, nbytes))

    def replay(self) -> None:
        for sink in list(profiling.sinks):
            for ev in self.launches:
                sink.launch(*ev)


class _Graph:
    """One key's captured pass, its static buffers and what it launches."""

    def __init__(self, model, a: dict, pool, stream):
        from dcae_tpu_torch.ops.kernels import wrappers

        self.bufs = static_inputs(model.cfg, a)
        # the constant tables: held, so that no other tensor takes their id
        self.consts = [a[n] for n in ("scale_table", "lut_sym", "lut_sf")]
        args = fill(self.bufs, a)
        self.wrappers = wrappers()
        start = {n: f.launches for n, f in self.wrappers.items()}
        sinks = list(profiling.sinks)
        self.record = _Record()
        side = torch.cuda.Stream(a["z_hat"].device)
        side.wait_stream(stream)
        try:
            profiling.sinks[:] = []
            with torch.cuda.stream(side):
                model._entropy_pass(**args)
                mid = {n: f.launches for n, f in self.wrappers.items()}
                profiling.sinks[:] = [self.record]
                self.graph = torch.cuda.CUDAGraph()
                self.graph.capture_begin(pool=pool,
                                         capture_error_mode="thread_local")
                try:
                    self.outs = model._entropy_pass(**args)
                finally:
                    self.graph.capture_end()
            self.launches = {n: f.launches - mid[n]
                             for n, f in self.wrappers.items()
                             if f.launches != mid[n]}
        finally:
            profiling.sinks[:] = sinks
            for n, f in self.wrappers.items():
                f.launches = start[n]
        stream.wait_stream(side)
        count("codec.entropy.captured")

    def replay(self, a: dict) -> tuple:
        with span("codec.entropy.graph"):
            fill(self.bufs, a)
            self.graph.replay()
            out = tuple(t.clone() for t in self.outs)
        for n, k in self.launches.items():
            self.wrappers[n].launches += k
        self.record.replay()
        count("codec.entropy.replayed")
        return out


class PassGraphs:
    """The captured passes of one model by key, the least recently used
    dropped first (module docstring)."""

    def __init__(self):
        self.graphs: "collections.OrderedDict[tuple, _Graph]" = \
            collections.OrderedDict()
        self._slots: Optional[list] = None
        self._weights: Optional[tuple] = None
        self._pool = None
        # the stream of the last replay: a replay on another stream waits
        # for it, since a graph's buffers and the pool are reused
        self._stream = None
        self._lock = threading.Lock()

    def run(self, model, a: dict) -> tuple:
        """The pass on arguments `a`: replayed where it engages, eager
        otherwise."""
        if not engages(model.cfg, a):
            count("codec.entropy.eager")
            return model._entropy_pass(**a)
        with self._lock:
            if self._slots is None:
                self._slots = weight_slots(model)
            w = weights(self._slots)
            if w != self._weights:
                self.graphs.clear()
                self._weights = w
            stream = torch.cuda.current_stream(a["z_hat"].device)
            if self._stream is not None and self._stream != stream:
                stream.wait_stream(self._stream)
            self._stream = stream
            k = key(model.cfg, a)
            g = self.graphs.get(k)
            if g is None:
                if not self.graphs:
                    # a pool is released with the last graph that holds it
                    self._pool = torch.cuda.graph_pool_handle()
                g = self.graphs[k] = _Graph(model, a, self._pool, stream)
                while len(self.graphs) > LRU_KEYS:
                    self.graphs.popitem(last=False)
            else:
                self.graphs.move_to_end(k)
            return g.replay(a)
