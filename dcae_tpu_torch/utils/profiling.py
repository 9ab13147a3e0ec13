"""Profiling and timing harness, the JAX package's utils/profiling.py on
torch.profiler, and the port's one registry of spans and counters:

  * sinks                what records: each a Sink; nothing records, and no
                         clock is read, while the list is empty
  * span(name)           a host-clock span around a phase of the program
  * count(name, n)       a counter of the program
  * registered(sink)     the sink registered for a block
  * trace(logdir)        torch.profiler over the block: a Chrome trace and
                         the per-op table (op_stats.json) into logdir
  * op_stats(logdir)     device time by op type, by group, the longest ops
  * time_fn(fn, ...)     wall time with a full device sync, after warm-up
  * card_line()          the card's name and power limit (nvidia-smi)
  * device_ms(fn, iters) device time a call on the card (CUDA events),
                         the host's enqueue time hidden behind a sleep
  * sdpa_call(...)       one SDPA call on the windows of a wmsa input: the
                         library yardstick of the window kernels
  * cost_analysis(...)   FLOPs (FlopCounterMode, plus each hand kernel's
                         count, read by a sink: that counter cannot see it)
                         and an estimate of the bytes the dispatched ops
                         read and write
  * report(fn, ...)      time + costs -> effective TFLOP/s and GB/s
  * codec_breakdown(...) the same for each subnet of a DCAECodec
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


class Sink:
    """What a registered sink is told: every program span as it closes,
    every counter step and every hand-kernel launch (ops/kernels:
    note_launch). A subclass overrides what it records."""

    def span(self, name: str, start: float, end: float) -> None:
        """A span closed: its name, its start and end on the host clock
        (time.perf_counter). Spans nest by their intervals."""

    def count(self, name: str, n: int) -> None:
        """A counter stepped by n."""

    def launch(self, name: str, flops: int, nbytes: int) -> None:
        """A hand kernel was queued: its operations (an FMA is two) and
        the bytes of its operands and results, each once."""


# the registered sinks; the program records into them, and nowhere else
sinks: List[Sink] = []


# the span while no sink is registered: enters and exits, nothing else
_NO_SPAN = contextlib.nullcontext()


class _Span:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.start = time.perf_counter()
        return None

    def __exit__(self, *exc) -> None:
        end = time.perf_counter()
        for sink in list(sinks):
            sink.span(self.name, self.start, end)
        return None


def span(name: str):
    """A context manager around a phase of the program, timed on the host
    clock and handed to every sink when it closes (on an exception too).
    With no sink registered it is one shared object that reads no clock.
    It never waits for the device: it times the host's work, queueing
    included."""
    return _Span(name) if sinks else _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Step the counter `name` by n in every sink (none registered:
    nothing)."""
    if sinks:
        for sink in list(sinks):
            sink.count(name, int(n))


@contextlib.contextmanager
def registered(sink: Sink):
    """Register `sink` for the block."""
    sinks.append(sink)
    try:
        yield sink
    finally:
        sinks.remove(sink)


def op_type(name: str) -> str:
    """The kind of a kernel or op, by its name: one of the hand kernels,
    convolution (cuDNN's implicit GEMMs included), gemm, copy, other."""
    low = name.lower()
    if "rans_lanes" in name:
        return "rans_lanes"
    if "wmsa_" in name:
        # both wmsa entries share the device code; <false>: no LN/residual
        return "wmsa_attention" if "<false>" in name else "wmsa_block"
    if "conv_glu" in name:
        return "conv_glu bf16" if "conv_glu_bf16" in name else "conv_glu f32"
    if any(k in low for k in ("conv", "cudnn", "fprop", "dgrad", "wgrad")):
        return "convolution"
    if any(k in low for k in ("gemm", "cutlass", "aten::mm", "aten::addmm",
                              "aten::bmm", "matmul", "aten::linear")):
        return "gemm"
    if "memcpy" in low or "memset" in low or "aten::copy_" in low:
        return "copy"
    return "other"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (the card's kernels too, when there is one) and
    write logdir/trace.json (Chrome / Perfetto) and logdir/op_stats.json
    (per op: self device and host time, calls). Yields the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    rows = [{"name": e.key, "count": int(e.count),
             "device": e.device_type == DeviceType.CUDA,
             "self_device_us": float(getattr(
                 e, "self_device_time_total",
                 getattr(e, "self_cuda_time_total", 0.0))),
             "self_host_us": float(e.self_cpu_time_total)}
            for e in prof.key_averages()]
    with open(os.path.join(logdir, "op_stats.json"), "w") as f:
        json.dump(rows, f)


def op_stats(logdir: str, group_fn: Optional[Callable] = None,
             keep_rows: bool = False) -> Dict:
    """Per-op DEVICE time of a trace written by trace(logdir): the
    device's kernels, or, in a trace without any (the CPU), the host ops'
    self times. Returns {"total_ms", "by_type": {op_type: ms}, "by_group":
    {group_fn(name): ms}, "top": [(ms, occurrences, type, name), ...]}."""
    with open(os.path.join(logdir, "op_stats.json")) as f:
        rows = json.load(f)
    dev = [(r["self_device_us"], r) for r in rows
           if r["device"] and r["self_device_us"] > 0]
    if not dev:                    # a CPU trace: the host ops
        dev = [(r["self_host_us"], r) for r in rows
               if not r["device"] and r["self_host_us"] > 0]
    by_type: Dict[str, float] = {}
    by_group: Dict[str, float] = {}
    for us, r in dev:
        t = op_type(r["name"])
        by_type[t] = by_type.get(t, 0.0) + us / 1e3
        if group_fn is not None:
            g = group_fn(r["name"])
            by_group[g] = by_group.get(g, 0.0) + us / 1e3
    rows_out = sorted(((us / 1e3, r["count"], op_type(r["name"]), r["name"])
                       for us, r in dev), reverse=True)
    out = {"total_ms": sum(us for us, _ in dev) / 1e3, "by_type": by_type,
           "by_group": by_group, "top": rows_out[:25]}
    if keep_rows:
        out["rows"] = rows_out
    return out


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def force_sync(tree):
    """Wait for every device that holds a tensor of `tree` (nested dicts,
    lists, tuples) to finish its queued work; returns `tree`."""
    devices = {t.device for t in _tensors(tree) if t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)
    return tree


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 2) -> Dict:
    """Median / best wall time of fn(*args), each run synchronized."""
    for _ in range(warmup):
        force_sync(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        force_sync(fn(*args))
        times.append(time.perf_counter() - t0)
    return {"median_s": float(np.median(times)),
            "best_s": float(np.min(times)), "times_s": times}


def card_line() -> str:
    """`name, power.limit` of the first card nvidia-smi lists, as it gives
    them: a card may be set below its maximum power and then runs slower,
    so every number taken on it is kept beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters: int) -> float:
    """Device ms a call of fn over `iters` calls (CUDA events), queued
    behind a sleep kernel that outlasts their enqueue, so that the host's
    time to enqueue them does not count."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0     # bounds one call's enqueue
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # cycles at no more than 2 GHz: at least this many seconds
    torch.cuda._sleep(int((2 * iters * call_s + 1e-3) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sdpa_call(x, rel, heads: int, shifted: bool):
    """One SDPA call over the windows of x (random q / k / v of their
    shape) with the same bias and shift mask."""
    import torch.nn.functional as F
    from dcae_tpu_torch.ops.kernels.wmsa_block import (
        relative_position_bias, shifted_window_mask)

    B, H, W, C = x.shape
    nh, nw, hd = H // 8, W // 8, C // heads
    q, k, v = (torch.randn((B, nh * nw, heads, 64, hd), device=x.device,
                           dtype=x.dtype) for _ in range(3))
    bias = relative_position_bias(rel.float())          # (heads, 64, 64)
    if shifted:
        mask = torch.as_tensor(shifted_window_mask(nh, nw), device=x.device)
        bias = bias[None].masked_fill(mask[:, None], float("-inf"))[None]
    bias = bias.to(x.dtype)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)


def cost_analysis(fn: Callable, *args) -> Dict:
    """One run of fn(*args), counted: {"flops": FlopCounterMode's count
    plus the hand kernels' counts (ops/kernels: note_launch, read by a
    sink), "bytes_accessed": the operands and results of every dispatched op that
    is not a view, and of every hand kernel launch (an estimate: what a
    cache keeps counts again), "kernel_flops": the hand kernels' share}."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import FlopCounterMode

    kernels = {"flops": 0, "bytes": 0}

    class _Launches(Sink):
        def launch(self, name: str, flops: int, nbytes: int) -> None:
            kernels["flops"] += flops
            kernels["bytes"] += nbytes

    class _Bytes(TorchDispatchMode):
        nbytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view:
                _Bytes.nbytes += sum(
                    t.numel() * t.element_size()
                    for t in tree_leaves((args, kwargs, out))
                    if torch.is_tensor(t))
            return out

    with registered(_Launches()), FlopCounterMode(display=False) as flops, \
            _Bytes():
        force_sync(fn(*args))
    return {"flops": float(flops.get_total_flops() + kernels["flops"]),
            "bytes_accessed": float(_Bytes.nbytes + kernels["bytes"]),
            "kernel_flops": float(kernels["flops"])}


def report(fn: Callable, *args, iters: int = 5, warmup: int = 2,
           label: str = "") -> Dict:
    """Measured wall time + cost count -> effective TFLOP/s and GB/s."""
    t = time_fn(fn, *args, iters=iters, warmup=warmup)
    c = cost_analysis(fn, *args)
    sec = t["median_s"]
    return {
        "label": label,
        "median_ms": sec * 1e3,
        "best_ms": t["best_s"] * 1e3,
        "gflops": c["flops"] / 1e9,
        "hbm_gb": c["bytes_accessed"] / 1e9,
        "tflops_per_s": c["flops"] / sec / 1e12 if sec > 0 else 0.0,
        "hbm_gb_per_s": c["bytes_accessed"] / sec / 1e9 if sec > 0 else 0.0,
    }


@torch.no_grad()
def codec_breakdown(codec, x, iters: int = 3) -> Dict[str, Dict]:
    """report() of each subnet of `codec` on batch x: g_a, h_a, the hyper
    synthesis (h_z_s1 + h_z_s2), g_s and the one-call encode."""
    model = codec.model
    x = codec._input(x)
    y = model.analysis(x)
    z = model.hyper_analysis(y)
    st = codec._scale_table
    return {
        "g_a": report(model.analysis, x, iters=iters, label="g_a"),
        "h_a": report(model.hyper_analysis, y, iters=iters, label="h_a"),
        "hyper_synthesis": report(model.hyper_synthesis, z, iters=iters,
                                  label="h_z_s1+h_z_s2"),
        "g_s": report(model.decode_synthesis, y, iters=iters, label="g_s"),
        "encode_full": report(lambda t: model.encode_arrays(t, st), x,
                              iters=iters, label="one-call encode"),
    }
