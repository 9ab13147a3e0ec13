#!/usr/bin/env python3
"""A cell run with the program switched to a lower precision (the control)
or broken underneath (the faults), to show that `correct` comes out false.

    python3 benchmark/tests/variants.py --workload <cell> --seed <n> \
        --seconds <s> --variant <name> [--device cpu] [--trace 1]

Variants, each a patch of the program's own functions for the run:

  sound       no change
  tf32        a control: the program runs its f32 work with TF32 on
              (the codec's compress_device / decompress_interleaved, the
              training step), the precision step that would tempt a later
              change; the configuration states f32 with TF32 off
  fp8         the codec's other control: its bf16 transforms (g_a, h_a,
              g_s) with float8 e4m3 operands, every weight and every
              convolution's and linear layer's input rounded to it under
              a per-tensor scale (the card's fp8 GEMMs take operands so)
  half        half of the batch left out: the codec answers the first half
              of each request only; a training step sees the first half of
              its batch (the mean over the rest)
  altered     an answer altered where it is produced: the codec's x_hat
              (one value moved by 0.5); the training step's loss (x 1.001)
  stream      the codec's first y stream with one word altered as the
              encoder hands it over
  scales      the codec's scale path broken: every coding index one table
              row up, in encoder and decoder alike (the streams still
              decode, only the indexes tell)
  stale       a training step that returns its state unchanged (no update)
  noexchange  a data-parallel step without the gradients' all-reduce: each
              rank updates on its own rows (every rank carries the patch)
  rankjax     a data-parallel run whose ranks other than 0 load a module
              named jax (to show that the run then prints no result)

Prints the result line as benchmark/run.py does. With --device cpu the
harness's look for a card is skipped (the tests run it so, at tiny size).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from unittest import mock

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


@contextlib.contextmanager
def tf32(on: bool):
    import torch

    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def fp8(t):
    """t with float8 e4m3 precision, under a per-tensor scale."""
    import torch

    s = 448.0 / t.detach().abs().amax().float().clamp_min(1e-12)
    return (t.float() * s).to(torch.float8_e4m3fn).float().div(s).to(t.dtype)


def fp8_transforms(model) -> None:
    """Round the weights of g_a, h_a and g_s to fp8 and the input of each
    of their convolutions and linear layers as it is called."""
    import torch
    from torch import nn

    kinds = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)
    for name in ("g_a", "h_a", "g_s"):
        for m in getattr(model, name).modules():
            if isinstance(m, kinds):
                with torch.no_grad():
                    m.weight.copy_(fp8(m.weight))
                m.register_forward_pre_hook(
                    lambda mod, args: (fp8(args[0]),) + tuple(args[1:]))


def codec_patches(variant: str):
    from dcae_tpu_torch.models.codec import DCAECodec

    enc0, dec0 = DCAECodec.compress_device, DCAECodec.decompress_interleaved

    if variant == "scales":
        from dcae_tpu_torch.entropy import gaussian

        build0 = gaussian.build_indexes

        def build(scales, table, *a, **k):
            return (build0(scales, table, *a, **k) + 1).clamp_max(
                len(table) - 1)
        return [mock.patch.object(gaussian, "build_indexes", build)]
    if variant == "fp8":
        init0 = DCAECodec.__init__

        def init(self, *a, **k):
            init0(self, *a, **k)
            fp8_transforms(self.model)
        return [mock.patch.object(DCAECodec, "__init__", init)]
    if variant == "tf32":
        def enc(self, x, *a, **k):
            with tf32(True):
                return enc0(self, x, *a, **k)

        def dec(self, e):
            with tf32(True):
                return dec0(self, e)
    elif variant == "half":
        def enc(self, x, *a, **k):
            return enc0(self, x[: max(len(x) // 2, 1)], *a, **k)
        dec = dec0
    elif variant == "altered":
        enc = enc0

        def dec(self, e):
            out = dec0(self, e)
            out["x_hat"][0, 0, 0, 0] += 0.5
            return out
    elif variant == "stream":
        def enc(self, x, *a, **k):
            out = enc0(self, x, *a, **k)
            b = bytearray(out["istreams"][0])
            b[len(b) // 2] ^= 0x5A
            out["istreams"][0] = bytes(b)
            return out
        dec = dec0
    else:
        raise ValueError(f"no codec variant {variant!r}")
    return [mock.patch.object(DCAECodec, "compress_device", enc),
            mock.patch.object(DCAECodec, "decompress_interleaved", dec)]


@contextlib.contextmanager
def jax_loaded():
    """A module named jax in sys.modules from here on, as a library that
    loads JAX by itself would leave it."""
    import types

    sys.modules.setdefault("jax", types.ModuleType("jax"))
    yield


def train_patches(variant: str, rank: int = 0):
    from dcae_tpu_torch.train import step as step_mod

    if variant == "rankjax":
        return [jax_loaded()] if rank else []

    make0 = step_mod.make_train_step

    def make(*a, **k):
        inner = make0(*a, **k)

        def step(state, batch):
            if variant == "tf32":
                with tf32(True):
                    return inner(state, batch)
            if variant == "half":
                return inner(state, batch[: max(len(batch) // 2, 1)])
            if variant == "altered":
                state, met = inner(state, batch)
                met["loss"] = met["loss"] * 1.001
                return state, met
            raise ValueError(f"no training variant {variant!r}")
        return step

    if variant == "stale":
        def no_update(state, tx):
            state.step += 1
        return [mock.patch.object(step_mod, "apply_updates", no_update)]
    if variant == "noexchange":
        from dcae_tpu_torch.parallel import mesh
        return [mock.patch.object(mesh, "_gradients_averaged",
                                  lambda model, m: contextlib.nullcontext())]
    return [mock.patch.object(step_mod, "make_train_step", make)]


def run(workload: str, seed: int, seconds: float, variant: str,
        device: str = "cuda", bench_json: str = None, out=print,
        trace: bool = False) -> int:
    for path in (ROOT, BENCH):
        if path not in sys.path:
            sys.path.insert(0, path)
    from harness import core

    bench_json = bench_json or os.path.join(ROOT, "BENCHMARK.json")
    cell = core.load_cell(bench_json, workload)
    ctx = core.Context(cell, seed, seconds, trace, device, T0,
                       bench_json=bench_json)
    if variant != "sound":
        os.environ["BENCH_PATCH"] = variant      # the other ranks' too
    gen = cell.generator()
    patches = [] if variant == "sound" else (
        train_patches(variant) if cell.traffic["generator"] == "train_closed"
        else codec_patches(variant))
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        res = gen.run(ctx, device=device)
    return core.finish(cell, ctx, res, out)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--variant", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args()
    return run(a.workload, a.seed, a.seconds, a.variant, a.device,
               trace=bool(a.trace))


if __name__ == "__main__":
    sys.exit(main())
