#!/usr/bin/env python3
"""Microbenchmark of the window-attention kernel at the three g_a / g_s
stage shapes (768x512 input, batch 8), the JAX package's
tools/bench_wmsa.py on the port: the hand kernel `dcae_wmsa_attention`
(ops/kernels/wmsa_attention.py, the counterpart of fused_wmsa_v3) or,
with --block, `dcae_wmsa_block` (the default path's kernel, the
counterpart of fused_wmsa_block_v4).

    python -m dcae_tpu_torch.tools.bench_wmsa [--dtype bf16|f32] \
        [--reps 30] [--shifted] [--block]

Device time from CUDA events over --iters launches that queue behind a
sleep kernel (so the wrapper's host work does not count), the input
rotated over three buffers; the median of --reps such runs a stage. Beside
the kernel, the plain PyTorch version's time and one SDPA call's on the
same windows (the attention core alone), the yardsticks of PERF.md. Needs
a card: a CPU run measures nothing of the kernel.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

STAGES = [  # (name, H, W, C, head_dim, blocks at full size)
    ("stage1", 384, 256, 96, 8, 1),
    ("stage2", 192, 128, 144, 16, 2),
    ("stage3", 96, 64, 256, 32, 12),
]


def stage_inputs(B, H, W, C, heads, dtype, rng, gen):
    """Three inputs (drawn on the card by gen) and the weights (by rng),
    seeded: (xs, [ln_w, ln_b, rs], [wqkv, bqkv, wproj, bproj, rel])."""
    import torch

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            "cuda", dtype).contiguous()

    xs = [torch.randn((B, H, W, C), generator=gen, device="cuda").to(dtype)
          for _ in range(3)]
    ln = [t(1 + 0.1 * rng.normal(size=C)), t(0.1 * rng.normal(size=C)),
          t(1 + 0.1 * rng.normal(size=C))]
    w = [t(rng.normal(0, 0.02, (3 * C, C))), t(np.zeros(3 * C)),
         t(rng.normal(0, 0.02, (C, C))), t(np.zeros(C)),
         t(rng.normal(0, 0.02, (heads, 15, 15)))]
    return xs, ln, w


def bench(dtype: str = "bf16", reps: int = 30, batch: int = 8,
          shifted: bool = False, iters: int = 10,
          block: bool = False) -> dict:
    """{stage: {C, heads, kernel_ms, plain_ms, sdpa_ms, blocks}} and the
    totals a transform (ms x blocks), kernel and plain."""
    import torch
    from dcae_tpu_torch.ops.kernels.wmsa_attention import (
        wmsa_attention, wmsa_attention_ref)
    from dcae_tpu_torch.ops.kernels.wmsa_block import (wmsa_block,
                                                       wmsa_block_ref)
    from dcae_tpu_torch.tools._cli import require_card
    from dcae_tpu_torch.utils.profiling import device_ms, sdpa_call

    require_card("bench_wmsa")
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"kernel": "wmsa_block" if block else "wmsa_attention",
           "dtype": dtype, "batch": batch, "shifted": shifted,
           "stages": {}, "kernel_ms_per_transform": 0.0,
           "plain_ms_per_transform": 0.0}
    for name, H, W, C, hd, nblocks in STAGES:
        heads = C // hd
        xs, ln, w = stage_inputs(batch, H, W, C, heads, dt, rng,
                                 gen)
        kw = dict(heads=heads, shifted=shifted)
        if block:
            fns = (lambda x: wmsa_block(x, *ln, *w, **kw),
                   lambda x: wmsa_block_ref(x, *ln, *w, **kw))
        else:
            fns = (lambda x: wmsa_attention(x, *w, **kw),
                   lambda x: wmsa_attention_ref(x, *w, **kw))
        row = {"C": C, "heads": heads, "blocks": nblocks}
        with torch.no_grad():
            for key, fn in zip(("kernel_ms", "plain_ms"), fns):
                i = [0]

                def call(fn=fn):
                    i[0] = (i[0] + 1) % 3
                    fn(xs[i[0]])

                call()
                row[key] = float(np.median([device_ms(call, iters)
                                            for _ in range(reps)]))
            sdpa = sdpa_call(xs[0], w[-1], heads, shifted)
            sdpa()
            row["sdpa_ms"] = float(np.median([device_ms(sdpa, iters)
                                              for _ in range(reps)]))
        out["stages"][name] = row
        out["kernel_ms_per_transform"] += row["kernel_ms"] * nblocks
        out["plain_ms_per_transform"] += row["plain_ms"] * nblocks
        print(f"{name}: C={C} heads={heads} kernel {row['kernel_ms']:.4f} "
              f"ms (x{nblocks} blocks = {row['kernel_ms'] * nblocks:.3f} "
              f"ms/transform) | plain {row['plain_ms']:.4f} | SDPA "
              f"{row['sdpa_ms']:.4f}", flush=True)
        del xs
    print(f"total kernel ms/transform (batch {batch}): "
          f"{out['kernel_ms_per_transform']:.3f} (plain "
          f"{out['plain_ms_per_transform']:.3f})")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--shifted", action="store_true")
    ap.add_argument("--iters", type=int, default=10,
                    help="launches timed together")
    ap.add_argument("--block", action="store_true",
                    help="time wmsa_block (LN, residual) instead")
    a = ap.parse_args(argv)
    out = bench(a.dtype, a.reps, a.batch, a.shifted, a.iters, a.block)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
