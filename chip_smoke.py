#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dcae_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as the checks run it
    python3 chip_smoke.py --phase kernels
    python3 chip_smoke.py --phase rans       # the lane coders alone
    python3 chip_smoke.py --phase train
    python3 chip_smoke.py --phase split
    python3 chip_smoke.py --phase serve
    python3 chip_smoke.py --phase sp
    python3 chip_smoke.py --phase tools
    python3 chip_smoke.py --phase bench
    python3 chip_smoke.py --phase validate   # the records' full run

Phases, in order:
  build      nvcc builds every kernel of csrc/ from this checkout (one
             compiler per source, all at once) into build/.
  kernels    each kernel against its plain PyTorch version on the card at
             the main path's shapes (batch 2 of 768x512), with device times,
             the least time the card could take (bound; for f32 kernels
             that run 3xTF32 also that ceiling) and, for wmsa_block and
             wmsa_attention, an SDPA call as yardstick; each must be
             bitwise repeatable in both dtypes. The three wrappers'
             gradient Functions follow, in f32 at the training shapes
             (batch 8 of 256x256): forward against the plain version,
             gradients through the Function against autograd through the
             plain version, forward and backward times, SDPA for the wmsa
             kernels (and the gradients of one bf16 call a kernel).
             The two lane-coder kernels (rans_lanes_decode /
             rans_lanes_encode, their row tables in shared memory) code 5
             chained slices under the codec's Gaussian bank at batch 1, 2
             and 8 of 768x512 (98,304 / 196,608 / 786,432 symbols on 256 /
             512 / 1024 lanes) and on the wide kernels (2048 lanes), each on
             symbols drawn over every row and over the 8 narrowest rows,
             and must equal their plain versions AND the C++ host coder
             exactly; a flipped word or a bumped state must give ok =
             false. Each shape prints ms a slice, ns and SM cycles a step
             (nvidia-smi's clocks.sm) and the shared memory each kernel
             asks for. Their yardstick is the host coder's time.
  reference  the full-width f32 model on the card against the same weights
             on the CPU (plain versions), on a 128x128 image.
  slice      the full-size bf16 codec (seeded random weights) on 2
             structured 768x512 images, in three parts:
             staged     compress, write and read .bin files, decompress;
                        the decoder's per-slice indexes and symbols must
                        equal the encoder's;
             certified  self_check() must certify the split or fused
                        encoder; that mode's streams must equal the staged
                        ones and decode exactly; compress_with_indexes then
                        decompress(indexes=...) must give the per-slice
                        decoder's x_hat bitwise;
             interleaved  the device-coding profile on the same codec:
                        compress_device -> decompress_interleaved; ok, x_hat
                        bitwise equal to the staged part's, streams equal to
                        compress_interleaved's (host coder), a corrupt
                        stream found, both device parts free of host waits
                        (torch.cuda.set_sync_debug_mode("error")), a DTI2
                        file round trip, the serving loop over 3 batches.
                        The part prints each slice's count of out-of-table
                        symbols and opens codec.patch_cap only where one
                        exceeds it (seed 0's random weights stay far below
                        the default 512).
             attention-only  DCAEConfig(fused_attention_block=False): exact
                        decode, bpp within 1% and PSNR within 0.1 dB of the
                        staged part.
             Every path runs with the launch counters set to 0 just before
             it and read just after; each must show its kernels.
  train      the RD trainer's own functions (make_optimizer,
             create_train_state, make_train_step) on the full-width f32
             DCAEConfig(), seeded weights, batch 8 of 256x256 crops, lambda
             0.0483, mse: every parameter's gradient at step 1 finite and
             nonzero, the quantiles' gradient the aux loss's alone, 3 warm +
             5 timed steps (host clock, peak memory), 3 steps split into
             forward / backward / optimizer by CUDA events with the share of
             the three recompute backwards, 3 steps with TF32 allowed (what
             full-f32 products cost), 2 steps with precision_reg, 2
             steps of the attention-only configuration, the launch counts of
             each; the loss must be finite at every step and lower after
             than before; a tiny step on the card must equal the same step
             on the CPU within bars that CPU steps with noise on the window
             outputs calibrate; then one tiny run_training epoch on
             generated PNGs with a checkpoint reload (the tiny model with
             window-8 stacks 96 channels wide: TINY_W8).
  split      split deployment (seeded random weights; builds nothing new):
             halves     make_split_pair on the full-size bf16 codec and 2
                        768x512 images: streams equal to the joint staged
                        encoder's, exact decode, x_hat bitwise the joint
                        decode's; each half's parameter bytes are the joint
                        model's less the other half's transforms (the shared
                        modules are most of the model), its state dict has
                        no key of the other half, and it refuses the other
                        half's methods; 15 / 17 launches each way; ms per
                        image beside the joint codec's; the halves' device
                        parts under set_sync_debug_mode("error");
             latent     DLT1 round trips in 4 dtypes, PSNR against the f32
                        hand-off;
             many       compress_many / decompress_many over 3 batches of 2
                        against per-batch calls; encdec_pipeline's ms per
                        image beside sequential calls (recorded only);
             cross-device  CrossDeviceCodec (tools/eval.py) on a 256x256
                        image, f32, card -> CPU and CPU -> card: with shipped
                        indexes the decode must be exact; without, whether it
                        is exact is printed;
             autoencoder  the full-width SimpleAutoencoder (f32), joint and
                        g_a -> float16 latent -> g_s: launches, stage ms;
             training   make_split_train_step, full-width f32, batch 8 of
                        256x256, both halves on cuda:0: step-1 gradients,
                        3 warm + 5 timed steps, peak memory beside the train
                        phase's joint step, launches 30 / 29, the loss
                        falling; a TINY_W8 step with the encoder half on the
                        CPU and the decoder half on the card within the tiny
                        step's bars of the all-CPU split step;
             CLIs       compress_and_decompress (classic, interleaved,
                        --latent float16) and eval_autoencoder --split as
                        subprocesses on 2 PNGs: exit 0, each .bin the bytes
                        of this process's codec, each PNG its decode.
             It prints one JSON line of its own ({"split": ...}).
  serve      serving and data-parallel deployment, the full-size bf16
             codec (seeded random weights) on structured 768x512 images:
             loops      encdec_pipeline_interleaved and encdec_pipeline
                        against sequential calls on 3 and 8 batches of 2, in
                        turns (sequential, loop, loop, sequential; 3 rounds):
                        results bitwise the sequential ones, every batch
                        tagged interleaved; ms per image with the spread;
                        the host waits of one loop by line;
             loopback   a BitstreamServer on 127.0.0.1 decoding on arrival
                        (tools/server.py's decoder, its own codec), fed 4
                        classic .bin payloads by tools/client.py and 4 DTI2
                        payloads: received bytes = sent, served x_hat
                        bitwise the direct decode, 15 / 17 launches (+ 5
                        lane decoders), receive-to-decoded ms;
             profiling  utils/profiling.report of g_a (TFLOP/s), and a
                        256x256 staged encode of the full-width f32 model
                        dumped on the card and on the CPU
                        (utils/debug.dump_codec_run) and compared
                        (recorded, not a bar);
             dp         a one-rank NCCL process group: make_mesh gives
                        dp = 1, a full-width f32 shard_train_step step (8 x
                        256x256) equals the plain make_train_step step
                        (bitwise, or 1e-6 of each tensor's largest), its ms
                        beside the train phase's step, tools/eval_sharded
                        on 4 PNGs.
             It prints one JSON line of its own ({"serve": ...}).
  sp         the spatial mesh axis, full-width f32 DCAEConfig() (the train
             phase's flags), seeded weights:
             halo check wmsa_block / wmsa_attention (W, SW) and conv_glu on
                        the first, an interior and the last stage-3 band
                        of the sp = 2 step with their halos, cropped,
                        against the whole tensor (expected bitwise; TOL);
             probe      two processes of this script on the one card
                        over gloo: which operations take card tensors
                        (all-reduce and all-gather must: the host-staged
                        transport passes them to gloo as they are; the
                        point to point it stages is printed);
             ranks      two processes of this script on the one card
                        (gloo, host-staged transport: NCCL refuses two
                        ranks on one card): one RD step
                        of 8 x 256x256 at dp = 1, sp = 2 against the
                        one-card make_train_step on the same batch and
                        state (gradients within 1e-5 of the largest, 99%
                        of the parameters within 1e-3 lr, metrics and
                        parameters bitwise alike on the ranks), 30
                        wmsa_block / 29 conv_glu launches a rank a step,
                        peak memory and step ms a rank beside one card's
                        (the ranks share the card: no scaling is read);
                        shard_eval_step on 2 x 768x512 in bf16 transforms
                        against one card (the bits and the metrics at TOL
                        bf16; y and g_s within SP_BF16_VS_F32 times one
                        card's distance from the f32 model; y no further
                        from one card's at the band edge than elsewhere;
                        x_hat and the likelihoods printed); the attention-only
                        configuration's forward (30 wmsa_attention a rank,
                        x_hat at TOL f32).
             It prints one JSON line of its own ({"sp": ...}).
  tools      the six root tools of the port through their entry points
             (dcae_tpu_torch/tools), at reduced depth, each run with the
             launch counters set to 0 just before it and read just after
             (each must launch its path's kernels and no other):
             validate_training --full, 2 epochs of 32 synthetic 256x256
                        PNGs at batch 8 (8 full-width f32 steps through
                        wmsa_block and conv_glu and their recompute
                        backwards; the real-coded eval before and after):
                        summary.json written, finite, the checkpoint a
                        strict load; PASS / FAIL printed (information at
                        this depth);
             rd_sweep_eval on that checkpoint and a seeded one (2 images);
             lanes_ab K 512 / 256, 1 round, batch 2 of 768x512 (seeded
                        bf16 codec): every lanes checksum holds;
             profile_interleaved --stage decode, batch 2: the region
                        budget, `other` under half the device time, the
                        lane coders and the window kernel seen on the card;
             bench_wmsa (wmsa_attention at the three stage shapes, batch
                        8) in bf16 and f32, 3 reps; bench_link, 3 reps.
             It prints one JSON line of its own ({"tools": ...}).
  bench      bench_torch.py as a subprocess at reduced depth on seeded
             weights (batch 2 of 768x512, 1 round, budget 0, 2 pipeline
             batches): exit 0; its last line a result with value > 0, no
             error, the certified (fast) encoder, the interleaved profile
             ok and no batch of it coded classic; its launch line the
             kernels of each measured part, exactly: wmsa_block 30 and
             conv_glu 34 a compress + decompress, the lane coders 5 + 5 a
             pair on the interleaved parts and none on the classic ones.
             It prints the bench's line, then one JSON line of its own
             ({"bench": ...}).
  validate   (only with --phase validate) the records' full run:
             validate_training --full at the JAX package's protocol (200
             synthetic PNGs, 8 epochs x 25 steps, batch 8, 256x256) at
             lambda 0.013, 0.0018 and 0.05; rd_sweep_eval over the three
             checkpoints (8 images); cross-device decode without shipped
             indexes on the lambda 0.013 weights, card -> CPU and CPU ->
             card; lanes_ab (K 1024 / 512 / 256 / 128, batch 8, 3 rounds)
             and profile_interleaved (both stages, batch 8) on them;
             bench_torch.py at its full protocol (batch 8, 3 rounds, the
             default budget) on seeded weights and on the lambda 0.013
             checkpoint, held as in the bench phase.
             It prints one JSON line of its own ({"validate": ...}).
  profile    (only with --phase profile) device time of one slice run by
             kernel, from torch.profiler: staged, shipped-index and
             interleaved pairs; then of one serving round of each loop in
             bench_torch.py's configuration (6 batches of 8 x 768x512,
             seeded weights) with the device's busy share; then of one
             full-width training step.
  bands      (only with --phase bands) the bf16 conv_glu call at the path's
             shape walked in bands of 12, 24 and 48 MiB of [g | v], and
             what the host spends to enqueue one call.

Exits non-zero (and prints no result) without a CUDA device or on any
failed check. The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from dcae_tpu_torch.data.synthetic import synthetic_kodak
from dcae_tpu_torch.ops.kernels import wrappers

H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense; f32 non-tensor
TF32_FLOPS = 495e12          # dense TF32 tensor-core rate: the 3xTF32 ceiling
# max|kernel - plain| / max|plain|: ~1.7x / ~6x the largest errors
# measured on an H100 (6.0e-3 in bf16, wmsa_attention stage 2; 1.7e-6 in
# f32, the DCA conv_glu; PERF.md), well inside the first bars of 3e-2 / 1e-4
TOL = {"bfloat16": 1e-2, "float32": 1e-5}

# (label, H, W, C, heads, shifted) at batch 2 of 768x512 images, and how
# often one compress + one decompress launches that shape (g_a + g_s): by
# wmsa_block by default, by wmsa_attention under fused_attention_block=False
WMSA_CASES = [
    ("stage1 W", 256, 384, 96, 12, False, 2),
    ("stage2 W", 128, 192, 144, 9, False, 2),
    ("stage2 SW", 128, 192, 144, 9, True, 2),
    ("stage3 W", 64, 96, 256, 8, False, 12),
    ("stage3 SW", 64, 96, 256, 8, True, 12),
]
# (label, H, W, C, hidden, dtype, launches per compress + decompress)
CONV_GLU_CASES = [
    ("stage3 GLU", 64, 96, 256, 512, "bfloat16", 24),
    ("DCA GLU", 32, 48, 640, 1280, "float32", 10),
]
BATCH = 2
# conv2d_nhwc at the codec cell's shapes: a batch of 8 768x512 images, the
# latent's 32 x 48 (the hyper synthesis at 16 x 24); (label, H, W, C_in,
# C_out, k, act, launches of the shape per compress + decompress: two
# passes of the entropy side, 105 routed convolutions each)
CONV2D_BATCH = 8
CONV2D_CASES = [
    *((f"slice conv1 C{c}", 32, 48, c, 224, 3, "gelu", 4)
      for c in (960, 1024, 1088, 1152, 1216)),
    *((f"lrp conv1 C{c + 64}", 32, 48, c + 64, 224, 3, "gelu", 2)
      for c in (960, 1024, 1088, 1152, 1216)),
    ("slice conv2", 32, 48, 224, 128, 3, "gelu", 30),
    ("slice conv3", 32, 48, 128, 64, 3, "none", 30),
    ("DCA 1x1", 32, 48, 640, 640, 1, "none", 40),
    ("DCA in_trans", 32, 48, 640, 640, 1, "gelu", 30),
    ("DCA proj", 32, 48, 2560, 640, 1, "none", 10),
    ("h_z_s conv1", 16, 24, 192, 96, 1, "relu", 12),
    ("h_z_s conv2", 16, 24, 96, 96, 3, "relu", 12),
    ("h_z_s conv3", 16, 24, 96, 192, 1, "none", 12),
    ("h_z_s stack conv", 16, 24, 192, 192, 3, "none", 4),
]
# conv2d_nhwc launches of one pass of the entropy side at any widths: 45 in
# the slice nets, 40 in the dictionary attention, 20 in the hyper
# synthesis; the staged encoder leaves out the last slice's LRP net
CONV2D_PASS = 105
CONV2D_STAGED_COMPRESS = CONV2D_PASS - 3
# the training path: f32, batch 8 of 256x256 crops; launches a step forward
TRAIN_BATCH = 8
WMSA_TRAIN_CASES = [
    ("stage1 W", 128, 128, 96, 12, False, 2),
    ("stage2 W", 64, 64, 144, 9, False, 2),
    ("stage2 SW", 64, 64, 144, 9, True, 2),
    ("stage3 W", 32, 32, 256, 8, False, 12),
    ("stage3 SW", 32, 32, 256, 8, True, 12),
]
CONV_GLU_TRAIN_CASES = [
    ("stage3 GLU", 32, 32, 256, 512, 24),
    ("DCA GLU", 16, 16, 640, 1280, 5),
]
# max|grad - plain grad| / max|plain grad| of every operand: f32 both run
# the same f32 backward on forwards 1e-6 apart; bf16 differentiates the
# plain version without its bf16 rounding points
GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# the tiny model with window-8 stacks 96 channels wide, head_dim 8 (the
# tiny config's own head_dim 4 is not a width the wmsa kernels take), for
# the card-vs-CPU training step and the tiny run_training
TINY_W8 = dict(window_size=8, hyper_window_size=4, feature_dim=(96, 96, 96),
               head_dim=(8,) * 6)
# The tiny card-vs-CPU step's gradient bars, over the parameter tensors'
# max|card - CPU| / max|CPU|: their 90th percentile and their largest. A
# forward that is not f32-exact flips ReLU gates that lie that close to
# zero, which moves a few tensors' gradients by ~2e-3 of their max at
# errors from 1e-6 to 1e-5, so the largest is held loosely; the percentile
# grows with the error. Each run reads them on CPU steps whose window
# outputs carry seeded noise of e x their max: at the forward's own bar
# (witness, must pass: p90 1.5e-4 on an H100 machine's CPU) and at 10x it
# (control, must fail: 5.5e-4); the kernel's step read 4e-6 (PERF.md).
TINY_GRAD_P90, TINY_GRAD_MAX = 3e-4, 1e-2
TINY_NOISE = {"witness": TOL["float32"], "control": 10 * TOL["float32"]}
# the interleaved profile at batch 2 of 768x512: symbols a slice
# (2 x 48 x 32 x 64), slices, and the lanes _auto_lanes picks for them
RANS_N, RANS_SLICES, RANS_LANES = 196_608, 5, 512


def fail(msg: str) -> None:
    raise SystemExit(f"FAILED: {msg}")


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` launches (CUDA events) after
    `warmup` calls. The launches queue behind a sleep kernel that outlasts
    their enqueue, so they run back to back and the host's time to enqueue
    them (a wrapper's checks and allocations, ~0.1 ms: more than a small
    kernel runs) does not count (utils/profiling.py: device_ms)."""
    from dcae_tpu_torch.utils.profiling import device_ms

    for _ in range(warmup):
        fn()
    return device_ms(fn, iters)


def bound(nbytes: float, flops: float, dtype: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def rates(row: dict, flops: float, tf32x3_flops: float = 0.0) -> None:
    """Add the achieved TFLOP/s and the share of the bound (bound / time)
    to a kernel row. An f32 kernel whose products run 3xTF32 on the tensor
    cores (`tf32x3_flops` of its operations) also gets its ceiling, three
    tf32 products an f32 one at TF32_FLOPS, and its share of the lower of
    bound and ceiling (least_share): a tensor-core kernel can beat the f32
    FMA bound, never that ceiling."""
    row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
    row["bound_share"] = row["bound_ms"] / row["ms"]
    if tf32x3_flops:
        row["tf32x3_ceiling_ms"] = 3 * tf32x3_flops / TF32_FLOPS * 1e3
        row["least_share"] = min(row["bound_ms"],
                                 row["tf32x3_ceiling_ms"]) / row["ms"]


def share_text(row: dict) -> str:
    """The shares of a row for its printed line."""
    text = f"{100 * row['bound_share']:.1f}% of bound"
    if "tf32x3_ceiling_ms" in row:
        text += (f", 3xTF32 ceiling {row['tf32x3_ceiling_ms']:.4f} ms, "
                 f"{100 * row['least_share']:.1f}% of the lower")
    return text


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


# ------------------------------------------------------------- kernels --

def _uniform(gen, shape, bound_, device):
    import torch

    return ((torch.rand(shape, generator=gen) * 2 - 1) * bound_).to(device)


def wmsa_inputs(H, W, C, heads, dtype, gen, batch=BATCH):
    import torch

    dev = "cuda"
    x = torch.randn((batch, H, W, C), generator=gen).to(dev)
    p = [1 + 0.1 * torch.randn((C,), generator=gen),     # ln_w
         0.1 * torch.randn((C,), generator=gen),         # ln_b
         1 + 0.1 * torch.randn((C,), generator=gen)]     # rs
    p = [t.to(dev) for t in p]
    b = C ** -0.5
    p += [_uniform(gen, (3 * C, C), b, dev), _uniform(gen, (3 * C,), b, dev),
          _uniform(gen, (C, C), b, dev), _uniform(gen, (C,), b, dev),
          (0.02 * torch.randn((heads, 15, 15), generator=gen)).to(dev)]
    return x.to(dtype), [t.to(dtype).contiguous() for t in p]


def conv_glu_inputs(H, W, C, hidden, dtype, gen, batch=BATCH):
    import torch

    dev = "cuda"
    x = torch.randn((batch, H, W, C), generator=gen).to(dev)
    b1, b2 = C ** -0.5, hidden ** -0.5
    p = [(1 + 0.1 * torch.randn((C,), generator=gen)).to(dev),
         (0.1 * torch.randn((C,), generator=gen)).to(dev),
         _uniform(gen, (2 * hidden, C), b1, dev),
         _uniform(gen, (2 * hidden,), b1, dev),
         _uniform(gen, (hidden, 1, 3, 3), 1 / 3, dev),
         _uniform(gen, (hidden,), 1 / 3, dev),
         _uniform(gen, (C, hidden), b2, dev),
         _uniform(gen, (C,), b2, dev)]
    return x.to(dtype), [t.to(dtype).contiguous() for t in p]


def kernel_phase(gen) -> dict:
    import torch
    from dcae_tpu_torch.ops.kernels.conv_glu import conv_glu, conv_glu_ref
    from dcae_tpu_torch.ops.kernels.wmsa_attention import (
        wmsa_attention, wmsa_attention_ref)
    from dcae_tpu_torch.ops.kernels.wmsa_block import (wmsa_block,
                                                       wmsa_block_ref)
    from dcae_tpu_torch.utils.profiling import sdpa_call

    # wmsa_attention takes (x, wqkv, bqkv, wproj, bproj, rel): the block's
    # weights without ln_w, ln_b, rs
    wmsa_kernels = [("wmsa_block", wmsa_block, wmsa_block_ref, 0),
                    ("wmsa_attention", wmsa_attention, wmsa_attention_ref,
                     3)]
    results = {"wmsa_block": [], "conv_glu": [], "wmsa_attention": []}
    for name, fn, ref, skip in wmsa_kernels:
        for label, H, W, C, heads, shifted, per_run in WMSA_CASES:
            for dtype in ("bfloat16", "float32"):
                x, p = wmsa_inputs(H, W, C, heads, getattr(torch, dtype),
                                   gen)
                lib = sdpa_call(x, p[-1], heads, shifted)
                p = p[skip:]
                kw = dict(heads=heads, shifted=shifted)
                got = fn(x, *p, **kw)
                want = ref(x, *p, **kw)
                again = fn(x, *p, **kw)
                torch.cuda.synchronize()
                err = rel_err(got, want)
                repeat = bool(torch.equal(got, again))
                ok = bool(torch.isfinite(got.float()).all()) and \
                    err <= TOL[dtype] and repeat
                tokens = BATCH * H * W
                esize = x.element_size()
                nbytes = 2 * x.numel() * esize + \
                    sum(t.numel() for t in p) * esize
                # qkv 6 C^2, proj 2 C^2, attention 4 * 64 * C a token
                flops = tokens * (8 * C * C + 4 * 64 * C)
                b_ms, b_by = bound(nbytes, flops, dtype)
                row = {"case": f"{label} {dtype}", "rel_err": err,
                       "max_abs_err": float((got.float() - want.float())
                                            .abs().max()),
                       "tol": TOL[dtype], "bitwise_repeat": repeat, "ok": ok,
                       "main_path": dtype == "bfloat16", "per_run": per_run,
                       "ms": time_ms(lambda: fn(x, *p, **kw)),
                       "plain_ms": time_ms(lambda: ref(x, *p, **kw),
                                           iters=3, warmup=1),
                       "library_ms": time_ms(lib),
                       "bound_ms": b_ms, "bound_by": b_by}
                # f32: all four products run 3xTF32
                rates(row, flops, flops if dtype == "float32" else 0.0)
                print(f"{name} {row['case']}: rel err {err:.3e} (tol "
                      f"{TOL[dtype]:.0e}) bitwise repeat {repeat} ms "
                      f"{row['ms']:.4f} plain {row['plain_ms']:.3f} sdpa "
                      f"{row['library_ms']:.4f} bound {b_ms:.4f} ({b_by}) "
                      f"{row['tflops']:.1f} TFLOP/s, {share_text(row)}",
                      flush=True)
                results[name].append(row)
                del x, p, got, want, again, lib
    for label, H, W, C, hidden, dtype, per_run in CONV_GLU_CASES:
        x, p = conv_glu_inputs(H, W, C, hidden, getattr(torch, dtype), gen)
        got = conv_glu(x, *p)
        want = conv_glu_ref(x, *p)
        again = conv_glu(x, *p)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        repeat = bool(torch.equal(got, again))
        ok = bool(torch.isfinite(got.float()).all()) and err <= TOL[dtype] \
            and repeat
        tokens = BATCH * H * W
        esize = x.element_size()
        nbytes = 2 * x.numel() * esize + sum(t.numel() for t in p) * esize
        flops = tokens * (6 * C * hidden + 18 * hidden)
        b_ms, b_by = bound(nbytes, flops, dtype)
        row = {"case": f"{label} {dtype}", "rel_err": err,
               "max_abs_err": float((got.float() - want.float()).abs().max()),
               "tol": TOL[dtype], "bitwise_repeat": repeat, "ok": ok,
               "main_path": True, "per_run": per_run,
               "ms": time_ms(lambda: conv_glu(x, *p)),
               "plain_ms": time_ms(lambda: conv_glu_ref(x, *p), iters=3,
                                   warmup=1),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        # f32: fc1 and fc2 run 3xTF32 (the gate on the FMA units)
        rates(row, flops,
              tokens * 6 * C * hidden if dtype == "float32" else 0.0)
        print(f"conv_glu {row['case']}: rel err {err:.3e} (tol "
              f"{TOL[dtype]:.0e}) bitwise repeat {repeat} ms "
              f"{row['ms']:.4f} plain {row['plain_ms']:.3f} bound "
              f"{b_ms:.4f} ({b_by}) {row['tflops']:.1f} TFLOP/s, "
              f"{share_text(row)}", flush=True)
        results["conv_glu"].append(row)
        del x, p, got, want, again
    results["conv2d_nhwc"] = conv2d_rows(gen)
    bad = [r["case"] for rows in results.values() for r in rows
           if not r["ok"]]
    if bad:
        fail(f"kernel checks: {bad}")
    train_kernel_rows(results, gen)
    results.update(rans_phase())
    return results


def conv2d_rows(gen) -> list:
    """conv2d_nhwc at CONV2D_CASES against its plain statement (cuDNN f32,
    TF32 off): error against it and against f64, bitwise repeat, batch
    invariance (each image alone equals its place in the batch), ms, the
    f32 FMA bound and the 3xTF32 ceiling."""
    import torch
    from dcae_tpu_torch.ops.kernels.conv2d_nhwc import (conv2d_nhwc,
                                                        conv2d_nhwc_ref)

    rows = []
    B = CONV2D_BATCH
    for label, H, W, C, N, k, act, per_run in CONV2D_CASES:
        x = torch.randn((B, H, W, C), generator=gen).cuda()
        b = (C * k * k) ** -0.5
        w = _uniform(gen, (N, C, k, k), b, "cuda")
        bias = _uniform(gen, (N,), b, "cuda")
        with torch.no_grad():
            got = conv2d_nhwc(x, w, bias, act=act)
            want = conv2d_nhwc_ref(x, w, bias, act=act)
            f64 = conv2d_nhwc_ref(x.double(), w.double(), bias.double(),
                                  act=act)
            repeat = all(torch.equal(got, conv2d_nhwc(x, w, bias, act=act))
                         for _ in range(2))
            alone = all(torch.equal(conv2d_nhwc(x[i:i + 1], w, bias,
                                                act=act), got[i:i + 1])
                        for i in range(B))
            err = rel_err(got, want)
            scale = float(f64.abs().max())
            flops = 2 * B * H * W * N * k * k * C
            nbytes = 4 * (x.numel() + got.numel() + w.numel() + N)
            b_ms, b_by = bound(nbytes, flops, "float32")
            row = {"case": f"{label} float32", "rel_err": err,
                   "max_abs_err": float((got - want).abs().max()),
                   "f64_err": float((got - f64).abs().max()) / scale,
                   "plain_f64_err": float((want - f64).abs().max()) / scale,
                   "tol": TOL["float32"], "bitwise_repeat": repeat,
                   "batch_invariant": alone,
                   "ok": bool(torch.isfinite(got).all()) and repeat and
                   alone and err <= TOL["float32"],
                   "main_path": True, "per_run": per_run,
                   "ms": time_ms(lambda: conv2d_nhwc(x, w, bias, act=act)),
                   "plain_ms": time_ms(lambda: conv2d_nhwc_ref(
                       x, w, bias, act=act), iters=3, warmup=1),
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        rates(row, flops, flops)
        print(f"conv2d_nhwc {row['case']}: rel err {err:.3e} (tol "
              f"{TOL['float32']:.0e}), against f64 {row['f64_err']:.3e} "
              f"(plain {row['plain_f64_err']:.3e}), bitwise repeat "
              f"{repeat}, batch invariant {alone} ms {row['ms']:.4f} plain "
              f"{row['plain_ms']:.4f} bound {b_ms:.4f} ({b_by}) "
              f"{row['tflops']:.1f} TFLOP/s, {share_text(row)}", flush=True)
        rows.append(row)
        del x, w, bias, got, want, f64
    return rows


def time_backward_ms(forward, grad_out, iters: int = 3) -> float:
    """Mean device time of out.backward(grad_out) alone, over `iters`
    fresh forwards (CUDA events around each backward)."""
    import torch

    forward().backward(grad_out)                         # warm-up
    total = 0.0
    for _ in range(iters):
        out = forward()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out.backward(grad_out)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def grad_check(fn, ref, x, p, kw, gen) -> tuple:
    """(largest relative gradient error over the operands, the cotangent,
    the leaves): gradients of fn through its Function against autograd
    through the plain version, every operand a leaf."""
    import torch

    g = torch.randn(x.shape, generator=gen).to(x.device, x.dtype)
    a_fn = [t.detach().clone().requires_grad_(True) for t in (x, *p)]
    a_ref = [t.detach().clone().requires_grad_(True) for t in (x, *p)]
    out = fn(*a_fn, **kw)
    if out.grad_fn is None:
        fail("a wrapper returned no grad_fn for operands that require grad")
    out.backward(g)
    ref(*a_ref, **kw).backward(g)
    torch.cuda.synchronize()
    worst = 0.0
    for got, want in zip(a_fn, a_ref):
        if got.grad is None or got.grad.dtype != got.dtype or \
                not bool(torch.isfinite(got.grad.float()).all()):
            fail("a gradient is missing, of the wrong dtype or not finite")
        worst = max(worst, rel_err(got.grad, want.grad))
    return worst, g, a_fn


def train_kernel_rows(results: dict, gen) -> None:
    """The three wrappers in f32 at the training shapes: forward against
    the plain version (TOL) and bitwise repeatable, gradients through the
    autograd Function against autograd through the plain version
    (GRAD_TOL), forward and backward times, the f32 bound, the 3xTF32
    ceiling and, for the wmsa kernels, an SDPA call on the same windows;
    and the gradients of one bf16 call a kernel. Rows join `results` with
    train = True."""
    import torch
    from dcae_tpu_torch.ops.kernels.conv_glu import conv_glu, conv_glu_ref
    from dcae_tpu_torch.ops.kernels.wmsa_attention import (
        wmsa_attention, wmsa_attention_ref)
    from dcae_tpu_torch.ops.kernels.wmsa_block import (wmsa_block,
                                                       wmsa_block_ref)
    from dcae_tpu_torch.utils.profiling import sdpa_call

    dtype = "float32"

    def wmsa_case(H, W, C, heads, skip):
        def inputs(d):
            x, p = wmsa_inputs(H, W, C, heads, d, gen, TRAIN_BATCH)
            return x, p[skip:]
        return inputs

    def glu_case(H, W, C, hidden):
        return lambda d: conv_glu_inputs(H, W, C, hidden, d, gen,
                                         TRAIN_BATCH)

    # (kernel, wrapper, plain version, label, launches a step, inputs of a
    # dtype, static arguments, operations, of them in 3xTF32 products)
    cases = []
    for name, fn, ref, skip in (
            ("wmsa_block", wmsa_block, wmsa_block_ref, 0),
            ("wmsa_attention", wmsa_attention, wmsa_attention_ref, 3)):
        for label, H, W, C, heads, shifted, per_step in WMSA_TRAIN_CASES:
            flops = TRAIN_BATCH * H * W * (8 * C * C + 4 * 64 * C)
            cases.append((name, fn, ref, f"train {label}", per_step,
                          wmsa_case(H, W, C, heads, skip),
                          dict(heads=heads, shifted=shifted), flops, flops))
    for label, H, W, C, hidden, per_step in CONV_GLU_TRAIN_CASES:
        tokens = TRAIN_BATCH * H * W
        cases.append(("conv_glu", conv_glu, conv_glu_ref, f"train {label}",
                      per_step, glu_case(H, W, C, hidden), {},
                      tokens * (6 * C * hidden + 18 * hidden),
                      tokens * 6 * C * hidden))
    # the one shape a kernel whose gradients are also held in bf16
    bf16_too = {"wmsa_block": "train stage3 SW",
                "wmsa_attention": "train stage3 SW",
                "conv_glu": "train stage3 GLU"}
    bad = []
    for name, fn, ref, label, per_step, inputs, kw, flops, tf_flops in cases:
        x, p = inputs(torch.float32)
        with torch.no_grad():
            got, want = fn(x, *p, **kw), ref(x, *p, **kw)
            again = fn(x, *p, **kw)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            abs_err = float((got - want).abs().max())
            repeat = bool(torch.equal(got, again))
            ms = time_ms(lambda: fn(x, *p, **kw))
            plain_ms = time_ms(lambda: ref(x, *p, **kw), iters=2, warmup=1)
            lib_ms = time_ms(sdpa_call(x, p[-1], kw["heads"],
                                       kw["shifted"])) \
                if name != "conv_glu" else None
        del got, want, again
        g_err, g, leaves = grad_check(fn, ref, x, p, kw, gen)
        bwd_ms = time_backward_ms(lambda: fn(*leaves, **kw), g)
        ref_leaves = [t.detach().clone().requires_grad_(True)
                      for t in leaves]
        plain_bwd_ms = time_backward_ms(lambda: ref(*ref_leaves, **kw), g,
                                        iters=2)
        nbytes = (2 * x.numel() + sum(t.numel() for t in p)) * 4
        b_ms, b_by = bound(nbytes, flops, dtype)
        ok = err <= TOL[dtype] and g_err <= GRAD_TOL[dtype] and repeat
        row = {"case": f"{label} {dtype}", "rel_err": err,
               "max_abs_err": abs_err, "tol": TOL[dtype],
               "bitwise_repeat": repeat,
               "grad_rel_err": g_err, "grad_tol": GRAD_TOL[dtype], "ok": ok,
               "main_path": False, "train": True, "per_step": per_step,
               "ms": ms, "backward_ms": bwd_ms, "plain_ms": plain_ms,
               "plain_backward_ms": plain_bwd_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by}
        rates(row, flops, tf_flops)
        lib = "" if lib_ms is None else f" sdpa {lib_ms:.4f}"
        print(f"{name} {row['case']}: rel err {err:.3e} (tol "
              f"{TOL[dtype]:.0e}) bitwise repeat {repeat} grad rel err "
              f"{g_err:.3e} (tol {GRAD_TOL[dtype]:.0e}) forward ms "
              f"{ms:.4f} backward {bwd_ms:.3f} plain forward "
              f"{plain_ms:.3f} plain backward {plain_bwd_ms:.3f}{lib} bound "
              f"{b_ms:.4f} ({b_by}) {row['tflops']:.1f} TFLOP/s, "
              f"{share_text(row)}", flush=True)
        results[name].append(row)
        if not ok:
            bad.append(f"{name} {row['case']}")
        del x, p, g, leaves, ref_leaves
        if label == bf16_too[name]:
            x, p = inputs(torch.bfloat16)
            g_err, _, _ = grad_check(fn, ref, x, p, kw, gen)
            print(f"{name} {label} bfloat16: grad rel err {g_err:.3e} "
                  f"(tol {GRAD_TOL['bfloat16']:.0e})", flush=True)
            if g_err > GRAD_TOL["bfloat16"]:
                bad.append(f"{name} {label} bfloat16 gradients")
            row["bf16_grad_rel_err"] = g_err
            del x, p
        torch.cuda.empty_cache()
    if bad:
        fail(f"training-shape kernel checks: {bad}")


def draw_symbols(g, n: int, S: int, rng, narrow: int = 0) -> tuple:
    """(symbols, indexes), (S, n) int32 each: a uniform CDF row per symbol
    (with `narrow`, one of the `narrow` narrowest rows, as a trained
    model's latents mostly code) and the symbol drawn from that row's own
    quantized pmf (the escape bucket's mass goes to the last in-range
    bucket)."""
    rows = g.quantized_cdf.shape[0]
    idx = rng.integers(0, narrow or rows, (S, n)).astype(np.int32)
    slot = rng.integers(0, 1 << 16, (S, n))
    pos = np.empty((S, n), np.int64)
    for r in range(rows):
        m = idx == r
        cdf = g.quantized_cdf[r, :g.cdf_length[r]]
        pos[m] = np.searchsorted(cdf, slot[m], side="right") - 1
    pos = np.minimum(pos, g.cdf_length[idx] - 3)
    return (pos + g.offset[idx]).astype(np.int32), idx


def sm_clock_mhz(fn, seconds: float = 1.0) -> float:
    """The median SM clock nvidia-smi reads while fn() runs back to back
    for about `seconds` (a step's cycles are its ns times this clock)."""
    import torch

    mon = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        mon.terminate()
        out, _ = mon.communicate(timeout=30)
    clocks = [float(v) for v in out.split() if v.strip()]
    return float(np.median(clocks)) if clocks else float("nan")


# the lane coders' shapes: (batch of 768x512, lanes), the lanes
# _auto_lanes picks at batch 1, 2 and 8, and the wide kernels at 2048; the
# path's shape is batch 2
RANS_SHAPES = [(1, 256), (2, RANS_LANES), (8, 1024), (8, 2048)]
RANS_NARROW = 8        # the narrow draw's rows: the 8 narrowest


def rans_phase() -> dict:
    """The lane-coder kernels at the path's shapes, chained over 5 slices,
    against their plain versions and the C++ host coder: exact equality,
    on drawn symbols and on a narrow-row draw, at K = 256, 512, 1024 and
    (the wide kernels) 2048."""
    import torch
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.entropy import device_decode as dd
    from dcae_tpu_torch.entropy import rans
    from dcae_tpu_torch.entropy.gaussian import get_scale_table
    from dcae_tpu_torch.entropy.tables import build_gaussian_table
    from dcae_tpu_torch.models.codec import _auto_lanes
    from dcae_tpu_torch.ops.kernels import rans_lanes as rl

    cfg = DCAEConfig()
    S = RANS_SLICES
    n_img = RANS_N // BATCH
    for B, K in RANS_SHAPES[:3]:
        if (S, K) != (cfg.num_slices, _auto_lanes(B * n_img)):
            fail(f"lane coders: the path codes {cfg.num_slices} slices of "
                 f"{B * n_img} symbols on {_auto_lanes(B * n_img)} lanes, "
                 f"this phase {S} on {K}")
    g = build_gaussian_table(
        get_scale_table(cfg.scales_min, cfg.scales_max, cfg.scales_levels),
        tail_mass=cfg.gc_tail_mass)
    tables = (g.quantized_cdf, g.cdf_length, g.offset)
    dev = "cuda"
    offs_d, table_d = dd.row_tables_to_device(dd.build_row_tables(*tables),
                                              dev)
    rng = np.random.default_rng(5)

    def one_case(B: int, K: int, narrow: int, main: bool) -> dict:
        n = B * n_img
        sym, idx = draw_symbols(g, n, S, rng, narrow)
        # the host coder: chained encode (last slice first), chained decode
        t0 = time.perf_counter()
        streams, st = [None] * S, None
        for s in reversed(range(S)):
            streams[s], st = rans.encode_interleaved(sym[s], idx[s], *tables,
                                                     K, init_states=st)
        host_enc_ms = (time.perf_counter() - t0) * 1e3
        header = st.copy()
        t0 = time.perf_counter()
        cur = header
        for s in range(S):
            out, cur = rans.decode_interleaved_ref(streams[s], cur, idx[s],
                                                   *tables, K,
                                                   return_states=True)
            if not np.array_equal(out, sym[s]):
                fail("host coder does not decode its own stream")
        host_dec_ms = (time.perf_counter() - t0) * 1e3
        n_words = np.array([len(b) // 2 for b in streams], np.int32)

        idx_d = torch.from_numpy(idx).to(dev)
        pos_d = torch.from_numpy(sym - g.offset[idx]).to(dev)
        in_range = torch.ones((S, n), dtype=torch.bool, device=dev)

        def encode_chain(fn):
            res, state = [None] * S, None
            for s in reversed(range(S)):
                res[s] = fn(pos_d[s], idx_d[s], in_range[s], table_d, K,
                            state)
                state = res[s][2]
            return res

        got = encode_chain(rl.rans_lanes_encode)
        want = encode_chain(rl.rans_lanes_encode_ref)
        torch.cuda.synchronize()
        enc_ok = True
        for s in range(S):
            (w, nw, st_k, esc), (w_p, nw_p, st_p, esc_p) = got[s], want[s]
            enc_ok &= bool(torch.equal(w, w_p) and torch.equal(nw, nw_p)
                           and torch.equal(st_k, st_p)
                           and torch.equal(esc, esc_p) and not bool(esc))
            enc_ok &= int(nw) == n_words[s] and \
                rl.to_u16(w)[:int(nw)][::-1].tobytes() == streams[s]
        enc_ok &= np.array_equal(rl.to_u32(got[0][2]), header)
        # an out-of-range mark on one symbol must raise the escape flag
        marked = in_range[0].clone()
        marked[n // 3] = False
        enc_ok &= bool(rl.rans_lanes_encode(pos_d[0], idx_d[0], marked,
                                            table_d, K)[3])

        words = np.zeros((S, int(n_words.max()) + 1000), np.uint16)  # padded
        for s in range(S):
            words[s, :n_words[s]] = np.frombuffer(streams[s], np.uint16)
        words_d = torch.from_numpy(words.view(np.int16)).to(dev)
        nw_d = torch.from_numpy(n_words).to(dev)
        header_d = rl.u32_bits(header, dev)

        def decode_chain(fn, words_d=words_d, start=header_d):
            res, state = [], start
            for s in range(S):
                res.append(fn(words_d[s], nw_d[s], state, idx_d[s], offs_d,
                              table_d, K, s == S - 1))
                state = res[-1][2]
            return res

        def all_ok(res) -> bool:
            return all(bool(r[1]) for r in res)

        got_d = decode_chain(rl.rans_lanes_decode)
        want_d = decode_chain(rl.rans_lanes_decode_ref)
        torch.cuda.synchronize()
        dec_ok = all_ok(got_d) and bool((got_d[-1][2] == rl.RANS_L16).all())
        for s in range(S):
            dec_ok &= all(bool(torch.equal(a, b))
                          for a, b in zip(got_d[s], want_d[s]))
            dec_ok &= np.array_equal(got_d[s][0].cpu().numpy(), sym[s])
        flipped = words_d.clone()
        flipped[2, 50] ^= -1
        # every lane's state one up: a single lane's may go unseen, where
        # x and x + 1 fall in two one-slot buckets and step to one state
        bumped = header_d + 1
        corrupt_found = not all_ok(decode_chain(rl.rans_lanes_decode,
                                                words_d=flipped)) \
            and not all_ok(decode_chain(rl.rans_lanes_decode, start=bumped))

        # one run of the path = the chain of 5 launches; a slice = a fifth
        enc_ms = time_ms(lambda: encode_chain(rl.rans_lanes_encode)) / S
        dec_ms = time_ms(lambda: decode_chain(rl.rans_lanes_decode)) / S
        enc_plain = dec_plain = None
        if main:
            enc_plain = time_ms(lambda: encode_chain(rl.rans_lanes_encode_ref),
                                iters=1, warmup=0) / S
            dec_plain = time_ms(lambda: decode_chain(rl.rans_lanes_decode_ref),
                                iters=1, warmup=0) / S
        mhz = sm_clock_mhz(lambda: (encode_chain(rl.rans_lanes_encode),
                                    decode_chain(rl.rans_lanes_decode)))
        total_words = int(n_words.sum())
        steps = -(-n // K)
        # bytes a slice, each input read once and each output written once:
        # the stream's words (what this run's symbols need, not the
        # buffer), 4 n of indexes, 4 n of symbols or positions, the
        # encoder's n flags, K states in and K out, and the row table
        stream_bytes = 2 * total_words / S
        tab_bytes = table_d.numel() * 4
        label = (f"B={B} n={n} K={K} x{S} chained "
                 f"{'narrow' if narrow else 'drawn'}")
        rows = {}
        for name, ok, ms, plain, host, nbytes, kind in (
                ("rans_lanes_decode", dec_ok and corrupt_found, dec_ms,
                 dec_plain, host_dec_ms / S,
                 stream_bytes + 8 * n + tab_bytes + 8 * K, "decode"),
                ("rans_lanes_encode", enc_ok, enc_ms, enc_plain,
                 host_enc_ms / S,
                 stream_bytes + 9 * n + tab_bytes + 8 * K, "encode")):
            b_ms = nbytes / H100_BYTES_PER_S * 1e3
            step_ns = ms * 1e6 / steps
            row = {"case": label, "rel_err": 0.0, "max_abs_err": 0.0,
                   "tol": 0.0, "ok": bool(ok), "main_path": main,
                   "per_run": S if main else 0, "ms": ms,
                   "plain_ms": plain, "library_ms": None,
                   "host_coder_ms": host, "bound_ms": b_ms,
                   "bound_by": "bytes", "bound_bytes": nbytes,
                   "bound_share": b_ms / ms, "chain_steps": steps,
                   "step_ns": step_ns, "sm_clock_mhz": mhz,
                   "step_cycles": step_ns * mhz / 1e3,
                   "smem_bytes": rl.smem_bytes(kind, table_d, K,
                                               offs_d.numel()),
                   "bits_per_symbol": 16 * total_words / (S * n)}
            plain_text = "" if plain is None else f" plain {plain:.1f}"
            print(f"{name} {label}: exact vs plain and host coder "
                  f"{row['ok']}, ms a slice {ms:.4f}{plain_text} host C++ "
                  f"coder {host:.3f} bound {b_ms:.5f} (bytes); a chain of "
                  f"{steps} steps, {step_ns:.1f} ns = "
                  f"{row['step_cycles']:.0f} SM cycles a step at {mhz:.0f} "
                  f"MHz (nvidia-smi clocks.sm); shared memory "
                  f"{row['smem_bytes']} B; {row['bits_per_symbol']:.2f} "
                  "bits a symbol", flush=True)
            rows[name] = row
        if not dec_ok:
            fail(f"rans_lanes_decode {label}: differs from its plain "
                 "version or the host coder")
        if not corrupt_found:
            fail(f"rans_lanes_decode {label}: a flipped word or bumped "
                 "state kept ok")
        if not enc_ok:
            fail(f"rans_lanes_encode {label}: differs from its plain "
                 "version or the host coder")
        return rows

    print(f"lane coders: row table {table_d.numel() * 4} B "
          f"({g.quantized_cdf.shape[0]} rows)", flush=True)
    results = {"rans_lanes_decode": [], "rans_lanes_encode": []}
    for B, K in RANS_SHAPES:
        for narrow in (0, RANS_NARROW):
            main = (B, K, narrow) == (BATCH, RANS_LANES, 0)
            for name, row in one_case(B, K, narrow, main).items():
                results[name].append(row)
    return results


def kernel_summary(results: dict, launches: dict,
                   train_launches: dict | None = None) -> list:
    """One entry per kernel: its time over one compress + decompress at
    the shapes of the path that runs it (per-shape time x launches of that
    shape); launches as counted on that path. Kernels with rows at the
    training shapes also get "train_step": their f32 forward and backward
    time over one training step's launches, and the launches counted in
    the train phase's step (wmsa_attention: the attention-only step)."""
    meta = {
        "wmsa_block": ("dcae_tpu_torch/csrc/wmsa_block.cu",
                       "dcae_tpu/ops/pallas/wmsa_v4.py:168"),
        "conv_glu": ("dcae_tpu_torch/csrc/conv_glu.cu",
                     "dcae_tpu/ops/pallas/conv_glu.py:190"),
        "wmsa_attention": ("dcae_tpu_torch/csrc/wmsa_block.cu",
                           "dcae_tpu/ops/pallas/wmsa_v3.py:215"),
        # no TPU kernel: the JAX package leaves convolutions to XLA
        "conv2d_nhwc": ("dcae_tpu_torch/csrc/conv2d_nhwc.cu", "none (XLA)"),
        # XLA loops in the JAX package, not Pallas kernels
        "rans_lanes_decode": ("dcae_tpu_torch/csrc/rans_lanes.cu",
                              "dcae_tpu/entropy/device_decode.py:153"),
        "rans_lanes_encode": ("dcae_tpu_torch/csrc/rans_lanes.cu",
                              "dcae_tpu/entropy/device_decode.py:428"),
    }
    out = []
    for name, rows in results.items():
        main = [r for r in rows if r["main_path"]]
        tot = lambda key: sum(r[key] * r["per_run"] for r in main)  # noqa
        lib = (None if any(r["library_ms"] is None for r in main)
               else tot("library_ms"))
        by_ops = sum(r["bound_ms"] * r["per_run"] for r in main
                     if r["bound_by"] == "operations")
        out.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": "operations" if by_ops >= tot("bound_ms") / 2
            else "bytes",
            "library_ms": lib,
            "shapes": [{k: r[k] for k in ("case", "ms", "plain_ms",
                                          "library_ms", "bound_ms",
                                          "bound_by", "rel_err", "per_run",
                                          "tflops", "bound_share",
                                          "tf32x3_ceiling_ms",
                                          "least_share", "bitwise_repeat",
                                          "batch_invariant", "f64_err",
                                          "plain_f64_err",
                                          "host_coder_ms", "chain_steps",
                                          "step_ns", "step_cycles",
                                          "sm_clock_mhz", "smem_bytes",
                                          "bound_bytes",
                                          "bits_per_symbol", "train",
                                          "per_step", "backward_ms",
                                          "plain_backward_ms",
                                          "grad_rel_err",
                                          "bf16_grad_rel_err") if k in r}
                       for r in rows],
        })
        train = [r for r in rows if r.get("train")]
        if train:
            # the f32 training path: forward and recompute-backward time
            # of one step's launches at its shapes, and their bound
            out[-1]["train_step"] = {
                key: sum(r[src] * r["per_step"] for r in train)
                for key, src in (("forward_ms", "ms"),
                                 ("backward_ms", "backward_ms"),
                                 ("plain_forward_ms", "plain_ms"),
                                 ("bound_ms", "bound_ms"))}
            for key in ("library_ms", "tf32x3_ceiling_ms"):
                if all(r.get(key) is not None for r in train):
                    out[-1]["train_step"][key] = sum(
                        r[key] * r["per_step"] for r in train)
            out[-1]["train_step"]["launches"] = train_launches.get(name) \
                if train_launches else None
    return out


# ----------------------------------------------------------- reference --

def reference_phase() -> None:
    """Full-width f32 model on the card (kernels) against the same seeded
    weights on the CPU (plain versions), on one 128x128 image."""
    import torch
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.codec import DCAECodec

    cfg = DCAEConfig()
    img = synthetic_kodak(1, 128, 128, seed=7)
    outs = {}
    for dev in ("cpu", "cuda"):
        codec = DCAECodec(cfg, seed=0, device=dev)
        with torch.no_grad():
            out = codec.forward(img)
        outs[dev] = {"y": out["para"]["y"].cpu(),
                     "x_hat": out["x_hat"].cpu().clamp(0, 1)}
        del codec
    y_err = rel_err(outs["cuda"]["y"], outs["cpu"]["y"])
    mse = float(((outs["cuda"]["x_hat"] - outs["cpu"]["x_hat"]) ** 2).mean())
    psnr = 10 * np.log10(1.0 / max(mse, 1e-20))
    finite = all(bool(torch.isfinite(t).all()) for o in outs.values()
                 for t in o.values())
    print(f"reference: y rel err {y_err:.3e} (tol 1e-3), x_hat card vs CPU "
          f"PSNR {psnr:.2f} dB (min 40), finite {finite}", flush=True)
    if not (finite and y_err <= 1e-3 and psnr >= 40):
        fail("full-width model on the card disagrees with the CPU")


# --------------------------------------------------------------- slice --

def counted(fn):
    """Run fn() with every launch counter set to 0 just before it, then
    synchronize; returns (result, counts read just after, host ms)."""
    import torch

    kernels = wrappers()
    for w in kernels.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, {k: w.launches for k, w in kernels.items()}, ms


def median_ms(fn, first_ms: float, per: int) -> tuple:
    """Median host ms per image of fn() over the counted run plus four
    more (each synchronized), and the five samples."""
    import torch

    runs = [first_ms / per]
    for _ in range(4):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3 / per)
    return float(np.median(runs)), runs


def exact(enc_record, dec_record, n: int) -> bool:
    return len(enc_record) == len(dec_record) == n and all(
        np.array_equal(ei, di) and np.array_equal(es, ds)
        for (ei, es), (di, ds) in zip(enc_record, dec_record))


def check_counts(what: str, counts: dict, want: dict) -> None:
    """The launch counts of the kernels `want` names must equal it; those
    of kernels it leaves out (conv2d_nhwc off the codec paths) are not
    held."""
    got = {k: counts.get(k) for k in want}
    if got != want:
        fail(f"{what}: launch counts {got}, want {want} (all: {counts})")


def quality(x_hat, imgs: np.ndarray, nbytes: int) -> tuple:
    """(bpp, PSNR dB) of a decode; fails unless x_hat is finite and of the
    images' shape."""
    x_hat = x_hat.float().cpu().numpy()
    ref = imgs.astype(np.float32) / 255.0
    if x_hat.shape != ref.shape or not np.isfinite(x_hat).all():
        fail("x_hat is not finite or has the wrong shape")
    mse = float(np.mean((x_hat - ref) ** 2))
    B, H, W, _ = imgs.shape
    return nbytes * 8 / (B * H * W), 10 * np.log10(1.0 / max(mse, 1e-20))


def run_staged(codec, imgs: np.ndarray, label: str, want: dict) -> dict:
    """The staged compress -> .bin files -> per-slice decompress, counted
    and timed; exact decode and the launch counts `want` per direction
    (the compress without the last slice's LRP net: three conv2d_nhwc
    launches fewer)."""
    from dcae_tpu_torch.runtime.container import read_bin, save_bin

    cfg = codec.cfg
    B, H, W, _ = imgs.shape
    codec.decompress(**_strings(codec.compress(imgs)))   # warm-up, uncounted

    enc_record: list = []
    enc, enc_counts, enc_ms = counted(
        lambda: codec.compress(imgs, mode="staged", record=enc_record))
    with tempfile.TemporaryDirectory(prefix="dcae_smoke_") as tmp:
        y_strings, z_strings = [], []
        nbytes = 0
        for b in range(B):
            path = os.path.join(tmp, f"img{b}.bin")
            save_bin(path, [[enc["strings"][0][b]], [enc["strings"][1][b]]],
                     (H, W))
            nbytes += os.path.getsize(path)
            strings, z_shape, _, size = read_bin(path, cfg.pad_multiple,
                                                 cfg.z_downsample)
            if tuple(z_shape) != tuple(enc["shape"]) or size != (H, W):
                fail(f"{label}: .bin header: {z_shape} {size}")
            y_strings.append(strings[0][0])
            z_strings.append(strings[1][0])

    dec_record: list = []
    dec, dec_counts, dec_ms = counted(
        lambda: codec.decompress([y_strings, z_strings], z_shape,
                                 record=dec_record))
    enc_med, enc_runs = median_ms(lambda: codec.compress(imgs, mode="staged"),
                                  enc_ms, B)
    dec_med, dec_runs = median_ms(lambda: codec.decompress(**_strings(enc)),
                                  dec_ms, B)
    ok = exact(enc_record, dec_record, cfg.num_slices)
    bpp, psnr = quality(dec["x_hat"], imgs, nbytes)
    res = {"bpp": bpp, "psnr_db": psnr,
           "encode_ms_per_image": enc_med, "decode_ms_per_image": dec_med,
           "encode_ms_runs": enc_runs, "decode_ms_runs": dec_runs,
           "exact_decode": ok,
           "launches_compress": enc_counts,
           "launches_decompress": dec_counts,
           "x_hat_shape": list(dec["x_hat"].shape)}
    print(f"{label}: " + json.dumps(res), flush=True)
    if not ok:
        fail(f"{label}: decoded indexes/symbols differ from the encoder's")
    check_counts(f"{label} compress", enc_counts,
                 {**want, "conv2d_nhwc": CONV2D_STAGED_COMPRESS})
    check_counts(f"{label} decompress", dec_counts, want)
    res["strings"] = enc["strings"]
    res["x_hat"] = dec["x_hat"]
    return res


def run_certified(codec, imgs: np.ndarray, staged: dict, want: dict
                  ) -> dict:
    """self_check, then the certified mode's compress and the shipped-index
    decode, each counted and timed against the staged part."""
    B = imgs.shape[0]
    t0 = time.perf_counter()
    certified = codec.self_check()
    check_s = time.perf_counter() - t0
    mode = codec.encode_mode
    print(f"certified: self_check() {certified}, mode {mode} "
          f"({check_s:.2f} s)", flush=True)
    if not certified or mode == "staged":
        fail("self_check did not certify a one-fetch encoder mode")

    enc_record: list = []
    enc, enc_counts, enc_ms = counted(
        lambda: codec.compress(imgs, record=enc_record))
    dec_record: list = []
    dec, dec_counts, _ = counted(
        lambda: codec.decompress(**_strings(enc), record=dec_record))
    same_stream = enc["strings"] == staged["strings"]
    ok = exact(enc_record, dec_record, codec.cfg.num_slices)

    shipped_enc = codec.compress_with_indexes(imgs)
    per_slice = codec.decompress(**_strings(shipped_enc))["x_hat"]
    shipped, ship_counts, ship_ms = counted(
        lambda: codec.decompress(**_strings(shipped_enc),
                                 indexes=shipped_enc["indexes"])["x_hat"])
    ship_diff = float((shipped - per_slice).abs().max())
    enc_med, enc_runs = median_ms(lambda: codec.compress(imgs), enc_ms, B)
    ship_med, ship_runs = median_ms(
        lambda: codec.decompress(**_strings(shipped_enc),
                                 indexes=shipped_enc["indexes"]), ship_ms, B)
    res = {"mode": mode, "self_check": certified,
           "stream_equals_staged": same_stream, "exact_decode": ok,
           "encode_ms_per_image": enc_med, "encode_ms_runs": enc_runs,
           "shipped_decode_ms_per_image": ship_med,
           "shipped_decode_ms_runs": ship_runs,
           "shipped_vs_per_slice_max_abs_diff": ship_diff,
           "staged_encode_ms_per_image": staged["encode_ms_per_image"],
           "per_slice_decode_ms_per_image": staged["decode_ms_per_image"],
           "launches_compress": enc_counts,
           "launches_decompress": dec_counts,
           "launches_shipped_decompress": ship_counts}
    print("certified: " + json.dumps(res), flush=True)
    if not same_stream:
        fail(f"certified: {mode} streams differ from the staged streams")
    if not ok:
        fail("certified: decoded indexes/symbols differ from the encoder's")
    if ship_diff != 0.0:
        fail(f"certified: shipped-index x_hat differs from the per-slice "
             f"decode by {ship_diff}")
    check_counts(f"certified {mode} compress", enc_counts, want)
    check_counts("certified decompress", dec_counts, want)
    check_counts("shipped-index decompress", ship_counts, want)
    return res


def dti_bytes(enc: dict) -> int:
    """Bytes of the DTI container(s) of an enc dict, computed from the
    layout (runtime/container.py): a header, the lane states, each slice's
    stream and patches, the z streams. A batch counts one header and state
    set, as its images share the lane set."""
    states = np.asarray(enc["states"])
    return (15 + 4 * states.size
            + sum(4 + len(b) for b in enc["istreams"])
            + sum(2 + 8 * len(p[0]) for p in enc["patches"])
            + sum(4 + len(z) for z in enc["z_strings"]))


def same_streams(a: dict, b: dict) -> bool:
    return (a["istreams"] == b["istreams"]
            and np.array_equal(a["states"], b["states"])
            and a["z_strings"] == b["z_strings"]
            and len(a["patches"]) == len(b["patches"])
            and all(np.array_equal(pa, pb) and np.array_equal(va, vb)
                    for (pa, va), (pb, vb) in zip(a["patches"],
                                                  b["patches"])))


def no_host_wait(fn):
    """fn() under torch.cuda.set_sync_debug_mode("error"): any operation
    that makes the host wait for the device raises."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(before)


def open_patch_cap(codec, x_dev, label: str) -> tuple:
    """Random weights put symbols outside the coding tables; the profile
    carries them in a patch list of at most codec.patch_cap a slice. Prints
    each slice's count and, only where one exceeds the cap, sets the cap to
    the slice's symbol count. Returns (counts, opened)."""
    S = codec.cfg.num_slices
    pend = codec._compress_device_dispatch(x_dev)
    counts = [int(c) for c in pend["head"].cpu().numpy()[S:2 * S]]
    n_slice = pend["cap"] - 1
    print(f"{label}: {n_slice} symbols a slice on {pend['K']} lanes; "
          f"out-of-table symbols a slice {counts} (patch_cap "
          f"{codec.patch_cap})", flush=True)
    opened = max(counts) > codec.patch_cap
    if opened:
        codec.patch_cap = n_slice
        print(f"{label}: more than a patch list holds (random weights): "
              f"codec.patch_cap set to {n_slice}", flush=True)
    return counts, opened


def run_interleaved(codec, imgs: np.ndarray, staged: dict,
                    certified: dict) -> dict:
    """The device-coding profile on the staged part's codec, images and
    weights: compress_device -> decompress_interleaved, counted, checked
    against the staged decode and the host coder, timed; the DTI2 file
    round trip; the serving loop."""
    import torch
    from dcae_tpu_torch.runtime import container

    cfg = codec.cfg
    B, H, W, _ = imgs.shape
    S = cfg.num_slices
    x_dev = codec._input(imgs)
    zero = {"wmsa_attention": 0, "conv2d_nhwc": CONV2D_PASS}
    want_enc = {"wmsa_block": 15, "conv_glu": 17, "rans_lanes_encode": S,
                "rans_lanes_decode": 0, **zero}
    want_dec = {"wmsa_block": 15, "conv_glu": 17, "rans_lanes_encode": 0,
                "rans_lanes_decode": S, **zero}

    _, opened = open_patch_cap(codec, x_dev, "interleaved")
    n_slice = B * (H // cfg.y_downsample) * (W // cfg.y_downsample) \
        * cfg.slice_dim

    codec.decompress_interleaved(codec.compress_device(imgs))   # warm-up
    enc, enc_counts, enc_ms = counted(lambda: codec.compress_device(imgs))
    dec, dec_counts, dec_ms = counted(
        lambda: codec.decompress_interleaved(enc))
    # the kernels phase held the lane coders to their plain versions at
    # (RANS_N, RANS_SLICES, RANS_LANES): the path must launch them there
    if (n_slice, S, enc["lanes"]) != (RANS_N, RANS_SLICES, RANS_LANES):
        fail(f"interleaved: the path coded {S} slices of {n_slice} symbols "
             f"on {enc['lanes']} lanes, the kernels phase {RANS_SLICES} of "
             f"{RANS_N} on {RANS_LANES}")
    ok = bool(dec["ok"])
    same_x = bool(torch.equal(dec["x_hat"], staged["x_hat"]))
    host_enc, _, host_ms = counted(lambda: codec.compress_interleaved(imgs))
    same_host = same_streams(enc, host_enc)
    bad = dict(enc)
    worst = max(range(S), key=lambda s: len(enc["istreams"][s]))
    stream = bytearray(enc["istreams"][worst])
    stream[len(stream) // 2] ^= 0xFF
    bad["istreams"] = [bytes(stream) if s == worst else b
                       for s, b in enumerate(enc["istreams"])]
    corrupt_ok = bool(codec.decompress_interleaved(bad)["ok"])

    # the dispatch phase and the device part of the decode, with every
    # host wait an error
    pend = no_host_wait(lambda: codec._compress_device_dispatch(x_dev))
    inputs = codec._interleaved_inputs(enc)
    dec2 = no_host_wait(
        lambda: codec._decompress_interleaved_device(*inputs))
    no_wait_same = same_streams(enc, codec._compress_device_fetch(pend)) \
        and bool(dec2["ok"]) and bool(torch.equal(dec2["x_hat"],
                                                  dec["x_hat"]))

    enc_med, enc_runs = median_ms(lambda: codec.compress_device(imgs),
                                  enc_ms, B)
    dec_med, dec_runs = median_ms(lambda: codec.decompress_interleaved(enc),
                                  dec_ms, B)
    host_med, _ = median_ms(lambda: codec.compress_interleaved(imgs),
                            host_ms, B)
    nbytes = dti_bytes(enc)
    bpp, psnr = quality(dec["x_hat"], imgs, nbytes)

    # one image as a DTI2 file: pack -> file -> unpack -> decode
    one = codec.compress_device(imgs[:1])
    one_counts = [len(p[0]) for p in one["patches"]]
    file_trip = None
    if max(one_counts) < 1 << 16:
        blob = container.pack_bin_interleaved(one, (H, W))
        with tempfile.TemporaryDirectory(prefix="dcae_smoke_") as tmp:
            path = os.path.join(tmp, "img0.bin")
            with open(path, "wb") as f:
                f.write(blob)
            with open(path, "rb") as f:
                data = f.read()
        back, _, size = container.unpack_bin_interleaved(
            data, cfg.pad_multiple, cfg.z_downsample)
        d_file = codec.decompress_interleaved(back)
        d_mem = codec.decompress_interleaved(one)
        file_trip = (container.is_interleaved_bin(data)
                     and data[:4] == b"DTI2" and size == (H, W)
                     and len(blob) == dti_bytes(one)
                     and same_streams(one, back)
                     and bool(d_file["ok"])
                     and bool(torch.equal(d_file["x_hat"],
                                          d_mem["x_hat"])))
        print(f"interleaved: DTI2 file round trip of image 0 "
              f"({len(blob)} bytes, patches a slice {one_counts}): "
              f"{file_trip}", flush=True)
    else:
        print(f"interleaved: DTI2 file round trip skipped: patches a "
              f"slice {one_counts} do not fit the container's 16-bit "
              "count", flush=True)

    # the serving loop: 3 batches, every one through the profile
    t0 = time.perf_counter()
    outs = codec.encdec_pipeline_interleaved([imgs] * 3)
    torch.cuda.synchronize()
    pipe_ms = (time.perf_counter() - t0) * 1e3 / (3 * B)
    # a longer run: the producer thread's first calls (its own cuDNN and
    # cuBLAS handles) weigh less
    t0 = time.perf_counter()
    outs8 = codec.encdec_pipeline_interleaved([imgs] * 8)
    torch.cuda.synchronize()
    pipe8_ms = (time.perf_counter() - t0) * 1e3 / (8 * B)
    outs = outs + outs8[-1:]
    profiles = [o["profile"] for o in outs[:3]]
    pipe_ok = len(outs) == 4 and all(
        bool(o["ok"]) and bool(torch.equal(o["x_hat"], dec["x_hat"]))
        for o in outs)

    res = {"ok": ok, "x_hat_equals_staged": same_x,
           "streams_equal_host_coder": same_host,
           "corrupt_stream_ok": corrupt_ok,
           "no_host_wait_same_result": no_wait_same,
           "patches_per_slice": [len(p[0]) for p in enc["patches"]],
           "patch_cap_opened": opened, "dti2_file_round_trip": file_trip,
           "lanes": enc["lanes"], "bucket": enc["bucket"],
           "stream_bytes": [len(b) for b in enc["istreams"]],
           "bpp": bpp, "classic_bpp": staged["bpp"], "psnr_db": psnr,
           "encode_ms_per_image": enc_med, "decode_ms_per_image": dec_med,
           "encode_ms_runs": enc_runs, "decode_ms_runs": dec_runs,
           "host_coder_encode_ms_per_image": host_med,
           "staged_encode_ms_per_image": staged["encode_ms_per_image"],
           "per_slice_decode_ms_per_image": staged["decode_ms_per_image"],
           "split_encode_ms_per_image": certified["encode_ms_per_image"],
           "shipped_decode_ms_per_image":
               certified["shipped_decode_ms_per_image"],
           "pipeline_ms_per_image": pipe_ms,
           "pipeline_8_batches_ms_per_image": pipe8_ms,
           "pipeline_profiles": profiles,
           "launches_compress": enc_counts,
           "launches_decompress": dec_counts}
    print("interleaved: " + json.dumps(res), flush=True)
    print(f"interleaved: encode {enc_med:.2f} ms per image (staged "
          f"{staged['encode_ms_per_image']:.2f}, split "
          f"{certified['encode_ms_per_image']:.2f}), decode {dec_med:.2f} "
          f"(per-slice {staged['decode_ms_per_image']:.2f}, shipped-index "
          f"{certified['shipped_decode_ms_per_image']:.2f}), pipeline "
          f"{pipe_ms:.2f} ms per image over 3 batches, {pipe8_ms:.2f} over "
          f"8; bpp {bpp:.4f} (classic "
          f"{staged['bpp']:.4f})", flush=True)
    if not ok:
        fail("interleaved: decode checksum ok is false")
    if not same_x:
        fail("interleaved: x_hat differs from the staged part's decode")
    if not same_host:
        fail("interleaved: compress_device and compress_interleaved differ")
    if corrupt_ok:
        fail("interleaved: a corrupt stream decoded with ok true")
    if not no_wait_same:
        fail("interleaved: the run without host waits gave another result")
    if file_trip is False:
        fail("interleaved: DTI2 file round trip")
    if profiles != ["interleaved"] * 3 or not pipe_ok:
        fail(f"interleaved: serving loop: profiles {profiles}, results "
             f"equal to the sequential decode: {pipe_ok}")
    check_counts("compress_device", enc_counts, want_enc)
    check_counts("decompress_interleaved", dec_counts, want_dec)
    return res


def slice_phase() -> dict:
    import torch
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.codec import DCAECodec

    imgs = synthetic_kodak(BATCH)
    out = {}
    no_lanes = {"rans_lanes_encode": 0, "rans_lanes_decode": 0}
    want = {"wmsa_block": 15, "conv_glu": 17, "wmsa_attention": 0,
            "conv2d_nhwc": CONV2D_PASS, **no_lanes}
    t0 = time.perf_counter()
    codec = DCAECodec(DCAEConfig(), dtype=torch.bfloat16, seed=0)
    codec.update()
    print(f"slice: codec built + tables baked in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    staged = run_staged(codec, imgs, "slice", want)
    out["certified"] = run_certified(codec, imgs, staged, want)
    out["interleaved"] = run_interleaved(codec, imgs, staged,
                                         out["certified"])
    codec.close()
    del codec

    # the same weights (seed) with LN1, wmsa_attention and the residual
    # as separate steps: the rounding differs, so RD is close, not bitwise
    codec = DCAECodec(DCAEConfig(fused_attention_block=False),
                      dtype=torch.bfloat16, seed=0)
    codec.update()
    attn = run_staged(codec, imgs, "attention-only",
                      {"wmsa_block": 0, "conv_glu": 17, "wmsa_attention": 15,
                       "conv2d_nhwc": CONV2D_PASS, **no_lanes})
    codec.close()
    d_bpp = abs(attn["bpp"] - staged["bpp"]) / staged["bpp"]
    d_psnr = abs(attn["psnr_db"] - staged["psnr_db"])
    print(f"attention-only vs default: bpp {attn['bpp']:.5f} vs "
          f"{staged['bpp']:.5f} ({100 * d_bpp:.3f}%, max 1%), PSNR "
          f"{attn['psnr_db']:.4f} vs {staged['psnr_db']:.4f} dB "
          f"({d_psnr:.4f} dB, max 0.1)", flush=True)
    if d_bpp > 0.01 or d_psnr > 0.1:
        fail("attention-only RD is not within 1% bpp / 0.1 dB of default")
    for res in (staged, attn):
        del res["strings"], res["x_hat"]
    out["staged"] = staged
    out["attention_only"] = attn
    return out


def _strings(enc: dict) -> dict:
    return {"strings": enc["strings"], "shape": enc["shape"]}


def print_device_profile(prof, label: str, wall: float, what: str) -> float:
    """Device time of a profiled window by kernel kind (utils/profiling.py:
    op_type), the share of the wall time the device was busy, and the
    longest kernels. Returns the busy ms."""
    from torch.autograd import DeviceType
    from dcae_tpu_torch.utils.profiling import op_type

    dev = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                            getattr(e, "self_cuda_time_total", 0))
    # device-side events only: a CPU op's "self device time" repeats the
    # time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev(e) > 0]
    busy_ms = sum(dev(e) for e in events) / 1e3
    groups: dict = {}
    for e in events:
        g = op_type(e.key)
        groups[g] = groups.get(g, 0.0) + dev(e) / 1e3
    print(f"profile {label}: {what}: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / (wall * 1e3):.1f}%)",
          flush=True)
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"profile {label} group {g}: {ms:.2f} ms", flush=True)
    # the 15 longest, and every kernel of the hand-written sources
    ranked = sorted(events, key=dev, reverse=True)
    for e in ranked[:15] + [e for e in ranked[15:]
                            if "conv_glu" in e.key or "rans_lanes" in e.key
                            or "wmsa_" in e.key]:
        print(f"profile {label} kernel {dev(e) / 1e3:9.3f} ms "
              f"x{e.count:4d}  {e.key[:90]}", flush=True)
    return busy_ms


# bench_torch.py's defaults: the batch, and the batches of a serving round
BENCH_BATCH, BENCH_PIPE_BATCHES = 8, 6


def profile_serving_rounds() -> None:
    """The device's busy share in the bench's serving rounds, in
    bench_torch.py's configuration (bf16 DCAEConfig(), seeded weights, the
    certified encoder, 6 copies of a batch of 8 x 768x512 a round): each
    loop warmed by one round, 3 rounds unprofiled (their median wall),
    then one round under torch.profiler. The busy share is printed
    against the profiled round's wall and against the unprofiled
    median."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.codec import DCAECodec

    codec = DCAECodec(DCAEConfig(compute_dtype="bfloat16"), seed=0)
    codec.update(force=True)
    imgs = synthetic_kodak(BENCH_BATCH)
    if not codec.self_check(imgs[:1]):
        fail("profile serving: self_check did not certify an encoder")
    stream = [imgs] * BENCH_PIPE_BATCHES
    n_img = BENCH_BATCH * BENCH_PIPE_BATCHES
    loops = {"serving interleaved": codec.encdec_pipeline_interleaved,
             "serving classic": codec.encdec_pipeline}
    for label, loop in loops.items():
        def one_round(loop=loop):
            t0 = time.perf_counter()
            outs = loop(stream)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, outs

        one_round()                                      # warm-up
        walls = [one_round()[0] for _ in range(3)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, outs = one_round()
        # the interleaved loop tags a batch it had to code classic
        n_classic = sum(o.get("profile") == "classic" for o in outs)
        if not all(bool(o.get("ok", True)) for o in outs):
            fail(f"profile {label}: a lanes checksum failed")
        busy = print_device_profile(
            prof, label, wall, f"one round of {BENCH_PIPE_BATCHES} batches "
            f"of {BENCH_BATCH} x 768x512 ({n_classic} coded classic by the "
            "interleaved loop)")
        med = float(np.median(walls))
        print(f"profile {label}: unprofiled rounds "
              f"{[round(w * 1e3, 1) for w in walls]} ms, median "
              f"{med * 1e3:.1f} ms = {med * 1e3 / n_img:.2f} ms an image, "
              f"{n_img / med:.4f} img/s; device busy {busy / n_img:.2f} ms "
              f"an image, {100 * busy / (med * 1e3):.1f}% of the unprofiled "
              "median", flush=True)
    codec.close()
    del codec
    torch.cuda.empty_cache()


def profile_train_step() -> None:
    """Where one warm full-width training step (f32, batch 8 of 256x256)
    spends device time, and how long the device waits for the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.train.state import (create_train_state,
                                            make_optimizer)
    from dcae_tpu_torch.train.step import make_train_step

    dev = torch.device("cuda")
    torch.backends.cudnn.deterministic = False
    model = seeded_model(DCAEConfig(), dev)
    batch = torch.from_numpy(train_batch()).to(dev)
    tx = make_optimizer(1e-4, 1e-3, 1.0)
    state = create_train_state(
        model, tx, torch.Generator(device=dev).manual_seed(1))
    step = make_train_step(model, tx, LMBDA, "mse")
    timed_steps(step, state, batch, 3)                   # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print_device_profile(prof, "train step", wall,
                         f"one step of {TRAIN_BATCH} x 256x256 in f32")
    free = timed_steps(step, state, batch, 3)
    print(f"profile train step: unprofiled steps {free} ms", flush=True)


def interleaved_memory(codec, encode, decode) -> None:
    """The interleaved pair's peak device memory, and the bytes of the lane
    coders' tables the codec holds for it beside those of the slot and
    enc_sf tables (build_slot_tables, paired, and build_enc_tables) that
    the codec held on the device before the row tables."""
    import torch
    from dcae_tpu_torch.entropy import device_decode as dd

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    decode(encode())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    (offs, table), (_, _, maxpos, _) = codec._lane_luts()
    tables = sum(t.numel() * t.element_size() for t in (offs, table, maxpos))
    g = codec._require_tables().gaussian
    cdfs = (g.quantized_cdf, g.cdf_length, g.offset)
    earlier = sum(a.nbytes for a in (*dd.build_slot_tables(*cdfs, paired=True),
                                     *dd.build_enc_tables(*cdfs)[:3]))
    print(f"interleaved pair: peak device memory {peak} B ({held} B held "
          f"before it); the lane tables on the device {tables} B, where "
          f"the slot and enc_sf tables held {earlier} B", flush=True)


def profile_phase() -> None:
    """Where one compress + decompress of the slice spends device time:
    torch.profiler over a warm run, kernels summed by name, and the share
    of the wall time the device was busy. Three pairs on the same codec:
    the staged encoder with the per-slice decoder, the one-fetch encoder
    (compress_with_indexes) with the shipped-index decoder, and the
    interleaved profile (compress_device, decompress_interleaved), whose
    peak device memory follows."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.codec import DCAECodec

    codec = DCAECodec(DCAEConfig(), dtype=torch.bfloat16, seed=0)
    codec.update()
    imgs = synthetic_kodak(BATCH)
    pairs = {
        "staged + per-slice": (
            lambda: codec.compress(imgs, mode="staged"),
            lambda enc: codec.decompress(**_strings(enc))),
        "with-indexes + shipped-index": (
            lambda: codec.compress_with_indexes(imgs),
            lambda enc: codec.decompress(**_strings(enc),
                                         indexes=enc["indexes"])),
        "compress_device + decompress_interleaved": (
            lambda: codec.compress_device(imgs),
            lambda enc: codec.decompress_interleaved(enc)),
    }
    # the patch budget by the slice phase's rule
    open_patch_cap(codec, codec._input(imgs), "profile")
    for label, (encode, decode) in pairs.items():
        decode(encode())                                 # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            enc = encode()
            torch.cuda.synchronize()
            t_enc = time.perf_counter() - t0
            decode(enc)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print_device_profile(
            prof, label, wall, f"compress+decompress of {BATCH} images "
            f"(compress {t_enc * 1e3:.1f} ms)")
    interleaved_memory(codec, *pairs[
        "compress_device + decompress_interleaved"])
    codec.close()
    del codec
    torch.cuda.empty_cache()
    profile_serving_rounds()
    profile_train_step()


def bands_phase(gen) -> None:
    """The bf16 stage-3 conv_glu call under three band sizes (4, 2 and 1
    bands at this shape), each against the plain version, and the host time
    to enqueue a call at the shipped band size."""
    import torch
    from dcae_tpu_torch.ops.kernels import conv_glu as cg

    label, H, W, C, hidden, dtype, _ = CONV_GLU_CASES[0]
    x, p = conv_glu_inputs(H, W, C, hidden, getattr(torch, dtype), gen)
    want = cg.conv_glu_ref(x, *p)
    shipped = cg.BAND_BYTES
    for mib in (12, 24, 48):
        cg.BAND_BYTES = mib << 20
        n = len(cg.band_plan(BATCH, H, W, hidden))
        err = rel_err(cg.conv_glu(x, *p), want)
        runs = [time_ms(lambda: cg.conv_glu(x, *p), iters=20)
                for _ in range(3)]
        print(f"bands {label}: {mib} MiB a band, {n} bands: rel err "
              f"{err:.3e}, ms {runs}", flush=True)
        if err > TOL[dtype]:
            fail(f"conv_glu in bands of {mib} MiB disagrees")
    cg.BAND_BYTES = shipped
    # 20 calls fit the launch queue, 200 fill it: then the host waits
    for calls in (20, 200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            cg.conv_glu(x, *p)
        enqueue = (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) / calls
        print(f"bands {label}: {calls} calls: host enqueue "
              f"{enqueue * 1e6:.1f} us a call, {total * 1e6:.1f} us a call "
              f"with the device drained", flush=True)


# --------------------------------------------------------------- train --

LMBDA = 0.0483
NO_LANES = {"rans_lanes_encode": 0, "rans_lanes_decode": 0}


def train_batch(n: int = TRAIN_BATCH, size: int = 256, seed: int = 100):
    """n random size x size crops of n synthetic images, f32 NHWC in
    [0, 1], by the trainer's own crop function."""
    from dcae_tpu_torch.data.datasets import random_crop

    imgs = synthetic_kodak(n, seed=seed).astype(np.float32) / 255.0
    rng = np.random.default_rng(seed)
    return np.stack([random_crop(img, size, rng) for img in imgs])


def seeded_model(cfg, device):
    import torch
    from dcae_tpu_torch.models.dcae import DCAE

    model = DCAE(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.to(device)


def zero_gradient_names(model) -> list:
    """Names of the parameters whose gradient is missing, not finite or
    all zero. The dictionary attention's key bias adds the same number to
    every score of a query, which softmax ignores: its true gradient is 0
    and what it holds is rounding noise, so it is not asked to be
    nonzero."""
    import torch

    bad = []
    for name, p in model.named_parameters():
        g = p.grad
        if g is None or not bool(torch.isfinite(g).all()):
            bad.append(name)
        elif float(g.abs().max()) == 0.0 and not name.endswith(".k.bias"):
            bad.append(name)
    return bad


def eval_loss(model, batch) -> float:
    """The noise-free objective on `batch`: eval-mode RD loss + aux."""
    import torch
    from dcae_tpu_torch.train.step import make_eval_step

    with torch.no_grad():
        return float(make_eval_step(model, LMBDA)(batch)["loss"]
                     + model.aux_loss())


def check_finite(metrics: dict, state) -> None:
    values = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in values.values()):
        fail(f"train: a loss is not finite at step {state.step}: {values}")


def timed_steps(step, state, batch, n: int) -> list:
    """Host ms of n steps, each drained; fails on a loss that is not
    finite."""
    import torch

    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        check_finite(metrics, state)
    return out


def split_steps(model, tx, state, batch, n: int) -> dict:
    """n steps taken apart by CUDA events: forward (loss_fn), backward,
    optimizer (apply_updates), and inside the backward the three kernels'
    recompute backwards (events around every recompute_backward call).
    Mean ms a step of each."""
    import torch
    from dcae_tpu_torch.ops.kernels import conv_glu as cg
    from dcae_tpu_torch.ops.kernels import wmsa_attention as wa
    from dcae_tpu_torch.ops.kernels import wmsa_block as wm
    from dcae_tpu_torch.train.state import apply_updates
    from dcae_tpu_torch.train.step import make_loss_fn

    loss_fn = make_loss_fn(model, LMBDA)
    event = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    spans = {"wmsa_block": [], "wmsa_attention": [], "conv_glu": []}
    real = wm.recompute_backward

    def timed(name):
        def wrapper(*a, **k):
            start, end = event(), event()
            start.record()
            out = real(*a, **k)
            end.record()
            spans[name].append((start, end))
            return out
        return wrapper

    marks = []
    modules = {"wmsa_block": wm, "wmsa_attention": wa, "conv_glu": cg}
    for name, mod in modules.items():
        mod.recompute_backward = timed(name)
    try:
        for _ in range(n):
            e = [event() for _ in range(4)]
            for p in model.parameters():
                p.grad = None
            e[0].record()
            loss, _ = loss_fn(batch, state.generator)
            e[1].record()
            loss.backward()
            e[2].record()
            apply_updates(state, tx)
            e[3].record()
            marks.append(e)
    finally:
        for mod in modules.values():
            mod.recompute_backward = real
    torch.cuda.synchronize()
    mean = lambda pairs: sum(a.elapsed_time(b) for a, b in pairs) / n  # noqa
    res = {"forward_ms": mean([(e[0], e[1]) for e in marks]),
           "backward_ms": mean([(e[1], e[2]) for e in marks]),
           "optimizer_ms": mean([(e[2], e[3]) for e in marks])}
    res["recompute_backward_ms"] = {k: mean(v) for k, v in spans.items()}
    res["recompute_backward_calls"] = {k: len(v) // n
                                       for k, v in spans.items()}
    res["recompute_share_of_backward"] = sum(
        res["recompute_backward_ms"].values()) / res["backward_ms"]
    return res


def full_width_steps() -> dict:
    """The trainer's functions on the full-width model."""
    import torch
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.train.state import (create_train_state,
                                            make_optimizer)
    from dcae_tpu_torch.train.step import make_loss_fn, make_train_step

    dev = torch.device("cuda")
    cfg = DCAEConfig()
    t0 = time.perf_counter()
    model = seeded_model(cfg, dev)
    batch = torch.from_numpy(train_batch()).to(dev)
    tx = make_optimizer(1e-4, 1e-3, 1.0)
    state = create_train_state(
        model, tx, torch.Generator(device=dev).manual_seed(1))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"train: {n_params / 1e6:.1f}M parameters, batch "
          f"{tuple(batch.shape)}, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    want = {"wmsa_block": 30, "conv_glu": 29, "wmsa_attention": 0,
            **NO_LANES}
    loss_before = eval_loss(model, batch)

    # the gradients of step 1, before any update
    (loss, _), counts, _ = counted(
        lambda: make_loss_fn(model, LMBDA)(batch, state.generator))
    loss.backward()
    torch.cuda.synchronize()
    check_counts("train forward", counts, want)
    bad = zero_gradient_names(model)
    if bad:
        fail(f"train: {len(bad)} parameters without a finite nonzero "
             f"gradient at step 1: {bad}")
    q = model.entropy_bottleneck.quantiles
    (q_aux,) = torch.autograd.grad(model.aux_loss(), [q])
    q_err = rel_err(q.grad, q_aux)
    in_main = any(p is q for p in state.main_params())
    in_aux = any(p is q for g in state.aux_opt.param_groups
                 for p in g["params"])
    print(f"train: every one of {len(list(model.parameters()))} parameter "
          f"tensors has a finite nonzero gradient at step 1; quantiles' "
          f"gradient vs the aux loss's alone: rel err {q_err:.1e}; in the "
          f"main Adam {in_main}, in the aux Adam {in_aux}", flush=True)
    if q_err > 1e-6 or in_main or not in_aux:
        fail("train: the quantiles get an RD gradient or sit in the wrong "
             "optimizer")
    del loss

    step = make_train_step(model, tx, LMBDA, "mse")
    q_before = q.detach().clone()
    (_, metrics), counts, _ = counted(lambda: step(state, batch))
    check_finite(metrics, state)
    check_counts("train step", counts, want)
    if torch.equal(q, q_before):
        fail("train: the quantiles did not move")
    timed_steps(step, state, batch, 2)                   # 3 warm in all
    torch.cuda.reset_peak_memory_stats()
    runs = timed_steps(step, state, batch, 5)
    peak = torch.cuda.max_memory_allocated()
    split = split_steps(model, tx, state, batch, 3)
    # what full-f32 products cost: the same steps with TF32 allowed in
    # cuBLAS and cuDNN (the hand kernels do not read these flags)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_runs = timed_steps(step, state, batch, 4)[1:]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    reg = make_train_step(model, tx, LMBDA, "mse", precision_reg=0.001)
    (_, reg_metrics), reg_counts, _ = counted(lambda: reg(state, batch))
    check_counts("train step with precision_reg", reg_counts,
                 {"wmsa_block": 60, "conv_glu": 63, "wmsa_attention": 0,
                  **NO_LANES})
    check_finite(reg_metrics, state)
    p_loss = float(reg_metrics["precision_loss"])
    if not p_loss > 0:
        fail(f"train: precision_loss {p_loss}")
    reg_runs = timed_steps(reg, state, batch, 2)
    loss_after = eval_loss(model, batch)
    med = float(np.median(runs))
    res = {"step_ms_median": med, "step_ms_runs": runs,
           "images_per_s": TRAIN_BATCH / med * 1e3,
           "peak_memory_bytes": peak, **split,
           "tf32_allowed_step_ms_runs": tf32_runs,
           "precision_reg_step_ms_runs": reg_runs,
           "precision_loss": p_loss, "steps": state.step,
           "loss_before": loss_before, "loss_after": loss_after,
           "launches_step": counts, "launches_precision_step": reg_counts}
    print("train: " + json.dumps(res), flush=True)
    print(f"train: step {med:.1f} ms median of 5 (min {min(runs):.1f}, max "
          f"{max(runs):.1f}), {res['images_per_s']:.2f} images/s, peak "
          f"{peak / 2 ** 30:.2f} GiB; forward {split['forward_ms']:.1f} / "
          f"backward {split['backward_ms']:.1f} / optimizer "
          f"{split['optimizer_ms']:.1f} ms; recompute backwards "
          f"{100 * split['recompute_share_of_backward']:.1f}% of the "
          f"backward; with TF32 allowed {float(np.median(tf32_runs)):.1f} "
          f"ms; with precision_reg {min(reg_runs):.1f} ms; loss "
          f"{loss_before:.2f} -> {loss_after:.2f} after {state.step} steps",
          flush=True)
    if not (np.isfinite(loss_after) and loss_after < loss_before):
        fail(f"train: the loss did not fall: {loss_before} -> {loss_after}")
    del model, state, step, reg

    # the attention-only configuration: wmsa_attention's Function
    torch.cuda.empty_cache()
    cfg = DCAEConfig(fused_attention_block=False)
    model = seeded_model(cfg, dev)
    state = create_train_state(
        model, tx, torch.Generator(device=dev).manual_seed(1))
    step = make_train_step(model, tx, LMBDA, "mse")
    (_, metrics), attn_counts, _ = counted(lambda: step(state, batch))
    check_finite(metrics, state)
    check_counts("attention-only train step", attn_counts,
                 {"wmsa_block": 0, "conv_glu": 29, "wmsa_attention": 30,
                  **NO_LANES})
    bad = zero_gradient_names(model)
    if bad:
        fail(f"train: attention-only: parameters without a finite nonzero "
             f"gradient: {bad}")
    res["attention_only_step_ms"] = timed_steps(step, state, batch, 2)
    res["launches_attention_only_step"] = attn_counts
    print(f"train: attention-only step {res['attention_only_step_ms']} ms, "
          f"launches {attn_counts}", flush=True)
    return res


def tiny_step_card_vs_cpu() -> dict:
    """One training step of the tiny window-8 model on the card against the
    same step on the CPU (the plain versions): same seeded weights, same
    batch and, since the two devices' generators draw different numbers,
    the same noise (noise_quantize replaced, for this check, by one that
    adds a seeded array made on the host). Every window-attention launch of
    the card step is also held against its plain version on its own inputs
    (TOL). Bars (`tiny_step_passes`): loss within 1e-5 relative; the
    parameters after the step within 2.1 learning rates everywhere (Adam's
    first step moves a weight by at most one) and within 0.05 of one for
    99%; the zero-gradient key biases within 1e-5 of the key weight's
    gradient; the gradients within TINY_GRAD_P90 / TINY_GRAD_MAX. The same
    bars read three CPU steps whose window outputs carry seeded uniform
    noise of e times their max: e = the kernel's largest forward error in
    this step (reported), e = TOL (must pass) and e = 10 TOL (the control:
    must fail the gradient bars)."""
    import torch
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.entropy import ops
    from dcae_tpu_torch.ops.kernels import wmsa_attention as wa
    from dcae_tpu_torch.ops.kernels import wmsa_block as wm
    from dcae_tpu_torch.train.state import (create_train_state,
                                            make_optimizer)
    from dcae_tpu_torch.train.step import make_train_step

    cfg = DCAEConfig.tiny(**TINY_W8)
    batch = train_batch(2, 128, seed=3)
    lr = 1e-4
    tx = make_optimizer(lr, 1e-3, 1.0)

    def step(dev):
        model = seeded_model(cfg, dev)
        state = create_train_state(model, tx, torch.Generator(device=dev))
        _, metrics = make_train_step(model, tx, LMBDA)(
            state, torch.from_numpy(batch).to(dev))
        return ({k: float(v) for k, v in metrics.items()},
                {n: p.grad.cpu() for n, p in model.named_parameters()},
                {n: p.detach().cpu() for n, p in model.named_parameters()})

    refs = {wm: wm.wmsa_block_ref, wa: wa.wmsa_attention_ref}
    launches = {wm: wm.launch, wa: wa.launch}
    fwd_err = []

    def recorded(mod):
        def launch(what, x, params, *, heads, shifted):
            out = launches[mod](what, x, params, heads=heads, shifted=shifted)
            with torch.no_grad():
                fwd_err.append(rel_err(out, refs[mod](
                    x, *params, heads=heads, shifted=shifted)))
            return out
        return launch

    def noisy(mod, eps):
        calls = [0]

        def ref(x, *params, heads, shifted):
            out = refs[mod](x, *params, heads=heads, shifted=shifted)
            calls[0] += 1
            u = torch.rand(out.shape, generator=torch.Generator()
                           .manual_seed(calls[0])) * 2 - 1
            return out + (eps * out.detach().abs().max() * u).detach()
        return ref

    def cpu_step_with_noise(eps):
        wm.wmsa_block_ref, wa.wmsa_attention_ref = noisy(wm, eps), \
            noisy(wa, eps)
        try:
            return step("cpu")
        finally:
            wm.wmsa_block_ref, wa.wmsa_attention_ref = refs[wm], refs[wa]

    real, ops.noise_quantize = ops.noise_quantize, fixed_noise
    try:
        m_cpu, g_cpu, p_cpu = step("cpu")
        wm.launch, wa.launch = recorded(wm), recorded(wa)
        try:
            card = step("cuda")
        finally:
            wm.launch, wa.launch = launches[wm], launches[wa]
        if not fwd_err:
            fail("train: the tiny card step launched no window kernel")
        eps_kernel = max(fwd_err)
        runs = {"kernel": card,
                "witness_at_kernel_error": cpu_step_with_noise(eps_kernel)}
        runs.update((k, cpu_step_with_noise(e))
                    for k, e in TINY_NOISE.items())
    finally:
        ops.noise_quantize = real

    res = {k: compare_steps((m_cpu, g_cpu, p_cpu), r, lr)
           for k, r in runs.items()}
    res["kernel"]["forward_rel_err"] = eps_kernel
    res["kernel"]["window_launches"] = len(fwd_err)
    print("train tiny card vs CPU: " + json.dumps(res), flush=True)
    if eps_kernel > TOL["float32"]:
        fail(f"train: a window kernel launch of the tiny step is "
             f"{eps_kernel:.3e} from its plain version")
    if not tiny_step_passes(res["kernel"]):
        fail("train: the tiny step on the card differs from the CPU's")
    if not tiny_step_passes(res["witness"]):
        fail("train: the tiny step's bars fail a CPU step whose window "
             "outputs are off by the forward's own bar")
    control = res["control"]
    if control["grad_p90"] <= TINY_GRAD_P90 and \
            control["grad_rel_err"] <= TINY_GRAD_MAX:
        fail("train: the tiny step's gradient bars pass the control, a "
             "forward 10x over its bar")
    return res


def fixed_noise(x, generator):
    """noise_quantize's stand-in for card-vs-CPU steps: one seeded
    U(-0.5, 0.5) array a shape, made on the host."""
    import torch

    seed = int(np.prod(x.shape)) * 7 + x.dim()
    noise = torch.rand(x.shape, generator=torch.Generator()
                       .manual_seed(seed)) - 0.5
    return x + noise.to(x.device)


def compare_steps(ref: tuple, got: tuple, lr: float) -> dict:
    """A step's (metrics, gradients, parameters after) against a reference
    step's, in the terms tiny_step_passes reads."""
    import torch

    m_ref, g_ref, p_ref = ref
    m, g, p = got
    errs, key_bias_ok = {}, True
    for n in g_ref:
        if n.endswith(".k.bias"):       # true gradient 0: noise on both
            scale = float(g_ref[n[:-4] + "weight"].abs().max())
            key_bias_ok &= float(g[n].abs().max()) <= 1e-5 * scale
            continue
        errs[n] = rel_err(g[n], g_ref[n])
    worst = max(errs, key=errs.get)
    diff = torch.cat([(p[n] - p_ref[n]).abs().flatten() for n in p_ref])
    return {"loss_rel_err": max(abs(m[k] - m_ref[k]) / abs(m_ref[k])
                                for k in m_ref),
            "grad_rel_err": errs[worst], "grad_worst": worst,
            "grad_p90": float(np.quantile(list(errs.values()), 0.9)),
            "key_bias_ok": bool(key_bias_ok),
            "param_max_diff_in_lr": float(diff.max()) / lr,
            "param_p99_diff_in_lr": float(torch.quantile(diff, 0.99))
            / lr}


def tiny_step_passes(r: dict) -> bool:
    return (r["loss_rel_err"] <= 1e-5 and r["param_max_diff_in_lr"] <= 2.1
            and r["param_p99_diff_in_lr"] <= 0.05 and r["key_bias_ok"]
            and r["grad_p90"] <= TINY_GRAD_P90
            and r["grad_rel_err"] <= TINY_GRAD_MAX)


def tiny_run_training() -> dict:
    """One tiny-config run_training epoch on PNGs written here, on the
    card, with a real-codec validation; then a second epoch resumed from
    the first one's checkpoint."""
    import dataclasses

    import torch
    from PIL import Image
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.train.loop import TrainOptions, run_training
    from dcae_tpu_torch.utils.checkpoint import load_params_only

    cfg = DCAEConfig.tiny(**TINY_W8)
    imgs = synthetic_kodak(10, 192, 256, seed=11)
    with tempfile.TemporaryDirectory(prefix="dcae_smoke_") as tmp:
        for split, part in (("train", imgs[:8]), ("test", imgs[8:])):
            os.makedirs(os.path.join(tmp, split))
            for i, img in enumerate(part):
                Image.fromarray(img).save(
                    os.path.join(tmp, split, f"{i}.png"))
        save = os.path.join(tmp, "ck")
        opts = TrainOptions(dataset=tmp, epochs=1, batch_size=4,
                            test_batch_size=2, patch_size=128, lmbda=LMBDA,
                            save_path=save, val_real_every=1,
                            val_real_images=2, log_every=1, num_workers=2)
        _, counts, _ = counted(lambda: run_training(opts, cfg=cfg))
        latest = os.path.join(save, "checkpoint_latest.ckpt")
        saved = load_params_only(latest)
        state = run_training(dataclasses.replace(
            opts, epochs=2, checkpoint=latest), cfg=cfg)
        with open(os.path.join(save, "train.jsonl")) as f:
            records = [json.loads(line) for line in f]
    moved = not torch.equal(
        saved["g_a.0.conv.weight"],
        state.model.state_dict()["g_a.0.conv.weight"].cpu())
    spaces = sorted({r["ns"] for r in records})
    res = {"steps": state.step, "log_namespaces": spaces,
           "resumed_and_moved": moved, "launches_first_epoch": counts}
    print("train tiny run_training: " + json.dumps(res), flush=True)
    if state.step != 4 or not moved or \
            not {"train", "val", "val_real"} <= set(spaces) or \
            not all(np.isfinite(v) for r in records for k, v in r.items()
                    if k not in ("ns",)):
        fail("train: the tiny run_training epochs")
    if counts["wmsa_block"] == 0 or counts["conv_glu"] != 0:
        # the tiny widths route no GLU to the kernel; every block is one
        fail(f"train: tiny run_training launches {counts}")
    return res


def train_phase() -> dict:
    import torch

    # the codec phases made cuDNN deterministic; training runs without
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = False
    try:
        res = full_width_steps()
        torch.cuda.empty_cache()
        res["tiny_card_vs_cpu"] = tiny_step_card_vs_cpu()
        res["tiny_run_training"] = tiny_run_training()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = before
    return res


# --------------------------------------------------------------- split --

def param_bytes(module) -> int:
    return sum(p.numel() * p.element_size() for p in module.parameters())


def split_codec_part(params: dict, imgs: np.ndarray) -> dict:
    """make_split_pair on the full-size bf16 codec against the joint codec
    of the same weights: streams, exact decode, x_hat, what each half holds
    on the card, launches and ms per image; the halves' device parts under
    the sync-debug guard."""
    import torch
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.codec import DCAECodec
    from dcae_tpu_torch.models.split import (SplitCompressor,
                                             SplitDecompressor)

    cfg, bf16 = DCAEConfig(), torch.bfloat16
    B = imgs.shape[0]
    want = {"wmsa_block": 15, "conv_glu": 17, "wmsa_attention": 0,
            **NO_LANES}
    joint = DCAECodec(cfg, params=params, dtype=bf16)
    joint.update()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    enc = SplitCompressor(cfg, params, dtype=bf16)
    torch.cuda.synchronize()
    m1 = torch.cuda.memory_allocated()
    dec = SplitDecompressor(cfg, params, enc.tables, dtype=bf16)
    torch.cuda.synchronize()
    m2 = torch.cuda.memory_allocated()
    e, d = enc.codec, dec.codec
    held = {"joint": param_bytes(joint.model), "encoder": param_bytes(e.model),
            "decoder": param_bytes(d.model),
            **{k: param_bytes(getattr(joint.model, k))
               for k in ("g_a", "h_a", "g_s")}}
    keys_ok = (not any(k.startswith("g_s.") for k in e.model.state_dict())
               and not any(k.startswith(("g_a.", "h_a."))
                           for k in d.model.state_dict()))
    refused = False
    try:
        e.decompress([[b""], [b""]], (1, 1))
    except RuntimeError:
        refused = True

    st = joint.compress(imgs, mode="staged")
    jd = joint.decompress(**_strings(st))
    enc.compress(imgs, mode="staged")                       # warm-up
    dec.decompress(**_strings(st))
    enc_rec, dec_rec = [], []
    out, enc_counts, enc_ms = counted(
        lambda: enc.compress(imgs, mode="staged", record=enc_rec))
    got, dec_counts, dec_ms = counted(
        lambda: dec.decompress(**_strings(out), record=dec_rec))
    res = {
        "streams_equal_joint": out["strings"] == st["strings"],
        "exact_decode": exact(enc_rec, dec_rec, cfg.num_slices),
        "x_hat_bitwise_joint": bool(torch.equal(got["x_hat"],
                                                jd["x_hat"])),
        "param_bytes": held,
        "allocated_bytes": {"encoder": m1 - m0, "decoder": m2 - m1},
        "encoder_share": held["encoder"] / held["joint"],
        "decoder_share": held["decoder"] / held["joint"],
        "state_dict_keys_ok": keys_ok, "missing_half_raises": refused,
        "launches_encoder": enc_counts, "launches_decoder": dec_counts}
    res["encode_ms_per_image"], _ = median_ms(
        lambda: enc.compress(imgs, mode="staged"), enc_ms, B)
    res["decode_ms_per_image"], _ = median_ms(
        lambda: dec.decompress(**_strings(out)), dec_ms, B)
    t0 = time.perf_counter()
    joint.compress(imgs, mode="staged")
    torch.cuda.synchronize()
    res["joint_encode_ms_per_image"], _ = median_ms(
        lambda: joint.compress(imgs, mode="staged"),
        (time.perf_counter() - t0) * 1e3, B)
    t0 = time.perf_counter()
    joint.decompress(**_strings(st))
    torch.cuda.synchronize()
    res["joint_decode_ms_per_image"], _ = median_ms(
        lambda: joint.decompress(**_strings(st)),
        (time.perf_counter() - t0) * 1e3, B)

    # the halves' device parts never make the host wait
    x_dev = e._input(imgs)
    arrays = no_host_wait(lambda: e._encode_arrays(x_dev, "split"))
    z_hat = (arrays["z_symbols"].float()
             + d.model.eb_medians().reshape(1, 1, 1, -1))
    sym = torch.cat(list(arrays["y_symbols"]), dim=-1)
    x_all = no_host_wait(lambda: d.model.decode_all(z_hat, sym))
    res["device_parts_sync_free"] = True
    res["decode_all_bitwise_joint"] = bool(torch.equal(x_all, jd["x_hat"]))
    print("split halves: " + json.dumps(res), flush=True)
    if not (res["streams_equal_joint"] and res["exact_decode"]
            and res["x_hat_bitwise_joint"] and keys_ok and refused):
        fail("split: the halves disagree with the joint codec")
    # the shared modules (dictionary attention, slice nets, hyper
    # synthesis) are most of the model: a half is the joint model less
    # the other half's transforms, and what building it allocated on the
    # card exceeds its parameters by less than half of those transforms
    if not (held["encoder"] == held["joint"] - held["g_s"]
            and held["decoder"] == held["joint"] - held["g_a"]
            - held["h_a"]
            and m1 - m0 - held["encoder"] < held["g_s"] / 2
            and m2 - m1 - held["decoder"] < (held["g_a"] + held["h_a"]) / 2):
        fail("split: a half holds more than its own modules")
    check_counts("split encoder half", enc_counts, want)
    check_counts("split decoder half", dec_counts, want)
    for c in (joint, e, d):
        c.close()
    return res


def latent_part(params: dict, imgs: np.ndarray) -> dict:
    """DLT1 round trip of the bf16 codec's latent in each dtype on the card:
    PSNR of each x_hat against the f32 hand-off's."""
    import torch
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.codec import DCAECodec
    from dcae_tpu_torch.runtime import container

    codec = DCAECodec(DCAEConfig(), params=params, dtype=torch.bfloat16)
    B, H, W, _ = imgs.shape
    y = codec.compress_latent(imgs)
    ref = codec.decompress_latent(y)["x_hat"].float()
    res = {}
    for dtype in ("float32", "float16", "bfloat16", "int8"):
        blob = container.pack_latent(y, (H, W), dtype)
        back, _, size = container.unpack_latent(blob, codec.cfg.pad_multiple)
        x_hat = codec.decompress_latent(back)["x_hat"].float()
        mse = float(((x_hat - ref) ** 2).mean())
        res[dtype] = {"bytes": len(blob), "size_ok": size == (H, W),
                      "psnr_vs_f32_db": 10 * np.log10(1 / max(mse, 1e-20)),
                      "finite": bool(torch.isfinite(x_hat).all())}
    print("split latent: " + json.dumps(res), flush=True)
    if not res["float32"]["psnr_vs_f32_db"] >= 200 or not all(
            r["size_ok"] and r["finite"] for r in res.values()):
        fail("split: a DLT1 round trip")
    codec.close()
    return res


def many_part(params: dict) -> dict:
    """compress_many / decompress_many over 3 batches of 2 against
    per-batch calls; encdec_pipeline's ms per image beside sequential
    compress + decompress (recorded, not held to anything)."""
    import torch
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.codec import DCAECodec

    codec = DCAECodec(DCAEConfig(), params=params, dtype=torch.bfloat16)
    codec.update()
    codec.encode_mode = "split"
    batches = list(synthetic_kodak(6, seed=21).reshape(3, 2, 512, 768, 3))
    n = 6
    seq = [codec.compress(b, mode="split") for b in batches]
    seq_dec = [codec.decompress(**_strings(e)) for e in seq]
    many = codec.compress_many(batches, mode="split", pipeline=True)
    dec_many = codec.decompress_many([(e["strings"], e["shape"])
                                      for e in many])
    pipe = codec.encdec_pipeline(batches)
    ok = (all(a["strings"] == b["strings"] for a, b in zip(many, seq))
          and all(torch.equal(a["x_hat"], b["x_hat"])
                  for a, b in zip(dec_many, seq_dec)))

    def sequential():
        for b in batches:
            codec.decompress(**_strings(codec.compress(b)))

    t = {}
    for name, fn in (("sequential", sequential),
                     ("compress_per_batch", lambda: [
                         codec.compress(b) for b in batches]),
                     ("encdec_pipeline", lambda: codec.encdec_pipeline(
                         batches)),
                     ("compress_many_pipelined", lambda: codec.compress_many(
                         batches, pipeline=True))):
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3 / n)
        t[name + "_ms_per_image"] = float(np.median(runs))
        t[name + "_ms_runs"] = runs
    pipe_ok = all(p["strings"] == s["strings"]
                  and torch.equal(p["x_hat"], d["x_hat"])
                  for p, s, d in zip(pipe, seq, seq_dec))
    res = {"many_equal_per_batch": ok,
           "pipeline_equal_sequential": pipe_ok, **t}
    print("split many / pipeline: " + json.dumps(res), flush=True)
    if not (ok and pipe_ok):
        fail("split: compress_many / decompress_many / encdec_pipeline "
             "differ from per-batch calls")
    codec.close()
    return res


def cross_device_part(params: dict) -> dict:
    """CrossDeviceCodec on one 256x256 image, both ways (encoder half on
    the card, decoder half on the CPU, and the reverse), f32: with shipped
    indexes the decode must be exact; without, whether it is exact (and
    the first slice that differs) is recorded."""
    import torch
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.codec import DCAECodec
    from dcae_tpu_torch.models.split import (compress_params,
                                             decompress_params)
    from dcae_tpu_torch.tools.eval import CrossDeviceCodec

    cfg = DCAEConfig()
    img = synthetic_kodak(1, 256, 256, seed=5)
    halves = {dev: (DCAECodec(cfg, params=compress_params(params),
                              device=dev),
                    DCAECodec(cfg, params=decompress_params(params),
                              device=dev)) for dev in ("cuda", "cpu")}
    res = {}
    for enc_dev, dec_dev in (("cuda", "cpu"), ("cpu", "cuda")):
        cross = CrossDeviceCodec(halves[enc_dev][0], halves[dec_dev][1],
                                 ship_indexes=True)
        cross.update()
        enc_rec = []
        t0 = time.perf_counter()
        out = cross.enc.compress_with_indexes(img, record=enc_rec)
        enc_s = time.perf_counter() - t0
        shipped, plain = [], []
        cross.dec.decompress(**_strings(out), indexes=out["indexes"],
                             record=shipped)
        cross.dec.decompress(**_strings(out), record=plain)
        differs = [i for i, ((ei, es), (di, ds)) in
                   enumerate(zip(enc_rec, plain))
                   if not (np.array_equal(ei.astype(np.int32),
                                          di.astype(np.int32))
                           and np.array_equal(es, ds))]
        key = f"encoder_{enc_dev}_decoder_{dec_dev}"
        res[key] = {
            "shipped_exact": exact(
                [(i.astype(np.int32), s) for i, s in enc_rec],
                [(i.astype(np.int32), s) for i, s in shipped],
                cfg.num_slices),
            "unshipped_exact": not differs and len(plain) == len(enc_rec),
            "unshipped_first_slice_differing": differs[0] if differs
            else None,
            "unshipped_index_mismatches_first": int(
                (enc_rec[differs[0]][0].astype(np.int32)
                 != plain[differs[0]][0].astype(np.int32)).sum())
            if differs else 0,
            "encode_s": enc_s}
    print("split cross-device: " + json.dumps(res), flush=True)
    if not all(r["shipped_exact"] for r in res.values()):
        fail("split: a cross-device decode with shipped indexes is not "
             "exact")
    for e, d in halves.values():
        e.close()
        d.close()
    return res


def autoencoder_part(imgs: np.ndarray) -> dict:
    """The full-width SimpleAutoencoder (f32) on the card: joint, and split
    as g_a -> float16 latent -> g_s, launches and ms of each stage."""
    import torch
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.autoencoder import SimpleAutoencoder
    from dcae_tpu_torch.tools.eval_autoencoder import ship

    model = SimpleAutoencoder(DCAEConfig())
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    x = torch.from_numpy(imgs).cuda().float() / 255.0
    with torch.no_grad():
        model(x)                                            # warm-up
        out, joint_counts, joint_ms = counted(lambda: model(x))
        _, enc_counts, enc_ms = counted(lambda: model.compress(x))
        y = model.compress(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y16 = ship(y, "float16", torch.device("cuda"))
        torch.cuda.synchronize()
        xfer_ms = (time.perf_counter() - t0) * 1e3
        x_hat, dec_counts, dec_ms = counted(lambda: model.decompress(y16))
        ref = torch.clamp(out["x_hat"], 0, 1)
        mse = float(((x_hat - ref) ** 2).mean())
    res = {"launches_joint": joint_counts, "launches_encode": enc_counts,
           "launches_decode": dec_counts, "joint_ms": joint_ms,
           "encode_ms": enc_ms, "transfer_ms": xfer_ms, "decode_ms": dec_ms,
           "fp16_vs_f32_psnr_db": 10 * np.log10(1 / max(mse, 1e-20)),
           "finite": bool(torch.isfinite(x_hat).all())}
    print("split autoencoder: " + json.dumps(res), flush=True)
    half = {"wmsa_block": 15, "conv_glu": 12, "wmsa_attention": 0,
            **NO_LANES}
    check_counts("autoencoder joint", joint_counts,
                 {**half, "wmsa_block": 30, "conv_glu": 24})
    check_counts("autoencoder encode", enc_counts, half)
    check_counts("autoencoder decode", dec_counts, half)
    if not res["finite"]:
        fail("split: the autoencoder's output is not finite")
    return res


def split_training_part(joint_train: dict | None) -> dict:
    """make_split_train_step on the full-width f32 model, both halves on
    cuda:0: step-1 gradients, 3 warm + 5 timed steps, peak memory, the loss
    before and after, launches; then the tiny hybrid step (encoder half on
    the CPU, decoder half on the card) against the CPU-only split step."""
    import torch
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.train.split_step import (create_split_train_state,
                                                 make_split_train_step)
    from dcae_tpu_torch.train.state import make_optimizer

    dev = torch.device("cuda", 0)
    model = seeded_model(DCAEConfig(), dev)
    batch = torch.from_numpy(train_batch()).to(dev)
    tx = make_optimizer(1e-4, 1e-3, 1.0)
    state = create_split_train_state(model, tx, dev, dev, seed=1)
    step = make_split_train_step(model, tx, LMBDA, "mse", dev, dev)
    loss_before = eval_loss(model, batch)
    (_, metrics), counts, _ = counted(lambda: step(state, batch))
    check_finite(metrics, state)
    bad = zero_gradient_names(model)
    timed_steps(step, state, batch, 2)                   # 3 warm in all
    torch.cuda.reset_peak_memory_stats()
    runs = timed_steps(step, state, batch, 5)
    peak = torch.cuda.max_memory_allocated()
    loss_after = eval_loss(model, batch)
    med = float(np.median(runs))
    res = {"step_ms_median": med, "step_ms_runs": runs,
           "peak_memory_bytes": peak, "loss_before": loss_before,
           "loss_after": loss_after, "launches_step": counts,
           "steps": state.step, "zero_or_missing_gradients": bad}
    if joint_train is not None:
        res["joint_step_ms_median"] = joint_train["step_ms_median"]
        res["joint_peak_memory_bytes"] = joint_train["peak_memory_bytes"]
    print("split training: " + json.dumps(res), flush=True)
    if bad:
        fail(f"split training: parameters without a finite nonzero "
             f"gradient at step 1: {bad}")
    check_counts("split training step", counts,
                 {"wmsa_block": 30, "conv_glu": 29, "wmsa_attention": 0,
                  **NO_LANES})
    if not (np.isfinite(loss_after) and loss_after < loss_before):
        fail(f"split training: the loss did not fall: {loss_before} -> "
             f"{loss_after}")
    del model, state, step, batch
    torch.cuda.empty_cache()
    res["tiny_hybrid_vs_cpu"] = tiny_hybrid_step()
    return res


def tiny_hybrid_step() -> dict:
    """One TINY_W8 split step with the encoder half on the CPU and the
    decoder half on the card against the same split step all on the CPU
    (fixed noise, as in tiny_step_card_vs_cpu), held to the same bars."""
    import torch
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.entropy import ops
    from dcae_tpu_torch.train.split_step import (create_split_train_state,
                                                 make_split_train_step)
    from dcae_tpu_torch.train.state import make_optimizer

    cfg = DCAEConfig.tiny(**TINY_W8)
    batch = torch.from_numpy(train_batch(2, 128, seed=3))
    lr = 1e-4
    tx = make_optimizer(lr, 1e-3, 1.0)

    def step(enc_dev, dec_dev):
        model = seeded_model(cfg, "cpu")
        state = create_split_train_state(model, tx, enc_dev, dec_dev)
        _, metrics = make_split_train_step(model, tx, LMBDA, "mse", enc_dev,
                                           dec_dev)(state, batch)
        return ({k: float(v) for k, v in metrics.items()},
                {n: p.grad.cpu() for n, p in model.named_parameters()},
                {n: p.detach().cpu() for n, p in model.named_parameters()})

    real, ops.noise_quantize = ops.noise_quantize, fixed_noise
    try:
        ref = step("cpu", "cpu")
        got, counts, _ = counted(lambda: step("cpu", "cuda"))
    finally:
        ops.noise_quantize = real
    res = compare_steps(ref, got, lr)
    res["launches"] = counts
    print("split tiny hybrid vs CPU: " + json.dumps(res), flush=True)
    if counts["wmsa_block"] == 0:
        fail("split: the hybrid step's decoder half launched no kernel")
    if not tiny_step_passes(res):
        fail("split: the hybrid tiny step differs from the CPU split step")
    return res


CLI = [sys.executable, "-m"]


def cli_part(params: dict) -> dict:
    """The port's CLIs through subprocesses on 2 PNGs, full width on the
    card (seeded random weights, f32): compress_and_decompress in the
    classic, interleaved and latent formats (the three compresses run at
    once, then one decompress of all the files) and eval_autoencoder
    --split. Each .bin must be the bytes this process's codec of the same
    weights writes, and each decoded PNG the PNG of its decode."""
    import torch
    from PIL import Image
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.codec import DCAECodec
    from dcae_tpu_torch.data.datasets import load_image
    from dcae_tpu_torch.entropy.rans import EscapeError
    from dcae_tpu_torch.ops.layers import pad_spatial
    from dcae_tpu_torch.runtime import container
    from dcae_tpu_torch.tools.compress_and_decompress import decode_blob

    imgs = synthetic_kodak(2, 256, 384, seed=9)
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root}
    res = {}
    with tempfile.TemporaryDirectory(prefix="dcae_smoke_") as tmp:
        src = os.path.join(tmp, "png")
        os.makedirs(src)
        for i, img in enumerate(imgs):
            Image.fromarray(img).save(os.path.join(src, f"im{i}.png"))
        mod = "dcae_tpu_torch.tools."
        fmts = {"classic": [], "interleaved": ["--interleaved"],
                "latent": ["--latent", "float16"]}
        t0 = time.perf_counter()
        procs = {f: subprocess.Popen(
            CLI + [mod + "compress_and_decompress", "--mode", "compress",
                   "--data", src, "--save_path", os.path.join(tmp, f)]
            + extra, env=env, cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for f, extra in fmts.items()}
        procs["eval_autoencoder"] = subprocess.Popen(
            CLI + [mod + "eval_autoencoder", "--data", src, "--split",
                   "--latent_dtype", "float16"], env=env, cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs = {k: p.communicate(timeout=300)[0] for k, p in procs.items()}
        codes = {k: p.returncode for k, p in procs.items()}
        both = os.path.join(tmp, "all")
        os.makedirs(both)
        for f in fmts:
            for name in sorted(os.listdir(os.path.join(tmp, f, "bin"))):
                os.replace(os.path.join(tmp, f, "bin", name),
                           os.path.join(both, f"{f}_{name}"))
        dec = subprocess.run(
            CLI + [mod + "compress_and_decompress", "--mode", "decompress",
                   "--data", both, "--save_path", os.path.join(tmp, "out")],
            env=env, cwd=root, capture_output=True, text=True, timeout=300)
        codes["decompress"] = dec.returncode
        res["wall_s"] = time.perf_counter() - t0
        res["exit_codes"] = codes
        if any(codes.values()):
            for k, log in {**logs, "decompress": dec.stdout + dec.stderr
                           }.items():
                print(f"--- {k}\n{log[-3000:]}", flush=True)
            fail(f"split: a CLI failed: {codes}")
        res["eval_autoencoder_size_analysis"] = \
            "SIZE ANALYSIS" in logs["eval_autoencoder"]

        codec = DCAECodec(DCAEConfig(), seed=0)
        codec.update()
        same_bytes, same_png = {}, {}
        for f in fmts:
            for i, img in enumerate(imgs):
                # read as the CLI reads it: the host's division by 255 and
                # the card's (a multiply by the reciprocal) differ in ulps
                x, _ = pad_spatial(codec._input(load_image(os.path.join(
                    src, f"im{i}.png"))[None]), codec.cfg.pad_multiple)
                size = img.shape[:2]
                with open(os.path.join(both, f"{f}_im{i}.bin"), "rb") as fh:
                    raw = fh.read()
                if f == "interleaved":
                    try:
                        mine = container.pack_bin_interleaved(
                            codec.compress_device(x), size)
                    except EscapeError:      # the CLI's fallback too
                        f_enc = codec.compress(x)
                        mine = container.pack_bin(f_enc["strings"], size)
                elif f == "classic":
                    enc = codec.compress(x)
                    mine = container.pack_bin(enc["strings"], size)
                else:
                    mine = container.pack_latent(codec.compress_latent(x),
                                                 size, "float16")
                png = np.asarray(Image.open(os.path.join(
                    tmp, "out", "png", f"{f}_im{i}.png")))
                x_hat = decode_blob(codec, raw)[0].float().cpu().numpy()
                own = np.clip(x_hat * 255.0 + 0.5, 0, 255).astype(np.uint8)
                same_bytes[f"{f}_im{i}"] = raw == mine
                same_png[f"{f}_im{i}"] = bool(np.array_equal(png, own))
        codec.close()
    res["bin_bytes_equal_in_process"] = same_bytes
    res["png_equal_in_process_decode"] = same_png
    print("split CLIs: " + json.dumps(res), flush=True)
    if not (all(same_bytes.values()) and all(same_png.values())
            and res["eval_autoencoder_size_analysis"]):
        fail("split: a CLI's file differs from this process's codec")
    return res


def split_phase(joint_train: dict | None = None) -> dict:
    """Split deployment on the card: halves, cross-device codec, DLT1,
    compress_many / decompress_many / encdec_pipeline, the autoencoder,
    split training and the CLIs."""
    import torch
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.dcae import DCAE

    t0 = time.perf_counter()
    init = DCAE(DCAEConfig())
    init.reset_parameters(torch.Generator().manual_seed(0))
    params = init.state_dict()
    del init
    imgs = synthetic_kodak(BATCH)
    out = {"halves": split_codec_part(params, imgs)}
    out["latent"] = latent_part(params, imgs)
    out["many"] = many_part(params)
    torch.cuda.empty_cache()
    out["cross_device"] = cross_device_part(params)
    out["autoencoder"] = autoencoder_part(imgs)
    torch.cuda.empty_cache()
    # the codec parts made cuDNN deterministic; training runs without
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = False
    try:
        out["training"] = split_training_part(joint_train)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = before
    torch.cuda.empty_cache()
    out["clis"] = cli_part(params)
    out["seconds"] = time.perf_counter() - t0
    print(f"split: {out['seconds']:.1f} s", flush=True)
    return out


def spread_text(runs: list) -> str:
    return (f"{float(np.median(runs)):.2f} ({min(runs):.2f}-"
            f"{max(runs):.2f})")


def host_waits(fn) -> dict:
    """fn() under torch.cuda.set_sync_debug_mode("warn"): every operation
    that made a thread of this process wait for the device, counted by the
    line of Python that issued it."""
    import warnings

    import torch

    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    where: dict = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(before)
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename)}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    return where


def loops_part(codec, batches: list) -> dict:
    """The two serving loops against sequential calls on the same batches
    (2 x 768x512 each), in turns inside this process: sequential, loop,
    loop, sequential, three rounds, for 3 and for 8 batches. Each loop's
    results must be bitwise the sequential ones (and tagged interleaved);
    its ms per image are printed beside theirs with the spread, and the
    host waits of one loop are counted by line."""
    import torch

    def seq_interleaved(bs):
        return [codec.decompress_interleaved(codec.compress_device(b))
                for b in bs]

    def seq_classic(bs):
        out = []
        for b in bs:
            e = codec.compress(b)
            out.append({**e, **codec.decompress(**_strings(e))})
        return out

    loops = {
        "interleaved": (seq_interleaved,
                        lambda bs: codec.encdec_pipeline_interleaved(bs)),
        "classic": (seq_classic, lambda bs: codec.encdec_pipeline(bs)),
    }
    res: dict = {}
    for name, (seq, loop) in loops.items():
        ref = seq(batches)
        got = loop(batches)                      # warm-up and the check
        torch.cuda.synchronize()
        same = len(got) == len(ref) and all(
            torch.equal(g["x_hat"], r["x_hat"]) for g, r in zip(got, ref))
        if name == "classic":
            same = same and all(g["strings"] == r["strings"]
                                for g, r in zip(got, ref))
        else:
            same = same and all(bool(g["ok"]) for g in got)
            tags = [g["profile"] for g in got]
            if tags != ["interleaved"] * len(batches):
                fail(f"serve loops: {name}: profiles {tags}")
        if not same:
            fail(f"serve loops: {name}: results differ from sequential "
                 "calls")
        res[name] = {"bitwise_equal_sequential": same}
        for nb in (3, 8):
            bs = batches[:nb]
            runs = {"sequential": [], "loop": []}
            for _ in range(3):
                for kind in ("sequential", "loop", "loop", "sequential"):
                    fn = seq if kind == "sequential" else loop
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn(bs)
                    torch.cuda.synchronize()
                    runs[kind].append((time.perf_counter() - t0) * 1e3
                                      / (nb * BATCH))
            s_med = float(np.median(runs["sequential"]))
            l_med = float(np.median(runs["loop"]))
            res[name][f"{nb}_batches"] = {
                "sequential_ms_per_image": s_med, "loop_ms_per_image": l_med,
                "sequential_ms_runs": runs["sequential"],
                "loop_ms_runs": runs["loop"],
                "loop_within_sequential_spread":
                    l_med <= max(runs["sequential"])}
            print(f"serve loops: {name}, {nb} batches of {BATCH}: loop "
                  f"{spread_text(runs['loop'])} ms an image, sequential "
                  f"{spread_text(runs['sequential'])}", flush=True)
        res[name]["host_waits_loop_3"] = host_waits(lambda: loop(
            batches[:3]))
        print(f"serve loops: {name}: host waits over one loop of 3 "
              f"batches, by line: {res[name]['host_waits_loop_3']}",
              flush=True)
    return res


def loopback_part(codec, imgs: np.ndarray) -> dict:
    """A BitstreamServer on 127.0.0.1 decoding on arrival (tools/server.py's
    payload_decoder, its own codec on the card), fed by the port's client
    (tools/client.py: 4 classic .bin payloads) and by send_bytes (4 DTI2
    payloads of compress_device + pack_bin_interleaved), one payload in
    flight at a time. Every received file must be the bytes sent, every
    served x_hat bitwise the direct decode of the same payload, and each
    decode must launch 15 / 17 kernels (+ 5 lane decoders for DTI2); the
    receive-to-decoded ms an image are printed."""
    import threading

    import torch
    from PIL import Image
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.codec import DCAECodec
    from dcae_tpu_torch.ops.layers import crop_spatial, pad_spatial
    from dcae_tpu_torch.runtime import container
    from dcae_tpu_torch.runtime.service import BitstreamServer, send_bytes
    from dcae_tpu_torch.tools import client, server as server_tool

    # a server is its own deployment: its own codec (the same seeded
    # weights and the encoder's baked tables), built before start()
    scodec = DCAECodec(DCAEConfig(), dtype=torch.bfloat16, seed=0,
                       tables=codec.tables)
    scodec.patch_cap = codec.patch_cap
    served: dict = {}
    arrived: dict = {}
    done = threading.Event()

    def on_decoded(name, x_hat):
        torch.cuda.synchronize()
        served[name] = (x_hat, (time.perf_counter() - arrived[name]) * 1e3)
        done.set()

    res: dict = {"classic": [], "dti2": []}
    with tempfile.TemporaryDirectory(prefix="dcae_serve_") as tmp:
        recv = os.path.join(tmp, "recv")
        decode = server_tool.payload_decoder(scodec, recv, on_decoded)

        def on_payload(name, data):
            arrived[name] = time.perf_counter()
            try:
                decode(name, data)
            except BaseException:
                done.set()             # the server prints it and goes on
                raise

        srv = BitstreamServer(0, recv, on_payload)
        srv.start(background=True)
        try:
            paths = []
            for i, img in enumerate(imgs):
                paths.append(os.path.join(tmp, f"img{i}.png"))
                Image.fromarray(img).save(paths[-1])
            payloads = []
            for path in paths:
                payloads.append(("classic",) + client.encode_image(codec,
                                                                   path))
            for i, img in enumerate(imgs):
                x = codec._input(img[None])
                padded, _ = pad_spatial(x, codec.cfg.pad_multiple)
                blob = container.pack_bin_interleaved(
                    codec.compress_device(padded), x.shape[1:3])
                payloads.append(("dti2", f"dti{i}.bin", blob))
            # the first of each kind warms the server's codec up
            warm = [payloads[0], payloads[len(imgs)]]
            for kind, name, blob in warm + payloads:
                done.clear()
                for w in wrappers().values():
                    w.launches = 0
                send_bytes(name, blob, "127.0.0.1", srv.bound_port)
                if not done.wait(120):
                    fail(f"serve loopback: no decode of {name}")
                counts = {k: w.launches for k, w in wrappers().items()}
                if name not in served:
                    fail(f"serve loopback: {name} did not decode")
                res[kind].append({"name": name, "bytes": len(blob),
                                  "launches": counts,
                                  "receive_to_decoded_ms":
                                      served[name][1]})
            srv.stop()
            for kind, name, blob in payloads:
                with open(os.path.join(recv, f"received_{name}"),
                          "rb") as f:
                    if f.read() != blob:
                        fail(f"serve loopback: received_{name} differs "
                             "from the payload sent")
                cfg = scodec.cfg
                if kind == "classic":
                    strings, z_shape, padding, _ = container.unpack_bin(
                        blob, cfg.pad_multiple, cfg.z_downsample)
                    direct = scodec.decompress(strings, z_shape)
                else:
                    enc, padding, _ = container.unpack_bin_interleaved(
                        blob, cfg.pad_multiple, cfg.z_downsample)
                    direct = scodec.decompress_interleaved(enc)
                if not torch.equal(served[name][0],
                                   crop_spatial(direct["x_hat"], padding)):
                    fail(f"serve loopback: served {name} is not the direct "
                         "decode")
                if not os.path.exists(os.path.join(
                        recv, os.path.splitext(name)[0] + ".png")):
                    fail(f"serve loopback: no PNG of {name}")
        finally:
            srv.stop()
            scodec.close()
    lanes = {"classic": 0, "dti2": codec.cfg.num_slices}
    for kind, rows in res.items():
        rows[:] = rows[1:]                       # the warm-up payload
        for r in rows:
            check_counts(f"serve loopback {r['name']}", r["launches"],
                         {"wmsa_block": 15, "conv_glu": 17,
                          "wmsa_attention": 0, "rans_lanes_encode": 0,
                          "rans_lanes_decode": lanes[kind]})
    out = {"bitwise_equal_direct_decode": True, "payloads": res}
    for kind, rows in res.items():
        ms = [r["receive_to_decoded_ms"] for r in rows]
        out[f"{kind}_receive_to_decoded_ms_median"] = float(np.median(ms))
        print(f"serve loopback: {kind}: {len(rows)} payloads of "
              f"{[r['bytes'] for r in rows]} bytes, receive to decoded "
              f"{spread_text(ms)} ms an image", flush=True)
    return out


def dp_part(joint_train: dict | None) -> dict:
    """A process group of world size 1 on NCCL: make_mesh gives dp = 1; a
    full-width f32 shard_train_step step (8 x 256x256, TF32 off) against
    the plain make_train_step step from the same weights and noise seed
    (parameters bitwise, or within 1e-6 of each tensor's largest); the dp
    step's ms; tools/eval_sharded.main on 4 PNGs."""
    import contextlib
    import io
    import socket

    import torch
    import torch.distributed as dist
    from PIL import Image
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.parallel import mesh as pmesh, multihost
    from dcae_tpu_torch.tools import eval_sharded
    from dcae_tpu_torch.train.state import create_train_state, make_optimizer
    from dcae_tpu_torch.train.step import make_train_step

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dev = multihost.initialize(coordinator=f"127.0.0.1:{port}",
                               num_processes=1, process_id=0)
    res: dict = {}
    try:
        if dist.get_backend() != "nccl":
            fail(f"serve dp: backend {dist.get_backend()}, not nccl")
        mesh = pmesh.make_mesh()
        res["mesh"] = mesh.shape
        if mesh.shape != {"dp": 1, "sp": 1} or mesh.device != dev:
            fail(f"serve dp: mesh {mesh.shape} on {mesh.device}")
        batch = torch.from_numpy(train_batch()).to(dev)
        tx = make_optimizer(1e-4, 1e-3, 1.0)
        states, steps = [], []
        for sharded in (False, True):
            model = seeded_model(DCAEConfig(), dev)
            state = create_train_state(
                model, tx, torch.Generator(device=dev).manual_seed(1))
            step = make_train_step(model, tx, LMBDA, "mse")
            states.append(state)
            steps.append(pmesh.shard_train_step(step, mesh)
                         if sharded else step)
        (_, m_plain), _, _ = counted(lambda: steps[0](states[0], batch))
        (_, m_dp), counts, _ = counted(lambda: steps[1](states[1], batch))
        check_finite(m_dp, states[1])
        worst, bitwise = 0.0, True
        for a, b in zip(states[1].model.parameters(),
                        states[0].model.parameters()):
            d = float((a - b).detach().abs().max())
            bitwise = bitwise and d == 0.0
            worst = max(worst, d / max(float(b.detach().abs().max()),
                                       1e-30))
        loss_d = abs(float(m_dp["loss"]) - float(m_plain["loss"]))
        res.update({"params_bitwise_equal": bitwise,
                    "params_max_rel_diff": worst,
                    "loss_abs_diff": loss_d, "launches_step": counts})
        runs = timed_steps(steps[1], states[1], batch, 7)[2:]
        res["dp_step_ms_median"] = float(np.median(runs))
        res["dp_step_ms_runs"] = runs
        if joint_train is not None:
            res["joint_step_ms_median"] = joint_train["step_ms_median"]
        del states, steps, model, state, batch
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="dcae_dp_") as tmp:
            for i, img in enumerate(synthetic_kodak(4, 256, 256, seed=41)):
                Image.fromarray(img).save(os.path.join(tmp, f"im{i}.png"))
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                ev = eval_sharded.main(["--data", tmp, "--batch-size", "2"])
        print(text.getvalue(), end="", flush=True)
        res["eval_sharded"] = ev
        res["eval_sharded_mesh_line"] = \
            "mesh: dp=1 sp=1 over 1/1 devices" in text.getvalue()
    finally:
        dist.destroy_process_group()
    print("serve dp: " + json.dumps(res), flush=True)
    if worst > 1e-6 or loss_d > 1e-6 * abs(float(m_plain["loss"])):
        fail(f"serve dp: the dp = 1 step differs from the plain step "
             f"(parameters {worst:.3e}, loss {loss_d:.3e})")
    check_counts("serve dp step", counts,
                 {"wmsa_block": 30, "conv_glu": 29, **NO_LANES,
                  "wmsa_attention": 0})
    if not res["eval_sharded_mesh_line"] or ev["images"] != 4 or not all(
            np.isfinite(ev[k]) for k in ("loss", "bpp_loss", "psnr")):
        fail(f"serve dp: eval_sharded: {ev}")
    return res


def profile_debug_part(codec, imgs: np.ndarray) -> dict:
    """utils/profiling.report of g_a on the batch; a 256x256 staged encode
    of the full-width f32 model dumped by utils/debug.dump_codec_run on
    the card and on the CPU, and compare_dumps of the two (recorded)."""
    import torch
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.codec import DCAECodec
    from dcae_tpu_torch.utils import debug, profiling

    x = codec._input(imgs)
    with torch.no_grad():
        rep = profiling.report(codec.model.analysis, x, label="g_a")
    print(f"serve profiling: g_a of {BATCH} x 768x512 bf16: "
          f"{rep['median_ms']:.3f} ms, {rep['gflops']:.1f} GFLOP, "
          f"{rep['tflops_per_s']:.2f} TFLOP/s, ~{rep['hbm_gb_per_s']:.0f} "
          "GB/s (bytes estimated)", flush=True)
    one = synthetic_kodak(1, 256, 256, seed=51)
    out = {"g_a_report": rep}
    with tempfile.TemporaryDirectory(prefix="dcae_dump_") as root:
        for tag, device in (("card", "cuda"), ("cpu", "cpu")):
            c = DCAECodec(DCAEConfig(), seed=0, device=device)
            c.update()
            debug.dump_codec_run(c, one, root, tag)
            c.close()
        report = debug.compare_dumps(root, "card", "cpu")
    out["compare_dumps"] = report
    for name, e in report.items():
        print(f"serve debug: card vs cpu {name}: " + json.dumps(e),
              flush=True)
    if set(report) != {f"{n}.npy" for n in (
            "y", "z_symbols", "z_hat", "latent_scales", "latent_means",
            *(f"{k}_{i}" for k in ("mu", "indexes", "symbols")
              for i in range(5)))} | {"y_string.bin", "z_string.bin"}:
        fail(f"serve debug: dump names {sorted(report)}")
    torch.cuda.empty_cache()
    return out


def serve_phase(joint_train: dict | None = None) -> dict:
    """Serving and data-parallel deployment on the card: the serving
    loops against sequential calls, a loopback server decoding on arrival,
    dp over a one-rank NCCL group, profiling and the tensor dump."""
    import torch
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.codec import DCAECodec

    t0 = time.perf_counter()
    codec = DCAECodec(DCAEConfig(), dtype=torch.bfloat16, seed=0)
    codec.update()
    if not codec.self_check() or codec.encode_mode == "staged":
        fail("serve: self_check did not certify a one-fetch encoder mode")
    batches = list(synthetic_kodak(8 * BATCH, seed=21).reshape(
        8, BATCH, 512, 768, 3))
    open_patch_cap(codec, codec._input(batches[0]), "serve")
    out = {"loops": loops_part(codec, batches)}
    out["loopback"] = loopback_part(codec, synthetic_kodak(4, seed=31))
    out["profiling"] = profile_debug_part(codec, batches[0])
    codec.close()
    del codec
    torch.cuda.empty_cache()
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    try:
        out["dp"] = dp_part(joint_train)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = before
    out["seconds"] = time.perf_counter() - t0
    print(f"serve: {out['seconds']:.1f} s", flush=True)
    return out


# ------------------------------------------------------------------- sp --

SP = 2
LR = 1e-4
# the sp step against the one-card step (the dp card test's bars): every
# gradient within SP_GRAD_TOL of the largest gradient, 99% of the
# parameters within SP_PARAM_LR learning rates
SP_GRAD_TOL, SP_PARAM_LR = 1e-5, 1e-3
# the sp = 2 bf16 eval's y and g_s: within this many times one card's bf16
# distance from the f32 model (one card 1.47e-2 and 1.33e-2 of the largest,
# sp 1.36e-2 and 1.41e-2, NVIDIA H100 80GB HBM3, 700 W)
SP_BF16_VS_F32 = 1.25
SP_TIMEOUT_S = 300


def halo_check(gen) -> dict:
    """wmsa_block, wmsa_attention (W and SW) and conv_glu, f32 and bf16,
    on the first, an interior and the last band of a tensor of three
    sp = 2 stage-3 bands of the training step (16 rows each: 8 x 48 x 32 x
    256), each band extended by one window of rows on each side that has
    a neighbour (as run_bands gives them), cropped, against the same
    kernel's rows of the whole tensor. A window's arithmetic does not see
    its neighbours, so they should agree bitwise; held at TOL."""
    import torch
    from dcae_tpu_torch.ops.kernels.conv_glu import conv_glu
    from dcae_tpu_torch.ops.kernels.wmsa_attention import wmsa_attention
    from dcae_tpu_torch.ops.kernels.wmsa_block import wmsa_block

    H, W, C, heads, n, w = 48, 32, 256, 8, 16, 8
    cases = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        x, p = wmsa_inputs(H, W, C, heads, dt, gen, TRAIN_BATCH)
        xg, pg = conv_glu_inputs(H, W, C, 2 * C, dt, gen, TRAIN_BATCH)
        cases[f"conv_glu {dtype}"] = (dtype, xg, lambda t, pg=pg: conv_glu(
            t, *pg, apply_ln=True))
        for s in (False, True):
            tag = f"{'SW' if s else 'W'} {dtype}"
            cases[f"wmsa_block {tag}"] = (dtype, x, lambda t, s=s, p=p:
                                          wmsa_block(t, *p, heads=heads,
                                                     shifted=s))
            cases[f"wmsa_attention {tag}"] = (
                dtype, x, lambda t, s=s, p=p: wmsa_attention(
                    t, *p[3:], heads=heads, shifted=s))
    out = {}
    with torch.no_grad():
        for name, (dtype, t, fn) in cases.items():
            whole = fn(t)
            worst = 0.0
            for r0 in range(0, H, n):
                top = w if r0 else 0
                band = fn(t[:, r0 - top:min(H, r0 + n + w)].contiguous())
                worst = max(worst, float(
                    (band[:, top:top + n] - whole[:, r0:r0 + n]).abs().max()))
            out[name] = {"max_abs_diff": worst,
                         "rel": worst / float(whole.abs().max()),
                         "dtype": dtype}
    for name, r in out.items():
        print(f"sp halo check: {name} on first / interior / last bands "
              f"with their halos, cropped, against the whole: max |diff| "
              f"{r['max_abs_diff']:.3e} ({r['rel']:.3e} of the largest)",
              flush=True)
    bad = {k: r for k, r in out.items() if not r["rel"] <= TOL[r["dtype"]]}
    if bad:
        fail(f"sp halo check: {bad}")
    return out


def halo_rows(cfg, H: int) -> dict:
    """The Swin blocks' rows a rank of an sp = 2 step computes at each
    stage of g_a (g_s mirrors it) for an image height H: its own band and
    the one window of halo rows on its side that has a neighbour."""
    w = cfg.window_size
    out = {}
    for i in range(len(cfg.feature_dim)):
        own = H // 2 ** (i + 1) // SP
        out[f"stage{i + 1}"] = {"own_rows": own, "halo_rows": w,
                                "halo_share": w / own}
    return out


def gloo_probe_worker(rank: int, port: int) -> None:
    """One of the two ranks of the gloo probe, on card 0: each operation
    that the transports use, on card tensors, its values checked. Prints
    a line `probe <operation> <outcome>` an operation; point to point goes
    last, since a refusal there may leave the group unusable."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=30))
    dev = torch.device("cuda", 0)
    t = torch.full((4,), float(rank + 1), device=dev)

    def all_reduce():
        u = t.clone()
        dist.all_reduce(u)
        return u, torch.full_like(t, 3.0)

    def broadcast():
        u = t.clone()
        dist.broadcast(u, 0)
        return u, torch.full_like(t, 1.0)

    def all_gather():
        out = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(out, t)
        return torch.cat(out), torch.cat([torch.full_like(t, 1.0),
                                          torch.full_like(t, 2.0)])

    def send_recv():
        u = torch.empty_like(t)
        for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, t, 1 - rank),
                dist.P2POp(dist.irecv, u, 1 - rank)]):
            work.wait()
        return u, torch.full_like(t, float(2 - rank))

    try:
        for name, fn in (("all_reduce", all_reduce),
                         ("broadcast", broadcast),
                         ("all_gather", all_gather),
                         ("send_recv", send_recv)):
            try:
                got, want = fn()
                torch.cuda.synchronize()
                outcome = ("takes cuda tensors" if torch.equal(got, want)
                           else f"wrong values: {got.tolist()}")
            except RuntimeError as e:
                outcome = "refuses: " + str(e).strip().splitlines()[0][:160]
            print(f"probe {name} {outcome}", flush=True)
    finally:
        dist.destroy_process_group()


def forward_bytes(model, state, batch, step_context) -> int:
    """Device bytes the training forward holds for its backward (allocated
    after the loss, less before), inside step_context; then the backward,
    its gradients dropped."""
    import torch
    from dcae_tpu_torch.train.step import make_loss_fn

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with step_context():
        loss, _ = make_loss_fn(model, LMBDA)(batch, state.generator)
        held = torch.cuda.memory_allocated() - before
        loss.backward()
    for p in model.parameters():
        p.grad = None
    return held


def _param_digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _sp_body(rank: int, tmp: str) -> None:
    import torch
    import torch.distributed as dist
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.parallel import mesh as pmesh, spatial
    from dcae_tpu_torch.train.state import create_train_state, make_optimizer
    from dcae_tpu_torch.train.step import make_eval_step, make_train_step

    dev = torch.device("cuda", 0)
    mesh = pmesh.make_mesh(sp=SP, device=dev)
    if mesh.shape != {"dp": 1, "sp": SP} or mesh.sp_rank != rank:
        fail(f"sp: mesh {mesh.shape}, sp_rank {mesh.sp_rank}")
    res = {"mesh": mesh.shape, "transport": mesh.transport.name}
    cfg = DCAEConfig()
    batch = torch.from_numpy(train_batch()).to(dev)
    tx = make_optimizer(LR, 1e-3, 1.0)
    want = {"wmsa_block": 30, "conv_glu": 29, "wmsa_attention": 0,
            **NO_LANES}

    def fresh(c=cfg):
        model = seeded_model(c, dev)
        return model, create_train_state(
            model, tx, torch.Generator(device=dev).manual_seed(1))

    # the one-card step on rank 0 alone, from the same weights and noise
    if rank == 0:
        model, state = fresh()
        step = make_train_step(model, tx, LMBDA, "mse")
        (_, ref_m), ref_counts, _ = counted(lambda: step(state, batch))
        check_counts("sp: the one-card step", ref_counts, want)
        ref_grads = [p.grad.detach().to("cpu", copy=True)
                     for p in model.parameters()]
        ref_params = [p.detach().to("cpu", copy=True)
                      for p in model.parameters()]
        ref_m = {k: float(v) for k, v in ref_m.items()}
        torch.cuda.reset_peak_memory_stats()
        runs = timed_steps(step, state, batch, 4)[1:]
        res["one_card"] = {"step_ms_runs": runs,
                           "step_ms_median": float(np.median(runs)),
                           "peak_memory_bytes":
                           torch.cuda.max_memory_allocated(),
                           "forward_held_bytes": forward_bytes(
                               model, state, batch,
                               contextlib.nullcontext)}
        del model, state, step
        torch.cuda.empty_cache()
    dist.barrier()

    # the sp step: rank 0's rows [0, 128) and rank 1's [128, 256) of g_a
    # and g_s, the rest alike on both
    model, state = fresh()
    step = pmesh.shard_train_step(make_train_step(model, tx, LMBDA, "mse"),
                                  mesh)
    (_, m), counts, _ = counted(lambda: step(state, batch))
    check_finite(m, state)
    check_counts(f"sp step, rank {rank}", counts, want)
    m = {k: float(v) for k, v in m.items()}
    if rank == 0:
        g_scale = max(float(g.abs().max()) for g in ref_grads)
        g_err = max(float((p.grad.detach().cpu() - g).abs().max())
                    for p, g in zip(model.parameters(), ref_grads))
        d = torch.cat([(p.detach().cpu() - q).abs().ravel()
                       for p, q in zip(model.parameters(), ref_params)])
        res["against_one_card"] = {
            "grad_max_diff_of_largest": g_err / g_scale,
            "param_p99_lr": float(np.quantile(d.numpy(), 0.99)) / LR,
            "param_max_lr": float(d.max()) / LR,
            "loss": m["loss"], "one_card_loss": ref_m["loss"],
            "metrics_max_rel_diff": max(
                abs(m[k] - ref_m[k]) / max(abs(ref_m[k]), 1e-30)
                for k in ref_m)}
        del ref_grads, ref_params, d
    everyone = [None] * SP
    dist.all_gather_object(everyone, {
        "metrics": m, "params": _param_digest(model), "launches": counts})
    res["ranks_bitwise_alike"] = all(
        e["params"] == everyone[0]["params"] for e in everyone)
    res["rank_metrics_equal"] = all(
        e["metrics"] == everyone[0]["metrics"] for e in everyone)
    res["launches_step"] = [e["launches"] for e in everyone]
    torch.cuda.reset_peak_memory_stats()
    runs = timed_steps(step, state, batch, 4)[1:]
    mine = {"step_ms_runs": runs, "step_ms_median": float(np.median(runs)),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "forward_held_bytes": forward_bytes(
                model, state, batch, lambda: spatial.bands(mesh))}
    dist.all_gather_object(everyone, mine)
    res["sp_ranks"] = everyone
    del model, state, step
    torch.cuda.empty_cache()

    # shard_eval_step on 2 x 768x512 in the inference dtypes: bf16
    # transforms, f32 entropy side. A bf16 convolution rounds by its
    # shape's algorithm, so the sp y differs from one card's by bf16
    # rounding (~1e-2 of the largest, as far as either is from the f32
    # model's) and some symbols round the other way, which moves x_hat and
    # the likelihoods where they do (printed, not held). Held: y and g_s on
    # one y_hat within SP_BF16_VS_F32 times one card's distance from the
    # f32 model's; y no further from one card's in the rows next to the
    # band edge than in the others (a halo fault shows at the edge,
    # rounding everywhere); the bits and the metrics within the bf16 bar
    model = seeded_model(cfg, dev).set_transform_dtype(torch.bfloat16).eval()
    x = torch.from_numpy(synthetic_kodak(BATCH, seed=61)).to(dev).float() \
        / 255.0
    ev = make_eval_step(model, LMBDA)

    def bits(out, k):
        return float(-torch.log2(out["likelihoods"][k]).sum())

    with torch.no_grad():
        with spatial.bands(mesh):
            out_sp = model(x)
            x_same_sp = model.synthesis(out_sp["para"]["y_hat"])
        m_sp = pmesh.shard_eval_step(ev, mesh)(x)
        m_sp = {k: float(v) for k, v in m_sp.items()}
        if rank == 0:
            out_1 = model(x)
            x_same_1 = model.synthesis(out_sp["para"]["y_hat"])
            m_1 = {k: float(v) for k, v in ev(x).items()}
            sym = [torch.round(o["para"]["y"] - o["para"]["means"])
                   for o in (out_sp, out_1)]
            res["eval"] = {
                "y_rel": rel_err(out_sp["para"]["y"], out_1["para"]["y"]),
                "g_s_same_y_hat_rel": rel_err(x_same_sp, x_same_1),
                **{f"bits_{k}_rel": abs(bits(out_sp, k) - bits(out_1, k))
                   / bits(out_1, k) for k in ("y", "z")},
                "metrics_max_rel_diff": max(
                    abs(m_sp[k] - m_1[k]) / max(abs(m_1[k]), 1e-30)
                    for k in m_1),
                "y_symbols_differ_share": float(
                    (sym[0] != sym[1]).float().mean()),
                "x_hat_rel": rel_err(out_sp["x_hat"], out_1["x_hat"]),
                **{f"likelihoods_{k}_rel": rel_err(
                    out_sp["likelihoods"][k], out_1["likelihoods"][k])
                   for k in ("y", "z")},
                "metrics": m_sp, "one_card_metrics": m_1}
            # each bf16 result against the f32 model's on the same input
            ref = seeded_model(cfg, dev).eval()
            out_f = ref(x)
            x_same_f = ref.synthesis(out_sp["para"]["y_hat"])
            res["eval"]["against_f32"] = {
                "y_sp": rel_err(out_sp["para"]["y"], out_f["para"]["y"]),
                "y_one_card": rel_err(out_1["para"]["y"],
                                      out_f["para"]["y"]),
                "g_s_sp": rel_err(x_same_sp, x_same_f),
                "g_s_one_card": rel_err(x_same_1, x_same_f)}
            # where the sp and one-card y differ: the rows next to the band
            # edge, and the others
            dy = (out_sp["para"]["y"] - out_1["para"]["y"]).abs().amax(
                dim=(0, 2, 3))
            edge = dy.shape[0] // SP
            res["eval"]["y_max_diff_edge_rows"] = float(
                dy[edge - 2:edge + 2].max())
            res["eval"]["y_max_diff_other_rows"] = float(torch.cat(
                [dy[:edge - 2], dy[edge + 2:]]).max())
            del ref, out_f
    del model, out_sp, x
    torch.cuda.empty_cache()

    # the attention-only configuration: wmsa_attention on the bands
    model = seeded_model(DCAEConfig(fused_attention_block=False), dev).eval()

    def banded():
        with torch.no_grad(), spatial.bands(mesh):
            return model(batch)["x_hat"]

    x_sp, attn_counts, _ = counted(banded)
    check_counts(f"sp attention-only forward, rank {rank}", attn_counts,
                 {"wmsa_block": 0, "conv_glu": 29, "wmsa_attention": 30,
                  **NO_LANES})
    res["launches_attention_only_forward"] = attn_counts
    if rank == 0:
        with torch.no_grad():
            res["attention_only_x_hat_rel"] = rel_err(x_sp,
                                                      model(batch)["x_hat"])
        with open(os.path.join(tmp, "sp.json"), "w") as f:
            json.dump(res, f)
        a = res["against_one_card"]
        e = res["eval"]
        print("sp: " + json.dumps(res), flush=True)
        if not (a["grad_max_diff_of_largest"] <= SP_GRAD_TOL
                and a["param_p99_lr"] <= SP_PARAM_LR
                and a["metrics_max_rel_diff"] <= TOL["float32"]):
            fail(f"sp: the sp = 2 step against the one-card step: {a}")
        if not (res["ranks_bitwise_alike"] and res["rank_metrics_equal"]):
            fail("sp: the ranks differ after the step")
        f = e["against_f32"]
        if not (max(e["bits_y_rel"], e["bits_z_rel"],
                    e["metrics_max_rel_diff"]) <= TOL["bfloat16"]
                and f["y_sp"] <= SP_BF16_VS_F32 * f["y_one_card"]
                and f["g_s_sp"] <= SP_BF16_VS_F32 * f["g_s_one_card"]
                and e["y_max_diff_edge_rows"]
                <= e["y_max_diff_other_rows"]):
            fail(f"sp: the sp = 2 eval against one card: {e}")
        if not res["attention_only_x_hat_rel"] <= TOL["float32"]:
            fail(f"sp: attention-only x_hat {res['attention_only_x_hat_rel']}")
    dist.barrier()


def sp_worker(rank: int, port: int, tmp: str) -> None:
    """One of the SP ranks of the sp phase: gloo (NCCL refuses two ranks on
    one card), this process's tensors on card 0, the train phase's flags."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=SP, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        _sp_body(rank, tmp)
    finally:
        dist.destroy_process_group()


def gloo_probe(procs) -> dict:
    """The outcomes of the gloo probe's ranks (gloo_probe_worker): which
    operations gloo takes card tensors for on this machine. The
    host-staged transport passes all-reduce and all-gather to gloo as
    they are, so those must take them; the halo exchange (point to point)
    it stages through the host, whatever the outcome here."""
    try:
        texts = [p.communicate(timeout=SP_TIMEOUT_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        texts = ["(timed out)"] * len(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    found = [dict(line.split(" ", 2)[1:] for line in text.splitlines()
                  if line.startswith("probe ")) for text in texts]
    # an operation's outcome on each rank
    out = {name: [f.get(name, f"no answer (exit code {p.returncode})")
                  for f, p in zip(found, procs)]
           for name in ("all_reduce", "broadcast", "all_gather",
                        "send_recv")}
    print(f"sp: gloo with card tensors: {json.dumps(out)}", flush=True)
    for name in ("all_reduce", "all_gather"):
        if out[name] != ["takes cuda tensors"] * len(procs):
            fail(f"sp: gloo {name} on card tensors: {out[name]}; the "
                 f"host-staged transport passes it card tensors\n"
                 + "\n".join(texts))
    return out


def sp_phase() -> dict:
    """The spatial axis on the card: the halo check in this process, then
    SP ranks as processes of this script on the one card (sp_worker)."""
    import socket

    import torch
    from dcae_tpu_torch.config import DCAEConfig

    def free_port() -> int:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    t0 = time.perf_counter()
    # the gloo probe's two ranks start while the halo check runs here
    port = free_port()
    probe = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--gloo-probe",
         str(rank), str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        out = {"halo_check": halo_check(torch.Generator().manual_seed(7)),
               "halo_rows_256": halo_rows(DCAEConfig(), 256),
               "halo_rows_768x512": halo_rows(DCAEConfig(), 512)}
    except BaseException:
        for p in probe:
            p.kill()
            p.wait()
        raise
    torch.cuda.empty_cache()
    out["gloo_cuda_tensors"] = gloo_probe(probe)
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="dcae_sp_") as tmp:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sp-worker",
             str(rank), str(port), tmp], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for rank in range(SP)]
        try:
            texts = [p.communicate(timeout=SP_TIMEOUT_S)[0] for p in procs]
        except subprocess.TimeoutExpired:
            texts = ["(timed out)"] * SP
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, text in enumerate(texts):
            print(f"--- sp rank {rank}\n{text.strip()}", flush=True)
        if any(p.returncode for p in procs):
            fail(f"sp: rank exit codes {[p.returncode for p in procs]}")
        with open(os.path.join(tmp, "sp.json")) as f:
            out.update(json.load(f))
    out["seconds"] = time.perf_counter() - t0
    a, one = out["against_one_card"], out["one_card"]
    ms = " / ".join(f"{r['step_ms_median']:.1f}" for r in out["sp_ranks"])
    gib = " / ".join(f"{r['peak_memory_bytes'] / 2 ** 30:.2f}"
                     for r in out["sp_ranks"])
    print(f"sp: transport {out['transport']}; a step of 8 x 256x256 at sp = "
          f"{SP}: {ms} ms on the ranks (one card {one['step_ms_median']:.1f}"
          f"; the two ranks share one card), peak {gib} GiB a rank (one "
          f"card {one['peak_memory_bytes'] / 2 ** 30:.2f}); gradients "
          f"{a['grad_max_diff_of_largest']:.2e} of the largest, parameters "
          f"99% within {a['param_p99_lr']:.2e} lr (largest "
          f"{a['param_max_lr']:.3f} lr); launches a rank "
          f"{out['launches_step']}; {out['seconds']:.1f} s", flush=True)
    return out


# --------------------------------------------------------------- tools --

# the kernels each tool's run must launch (every other count must be 0)
TOOL_KERNELS = {
    "validate_training": ("wmsa_block", "conv_glu"),
    "rd_sweep_eval": ("wmsa_block", "conv_glu"),
    "lanes_ab": ("wmsa_block", "conv_glu", "rans_lanes_encode",
                 "rans_lanes_decode"),
    "profile_interleaved": ("wmsa_block", "conv_glu", "rans_lanes_encode",
                            "rans_lanes_decode"),
    "bench_wmsa": ("wmsa_attention",),
    "bench_link": (),
}


def tool_run(name: str, fn, label: str = "") -> tuple:
    """fn() (one tool's entry point) with the launch counters set to 0
    just before it and read just after; fails unless it launched the
    kernels of TOOL_KERNELS[name] and no other. Returns (result, counts,
    seconds)."""
    out, counts, ms = counted(fn)
    want = TOOL_KERNELS[name]
    wrong = {k: n for k, n in counts.items() if bool(n) != (k in want)}
    print(f"tools {name}{label}: {ms / 1e3:.1f} s, launches {counts}",
          flush=True)
    if wrong:
        fail(f"tools: {name}{label} launched {counts}; want launches of "
             f"{list(want)} only")
    return out, counts, ms / 1e3


def run_validation(data: str, save: str, epochs: int, n_train: int,
                   lmbda: float) -> dict:
    """validate_training --full through its CLI entry point on `data`
    (batch 8, 256x256 patches): its exit code, summary.json, and a strict
    load of the trained checkpoint into the full-width model."""
    import torch
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.dcae import DCAE
    from dcae_tpu_torch.tools import validate_training
    from dcae_tpu_torch.utils.checkpoint import load_params_only

    argv = ["--full", "--data", data, "--save_path", save, "--epochs",
            str(epochs), "--n-train", str(n_train), "--batch-size", "8",
            "--patch-size", "256", "--lmbda", str(lmbda)]
    rc, counts, sec = tool_run("validate_training",
                               lambda: validate_training.main(argv),
                               f" (lambda {lmbda})")
    with open(os.path.join(save, "summary.json")) as f:
        summary = json.load(f)
    ckpt = os.path.join(save, "checkpoint_latest.ckpt")
    DCAE(DCAEConfig()).load_state_dict(load_params_only(ckpt), strict=True)
    finite = all(np.isfinite(summary[k]) for k in (
        "loss_first", "loss_last", "bpp_first", "bpp_last",
        "real_bpp_untrained", "real_bpp_trained", "real_psnr_trained"))
    print(f"tools validate_training (lambda {lmbda}): VALIDATION "
          f"{'PASS' if rc == 0 else 'FAIL'}; " + json.dumps(summary),
          flush=True)
    if not finite:
        fail(f"validate_training (lambda {lmbda}): a summary value is not "
             "finite")
    torch.cuda.empty_cache()
    return {"pass": rc == 0, "summary": summary, "checkpoint": ckpt,
            "launches": counts, "seconds": sec}


def run_lanes_profile(ckpt, ks: str, rounds: int, batch: int,
                      stage: str) -> dict:
    """lanes_ab (every decode's checksum asserted by the tool) and
    profile_interleaved on ckpt (seeded weights when None): their tables,
    the profile's region budget, whose `other` must hold less than half the
    device time (the regions match the port's kernel names) and which must
    have seen the lane coders and the window kernel on the card."""
    from dcae_tpu_torch.tools import lanes_ab, profile_interleaved

    ck = ["--ckpt", ckpt or ""]
    lanes, lanes_counts, lanes_s = tool_run("lanes_ab", lambda: lanes_ab.main(
        ["--ks", ks, "--rounds", str(rounds), "--batch", str(batch)] + ck))
    prof, prof_counts, prof_s = tool_run(
        "profile_interleaved", lambda: profile_interleaved.main(
            ["--stage", stage, "--batch", str(batch)] + ck))
    budget = {}
    for st, s in prof.items():
        calls = s["n_iters"]
        regions = {k: v / calls for k, v in s["by_group"].items()}
        total = s["total_ms"] / calls
        other = regions.get("other", 0.0) / total
        budget[st] = {"device_ms_per_call": total, "regions_ms": regions,
                      "other_share": other}
        if not (other < 0.5 and regions.get("rans_lanes_kernel", 0) > 0
                and regions.get("wmsa_kernel", 0) > 0):
            fail(f"profile_interleaved {st}: regions {regions} of "
                 f"{total:.3f} ms (other must be < 50%, the lane coders and "
                 "the window kernel present)")
    return {"lanes_ab": {str(k): v for k, v in lanes.items()},
            "lanes_ab_launches": lanes_counts, "lanes_ab_s": lanes_s,
            "profile": budget, "profile_launches": prof_counts,
            "profile_s": prof_s}


def tools_phase() -> dict:
    """The six tools through their entry points, at reduced depth: the
    card run of each, its launches, its output checked."""
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.data.synthetic import make_dataset
    from dcae_tpu_torch.models.dcae import DCAE
    from dcae_tpu_torch.tools import bench_link, bench_wmsa, rd_sweep_eval
    from dcae_tpu_torch.utils.checkpoint import save_checkpoint

    import torch

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "synth")
        make_dataset(data, n_train=32)
        # 2 epochs of 4 steps: 8 full-width steps of 8 x 256x256
        out["validate_training"] = run_validation(
            data, os.path.join(tmp, "run"), 2, 32, 0.013)
        seeded = os.path.join(tmp, "seeded.ckpt")
        model = DCAE(DCAEConfig())
        model.reset_parameters(torch.Generator().manual_seed(0))
        save_checkpoint(seeded, model, 0, 0.0)
        del model
        sweep, counts, sec = tool_run(
            "rd_sweep_eval", lambda: rd_sweep_eval.main(
                ["--points", f"0.05:{seeded}",
                 f"0.013:{out['validate_training']['checkpoint']}",
                 "--data", data, "--images", "2"]))
        if len(sweep["points"]) != 2 or not all(
                np.isfinite(r["bpp"]) and r["bpp"] > 0
                and np.isfinite(r["psnr"]) for r in sweep["points"]):
            fail(f"rd_sweep_eval: points {sweep['points']}")
        out["rd_sweep_eval"] = {"points": sweep["points"],
                                "bd_rate_vs_anchor_pct":
                                sweep["bd_rate_vs_anchor_pct"],
                                "launches": counts, "seconds": sec}
    out.update(run_lanes_profile(None, "512,256", 1, BATCH, "decode"))
    for dt in ("bf16", "f32"):
        res, counts, sec = tool_run(
            "bench_wmsa", lambda dt=dt: bench_wmsa.main(
                ["--dtype", dt, "--reps", "3"]), f" {dt}")
        out[f"bench_wmsa_{dt}"] = {**res, "launches": counts,
                                   "seconds": sec}
    out["bench_link"], _, _ = tool_run("bench_link",
                                       lambda: bench_link.main(["3"]))
    out["seconds"] = time.perf_counter() - t_phase
    print(f"tools phase: {out['seconds']:.1f} s", flush=True)
    return out


# --------------------------------------------------------------- bench --

# launches of one compress + decompress of the default codec: the classic
# format, and the interleaved profile (a lane coder a slice each way)
BENCH_PAIR = {"wmsa_block": 30, "conv_glu": 34, "wmsa_attention": 0,
              "rans_lanes_encode": 0, "rans_lanes_decode": 0,
              "conv2d_nhwc": 2 * CONV2D_PASS}
BENCH_IL_PAIR = {**BENCH_PAIR, "rans_lanes_encode": 5,
                 "rans_lanes_decode": 5}


def bench_run(label: str, ckpt: str, args: list, env_extra: dict) -> dict:
    """bench_torch.py `args` as a subprocess on `ckpt` ("" = seeded
    weights): fails unless it exits 0 and its last line is a result with
    value > 0, no error, the certified encoder and the interleaved profile
    ok with no batch coded classic, and unless its launch line has each
    measured part's pairs' launches exactly. Returns {"result",
    "launches", "seconds"}."""
    import torch

    torch.cuda.empty_cache()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DCAE_BENCH_")}
    env.update(DCAE_BENCH_CKPT=ckpt, **env_extra)
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "bench_torch.py", *args], env=env,
                         cwd=root, capture_output=True, text=True,
                         timeout=1700)
    sec = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        fail(f"{label}: bench_torch.py exit {out.returncode}\n"
             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    print(f"{label}: " + lines[-1], flush=True)
    res = json.loads(lines[-1])
    det = res["detail"]
    if "terminated_by_signal" in det:
        fail(f"{label}: bench_torch.py was cut by signal "
             f"{det['terminated_by_signal']} before its end: {res}")
    il = det.get("interleaved_profile", {})
    if not (res["value"] > 0 and "error" not in det
            and det.get("fast_encoder") is True and il.get("ok") is True
            and il.get("classic_batches") == 0):
        fail(f"{label}: want value > 0, no error, fast_encoder, the "
             f"interleaved profile ok with 0 classic batches; got {res}")
    launch_line = [ln for ln in lines if ln.startswith("launches ")][-1]
    counts = json.loads(launch_line.split(" ", 1)[1])
    rounds_pairs = det["rounds"] * det["pipeline_batches"]
    pairs = {"single_image": (1, BENCH_PAIR), "sequential": (2, BENCH_PAIR),
             "interleaved": (4, BENCH_IL_PAIR),
             "serving_classic": (rounds_pairs, BENCH_PAIR),
             "serving_interleaved": (rounds_pairs, BENCH_IL_PAIR),
             "interleaved_single_image": (2, BENCH_IL_PAIR),
             "indexes_1trip": (2, BENCH_PAIR)}
    print(f"{label}: {sec:.1f} s, launches {json.dumps(counts)}", flush=True)
    for part, (n, per) in pairs.items():
        check_counts(f"{label} {part}", counts.get(part),
                     {k: n * v for k, v in per.items()})
    return {"result": res, "launches": counts, "seconds": sec}


def bench_phase() -> dict:
    """bench_torch.py at reduced depth on seeded weights: batch 2, 1 round,
    budget 0, 2 pipeline batches."""
    return bench_run("bench", "", ["2", "1"],
                     {"DCAE_BENCH_BUDGET_S": "0",
                      "DCAE_BENCH_PIPE_BATCHES": "2"})


# ------------------------------------------------------------ validate --

def validate_phase() -> dict:
    """The records' full run (not part of all): validate_training --full
    at the JAX package's protocol (200 synthetic 256x256 PNGs, 8 epochs of
    25 steps, batch 8) at lambda 0.013, 0.0018 and 0.05; rd_sweep_eval
    over the three checkpoints; lanes_ab (K 1024 / 512 / 256 / 128, batch
    8, 3 rounds) and profile_interleaved on the lambda 0.013 checkpoint;
    cross-device decode without shipped indexes on its weights, both ways;
    bench_torch.py at its full protocol on seeded weights and on the lambda
    0.013 checkpoint. The checkpoints stay in a temporary directory."""
    from dcae_tpu_torch.data.synthetic import make_dataset
    from dcae_tpu_torch.tools import rd_sweep_eval
    from dcae_tpu_torch.utils.checkpoint import load_params_only

    t_phase = time.perf_counter()
    out = {"runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "synth")
        make_dataset(data, n_train=200)
        for lam in (0.013, 0.0018, 0.05):
            out["runs"][str(lam)] = run_validation(
                data, os.path.join(tmp, f"lam{lam}"), 8, 200, lam)
        points = [f"{lam}:{out['runs'][str(lam)]['checkpoint']}"
                  for lam in (0.05, 0.013, 0.0018)]
        sweep, counts, sec = tool_run(
            "rd_sweep_eval", lambda: rd_sweep_eval.main(
                ["--points", *points, "--data", data, "--images", "8"]))
        out["rd_sweep"] = {k: sweep[k] for k in (
            "points", "bd_rate_vs_anchor_pct", "anchor", "caveat")}
        ckpt = out["runs"]["0.013"]["checkpoint"]
        out["cross_device_unshipped"] = cross_device_part(
            load_params_only(ckpt))
        out.update(run_lanes_profile(ckpt, "1024,512,256,128", 3, 8,
                                     "both"))
        # the bench's own protocol: batch 8, 3 rounds, the default budget
        out["bench_seeded"] = bench_run("bench seeded", "", [], {})
        out["bench_trained"] = bench_run("bench lambda 0.013", ckpt, [], {})
    out["seconds"] = time.perf_counter() - t_phase
    print(f"validate phase: {out['seconds']:.1f} s", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("all", "kernels", "rans",
                                        "reference", "slice", "train",
                                        "split",
                                        "serve", "sp", "tools", "bench",
                                        "profile", "bands", "validate"),
                    default="all",
                    help="one phase only; rans: the lane coders' part of "
                    "kernels alone; profile (not part of all) traces "
                    "the slice with torch.profiler; bands (not part of all) "
                    "times the bf16 conv_glu under three band sizes; "
                    "validate (not part of all) trains three checkpoints "
                    "and measures them with the tools")
    # a rank of the sp phase, which starts it: rank, port, result dir
    ap.add_argument("--sp-worker", nargs=3, help=argparse.SUPPRESS)
    # a rank of the sp phase's gloo probe: rank, port
    ap.add_argument("--gloo-probe", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.sp_worker:
        rank, port, tmp = args.sp_worker
        sp_worker(int(rank), int(port), tmp)
        return 0
    if args.gloo_probe:
        gloo_probe_worker(*map(int, args.gloo_probe))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    from dcae_tpu_torch.ops.kernels import _build
    from dcae_tpu_torch.utils.profiling import card_line

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    _build.build_kernels()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for src, log in _build.build_logs.items():
        print(f"--- {os.path.basename(src)}\n{log.strip()}", flush=True)

    gen = torch.Generator().manual_seed(0)
    results = None
    slice_res = None
    if args.phase in ("all", "kernels"):
        results = kernel_phase(gen)
    if args.phase == "rans":
        print(json.dumps({"rans": rans_phase()}))
    if args.phase in ("all", "reference"):
        reference_phase()
    if args.phase in ("all", "slice"):
        slice_res = slice_phase()
    train_res = None
    if args.phase in ("all", "train"):
        train_res = train_phase()
    split_res = None
    if args.phase in ("all", "split"):
        split_res = split_phase(train_res)
    serve_res = None
    if args.phase in ("all", "serve"):
        serve_res = serve_phase(train_res)
    sp_res = None
    if args.phase in ("all", "sp"):
        sp_res = sp_phase()
    tools_res = None
    if args.phase in ("all", "tools"):
        tools_res = tools_phase()
    bench_res = None
    if args.phase in ("all", "bench"):
        bench_res = bench_phase()
    validate_res = None
    if args.phase == "validate":
        validate_res = validate_phase()
    if args.phase == "profile":
        profile_phase()
    if args.phase == "bands":
        bands_phase(gen)
    if results is not None and slice_res is not None:
        # each kernel's launches on the path that runs it: wmsa_block and
        # conv_glu on the default codec, wmsa_attention on the
        # attention-only one, the lane coders on the interleaved profile
        paths = {"wmsa_block": "staged", "conv_glu": "staged",
                 "wmsa_attention": "attention_only",
                 "rans_lanes_encode": "interleaved",
                 "rans_lanes_decode": "interleaved",
                 "conv2d_nhwc": "interleaved"}
        launches = {k: slice_res[paths[k]]["launches_compress"][k]
                    + slice_res[paths[k]]["launches_decompress"][k]
                    for k in results}
        # on the training path: the default step's counts, and the
        # attention-only step's for wmsa_attention
        train_launches = None
        if train_res is not None:
            train_launches = dict(train_res["launches_step"])
            train_launches["wmsa_attention"] = train_res[
                "launches_attention_only_step"]["wmsa_attention"]
        print(json.dumps({"kernels": kernel_summary(results, launches,
                                                    train_launches),
                          "slice": slice_res, "train": train_res}))
    if split_res is not None:
        print(json.dumps({"split": split_res}))
    if serve_res is not None:
        print(json.dumps({"serve": serve_res}))
    if sp_res is not None:
        print(json.dumps({"sp": sp_res}))
    if tools_res is not None:
        print(json.dumps({"tools": tools_res}))
    if bench_res is not None:
        print(json.dumps({"bench": bench_res}))
    if validate_res is not None:
        print(json.dumps({"validate": validate_res}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
