#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dcae_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as the checks run it
    python3 chip_smoke.py --phase kernels

Phases, in order:
  build      nvcc builds every kernel of csrc/ from this checkout (one
             compiler per source, all at once) into build/.
  kernels    each kernel against its plain PyTorch version on the card at
             the main path's shapes (batch 2 of 768x512), with times, the
             least time the card could take (bound) and, for wmsa_block, an
             SDPA call as yardstick; the f32 DCA conv_glu must be bitwise
             repeatable.
  reference  the full-width f32 model on the card against the same weights
             on the CPU (plain versions), on a 128x128 image.
  slice      the full-size bf16 codec (seeded random weights): compress 2
             structured 768x512 images, write and read .bin files,
             decompress; the decoder's per-slice indexes and symbols must
             equal the encoder's, and the launch counters must show that
             both kernels ran on the main path.
  profile    (only with --phase profile) device time of one slice run by
             kernel, from torch.profiler.

Exits non-zero (and prints no result) without a CUDA device or on any
failed check. The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense; f32 non-tensor
# max|kernel - plain| / max|plain|: ~2x / ~6x the largest errors measured
# on an H100 (4.4e-3 in bf16, 1.7e-6 in f32; PERF.md), well inside the
# first bars of 3e-2 / 1e-4
TOL = {"bfloat16": 1e-2, "float32": 1e-5}

# (label, H, W, C, heads, shifted) at batch 2 of 768x512 images, and how
# often one compress + one decompress launches that shape (g_a + g_s)
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


def fail(msg: str) -> None:
    raise SystemExit(f"FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


# ------------------------------------------------------------- kernels --

def _uniform(gen, shape, bound_, device):
    import torch

    return ((torch.rand(shape, generator=gen) * 2 - 1) * bound_).to(device)


def wmsa_inputs(H, W, C, heads, dtype, gen):
    import torch

    dev = "cuda"
    x = torch.randn((BATCH, H, W, C), generator=gen).to(dev)
    p = [1 + 0.1 * torch.randn((C,), generator=gen),     # ln_w
         0.1 * torch.randn((C,), generator=gen),         # ln_b
         1 + 0.1 * torch.randn((C,), generator=gen)]     # rs
    p = [t.to(dev) for t in p]
    b = C ** -0.5
    p += [_uniform(gen, (3 * C, C), b, dev), _uniform(gen, (3 * C,), b, dev),
          _uniform(gen, (C, C), b, dev), _uniform(gen, (C,), b, dev),
          (0.02 * torch.randn((heads, 15, 15), generator=gen)).to(dev)]
    return x.to(dtype), [t.to(dtype).contiguous() for t in p]


def conv_glu_inputs(H, W, C, hidden, dtype, gen):
    import torch

    dev = "cuda"
    x = torch.randn((BATCH, H, W, C), generator=gen).to(dev)
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


def sdpa_yardstick(x, p, heads, shifted):
    """One SDPA call over the windows' q/k/v with the same bias and mask:
    the attention core of wmsa_block (no LN, qkv or proj)."""
    import torch
    import torch.nn.functional as F
    from dcae_tpu_torch.ops.kernels.wmsa_block import (
        relative_position_bias, shifted_window_mask)

    B, H, W, C = x.shape
    nh, nw, hd = H // 8, W // 8, C // heads
    q, k, v = (torch.randn((B, nh * nw, heads, 64, hd), device=x.device,
                           dtype=x.dtype) for _ in range(3))
    bias = relative_position_bias(p[7].float())           # (heads, 64, 64)
    if shifted:
        mask = torch.as_tensor(shifted_window_mask(nh, nw), device=x.device)
        bias = bias[None].masked_fill(mask[:, None], float("-inf"))[None]
    bias = bias.to(x.dtype)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)


def kernel_phase(gen) -> dict:
    import torch
    from dcae_tpu_torch.ops.kernels.conv_glu import conv_glu, conv_glu_ref
    from dcae_tpu_torch.ops.kernels.wmsa_block import (wmsa_block,
                                                       wmsa_block_ref)

    results = {"wmsa_block": [], "conv_glu": []}
    for label, H, W, C, heads, shifted, per_run in WMSA_CASES:
        for dtype in ("bfloat16", "float32"):
            x, p = wmsa_inputs(H, W, C, heads, getattr(torch, dtype), gen)
            kw = dict(heads=heads, shifted=shifted)
            got = wmsa_block(x, *p, **kw)
            want = wmsa_block_ref(x, *p, **kw)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            ok = bool(torch.isfinite(got.float()).all()) and err <= TOL[dtype]
            tokens = BATCH * H * W
            esize = x.element_size()
            nbytes = 2 * x.numel() * esize + sum(t.numel() for t in p) * esize
            flops = tokens * (8 * C * C + 4 * 64 * C)
            b_ms, b_by = bound(nbytes, flops, dtype)
            row = {"case": f"{label} {dtype}", "rel_err": err,
                   "max_abs_err": float((got.float() - want.float()).abs()
                                        .max()),
                   "tol": TOL[dtype], "ok": ok, "main_path": dtype ==
                   "bfloat16", "per_run": per_run,
                   "ms": time_ms(lambda: wmsa_block(x, *p, **kw)),
                   "plain_ms": time_ms(lambda: wmsa_block_ref(x, *p, **kw),
                                       iters=3, warmup=1),
                   "library_ms": time_ms(sdpa_yardstick(x, p, heads,
                                                        shifted)),
                   "bound_ms": b_ms, "bound_by": b_by}
            print(f"wmsa_block {row['case']}: rel err {err:.3e} (tol "
                  f"{TOL[dtype]:.0e}) ms {row['ms']:.3f} plain "
                  f"{row['plain_ms']:.3f} sdpa {row['library_ms']:.3f} "
                  f"bound {b_ms:.4f} ({b_by})", flush=True)
            results["wmsa_block"].append(row)
            del x, p, got, want
    for label, H, W, C, hidden, dtype, per_run in CONV_GLU_CASES:
        x, p = conv_glu_inputs(H, W, C, hidden, getattr(torch, dtype), gen)
        got = conv_glu(x, *p)
        want = conv_glu_ref(x, *p)
        again = conv_glu(x, *p)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        repeat = bool(torch.equal(got, again))
        ok = bool(torch.isfinite(got.float()).all()) and err <= TOL[dtype] \
            and (dtype != "float32" or repeat)
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
        print(f"conv_glu {row['case']}: rel err {err:.3e} (tol "
              f"{TOL[dtype]:.0e}) bitwise repeat {repeat} ms "
              f"{row['ms']:.3f} plain {row['plain_ms']:.3f} bound "
              f"{b_ms:.4f} ({b_by})", flush=True)
        results["conv_glu"].append(row)
        del x, p, got, want, again
    bad = [r["case"] for rows in results.values() for r in rows
           if not r["ok"]]
    if bad:
        fail(f"kernel checks: {bad}")
    return results


def kernel_summary(results: dict, launches: dict) -> list:
    """One entry per kernel: its time over one compress + decompress at
    the main path's shapes (per-shape time x launches of that shape)."""
    meta = {
        "wmsa_block": ("dcae_tpu_torch/csrc/wmsa_block.cu",
                       "dcae_tpu/ops/pallas/wmsa_v4.py:168"),
        "conv_glu": ("dcae_tpu_torch/csrc/conv_glu.cu",
                     "dcae_tpu/ops/pallas/conv_glu.py:190"),
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
                                          "bound_by", "rel_err", "per_run")}
                       for r in rows],
        })
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

def synthetic_kodak(n: int, h: int = 512, w: int = 768,
                    seed: int = 100) -> np.ndarray:
    """Structured synthetic images (gradients, block texture, soft
    rectangles, mild noise) as uint8 (n, h, w, 3): the JAX package's
    benchmark corpus, reproduced here."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    imgs = np.empty((n, h, w, 3), np.float32)
    for i in range(n):
        img = np.stack([
            0.5 + 0.5 * np.sin(2 * np.pi * (rng.uniform(0.5, 2) * xx
                                            + rng.uniform(0, 1))),
            0.5 + 0.5 * np.sin(2 * np.pi * (rng.uniform(0.5, 2) * yy
                                            + rng.uniform(0, 1))),
            0.5 * (xx + yy),
        ], axis=-1)
        blocks = rng.uniform(0, 1, (8, 8, 3))
        img = 0.6 * img + 0.4 * np.kron(blocks, np.ones((h // 8, w // 8, 1)))
        for _ in range(6):
            t = rng.integers(0, h - 32)
            l = rng.integers(0, w - 32)
            bh, bw = rng.integers(16, 160, 2)
            img[t:t + bh, l:l + bw] = (0.7 * img[t:t + bh, l:l + bw]
                                       + 0.3 * rng.uniform(0, 1, 3))
        imgs[i] = img + rng.normal(0, 0.01, img.shape)
    return (np.clip(imgs, 0, 1) * 255).round().astype(np.uint8)


def slice_phase() -> dict:
    import torch
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.codec import DCAECodec
    from dcae_tpu_torch.ops.kernels.conv_glu import conv_glu
    from dcae_tpu_torch.ops.kernels.wmsa_block import wmsa_block
    from dcae_tpu_torch.runtime.container import read_bin, save_bin

    cfg = DCAEConfig()
    t0 = time.perf_counter()
    codec = DCAECodec(cfg, dtype=torch.bfloat16, seed=0)
    codec.update()
    print(f"slice: codec built + tables baked in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    imgs = synthetic_kodak(BATCH)
    B, H, W, _ = imgs.shape

    codec.decompress(**_strings(codec.compress(imgs)))   # warm-up, uncounted
    torch.cuda.synchronize()

    def reset():
        wmsa_block.launches = 0
        conv_glu.launches = 0

    reset()
    enc_record: list = []
    t0 = time.perf_counter()
    enc = codec.compress(imgs, record=enc_record)
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t0) * 1e3 / B
    enc_counts = {"wmsa_block": wmsa_block.launches,
                  "conv_glu": conv_glu.launches}

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
                fail(f".bin header: {z_shape} {size}")
            y_strings.append(strings[0][0])
            z_strings.append(strings[1][0])

    reset()
    dec_record: list = []
    t0 = time.perf_counter()
    dec = codec.decompress([y_strings, z_strings], z_shape,
                           record=dec_record)
    x_hat = dec["x_hat"]
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) * 1e3 / B
    dec_counts = {"wmsa_block": wmsa_block.launches,
                  "conv_glu": conv_glu.launches}

    # four more timed round trips after the counted one: median of five
    enc_runs, dec_runs = [enc_ms], [dec_ms]
    for _ in range(4):
        t0 = time.perf_counter()
        again = codec.compress(imgs)
        torch.cuda.synchronize()
        enc_runs.append((time.perf_counter() - t0) * 1e3 / B)
        t0 = time.perf_counter()
        codec.decompress(**_strings(again))
        torch.cuda.synchronize()
        dec_runs.append((time.perf_counter() - t0) * 1e3 / B)
    codec.close()

    exact = len(enc_record) == len(dec_record) == cfg.num_slices and all(
        np.array_equal(ei, di) and np.array_equal(es, ds)
        for (ei, es), (di, ds) in zip(enc_record, dec_record))
    x_hat = x_hat.float().cpu().numpy()
    ref = imgs.astype(np.float32) / 255.0
    mse = float(np.mean((x_hat - ref) ** 2))
    psnr = 10 * np.log10(1.0 / max(mse, 1e-20))
    bpp = nbytes * 8 / (B * H * W)
    res = {"bpp": bpp, "psnr_db": psnr,
           "encode_ms_per_image": float(np.median(enc_runs)),
           "decode_ms_per_image": float(np.median(dec_runs)),
           "encode_ms_runs": enc_runs, "decode_ms_runs": dec_runs,
           "exact_decode": exact,
           "launches_compress": enc_counts,
           "launches_decompress": dec_counts,
           "x_hat_shape": list(x_hat.shape)}
    print("slice: " + json.dumps(res), flush=True)
    want = {"wmsa_block": 15, "conv_glu": 17}
    if not exact:
        fail("decoded indexes/symbols differ from the encoder's")
    if enc_counts != want or dec_counts != want:
        fail(f"launch counts {enc_counts} / {dec_counts}, want {want}")
    if x_hat.shape != ref.shape or not np.isfinite(x_hat).all():
        fail("x_hat is not finite or has the wrong shape")
    return res


def _strings(enc: dict) -> dict:
    return {"strings": enc["strings"], "shape": enc["shape"]}


def profile_phase() -> None:
    """Where one compress + decompress of the slice spends device time:
    torch.profiler over a warm run, kernels summed by name, and the share
    of the wall time the device was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.codec import DCAECodec

    codec = DCAECodec(DCAEConfig(), dtype=torch.bfloat16, seed=0)
    codec.update()
    imgs = synthetic_kodak(BATCH)
    codec.decompress(**_strings(codec.compress(imgs)))   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enc = codec.compress(imgs)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        codec.decompress(**_strings(enc))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    dev = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                            getattr(e, "self_cuda_time_total", 0))
    # device-side events only: a CPU op's "self device time" repeats the
    # time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev(e) > 0]
    busy_ms = sum(dev(e) for e in events) / 1e3
    groups: dict = {}
    for e in events:
        name = e.key
        g = ("wmsa_block kernels" if "wmsa_block" in name else
             "conv_glu kernels" if "conv_glu" in name else
             "gemm" if "gemm" in name.lower() or "cutlass" in name.lower()
             else "convolution" if "conv" in name.lower() or "cudnn" in
             name.lower() else "other")
        groups[g] = groups.get(g, 0.0) + dev(e) / 1e3
    print(f"profile: compress+decompress of {BATCH} images: wall "
          f"{wall * 1e3:.1f} ms (compress {t_enc * 1e3:.1f} ms), device "
          f"busy {busy_ms:.1f} ms ({100 * busy_ms / (wall * 1e3):.1f}%)",
          flush=True)
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"profile group {g}: {ms:.2f} ms", flush=True)
    for e in sorted(events, key=dev, reverse=True)[:15]:
        print(f"profile kernel {dev(e) / 1e3:9.3f} ms x{e.count:4d}  "
              f"{e.key[:90]}", flush=True)
    codec.close()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("all", "kernels", "reference",
                                        "slice", "profile"), default="all",
                    help="one phase only; profile (not part of all) traces "
                    "the slice with torch.profiler")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    from dcae_tpu_torch.ops.kernels import _build

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
    if args.phase in ("all", "reference"):
        reference_phase()
    if args.phase in ("all", "slice"):
        slice_res = slice_phase()
    if args.phase == "profile":
        profile_phase()
    if results is not None and slice_res is not None:
        launches = {k: slice_res["launches_compress"][k]
                    + slice_res["launches_decompress"][k]
                    for k in results}
        print(json.dumps({"kernels": kernel_summary(results, launches),
                          "slice": slice_res}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
