#!/usr/bin/env python3
"""Multi-lambda RD sweep over trained checkpoints, the JAX package's
tools/rd_sweep_eval.py on the port.

Real entropy-coded evaluation (update() -> compress -> decompress, stream
bpp and PSNR) of one checkpoint a lambda on held-out images; prints the
RD table and the BD-rate against the reference's published anchor curve
(data/rd_reference.py).

The test curve comes from the held-out split of the synthetic training
corpus (data/synthetic.py): no Kodak set is at hand and the reference
ships no trained weights. The BD-rate is therefore a cross-corpus number,
expected to be strongly positive, and the output says so.

    python -m dcae_tpu_torch.tools.rd_sweep_eval \
        --points 0.05:ck_05/checkpoint_latest.ckpt \
                 0.013:ck_013/checkpoint_latest.ckpt \
        [--data DIR] [--images 8] [--out rd_sweep.json]

Runs on the CUDA device; --device cpu on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

CAVEAT = ("test curve measured on held-out synthetic-corpus images (no "
          "Kodak in this environment; the reference ships no weights): a "
          "cross-corpus BD-rate")


def sweep(points, cfg, data: str, images: int, device,
          anchor: str = "Kodak") -> dict:
    """points: [(lambda, checkpoint path)], high rate first. Each
    checkpoint's mean real-coded bpp and PSNR over the first `images`
    center crops (256^2) of data/test, and the BD-rate of those points
    against REFERENCE_RD[anchor] (None where it cannot be computed)."""
    from dcae_tpu_torch.data.datasets import ImageFolder
    from dcae_tpu_torch.data.rd_reference import REFERENCE_RD, bd_rate
    from dcae_tpu_torch.eval_lib import eval_image_real
    from dcae_tpu_torch.models.codec import DCAECodec
    from dcae_tpu_torch.utils.checkpoint import load_params_only

    test_ds = ImageFolder(data, "test", 256, num_workers=2)
    try:
        batch = next(iter(test_ds.batches(images, drop_last=False)))
    finally:
        test_ds.pool.shutdown()
    batch = np.asarray(batch)[:images]

    rows = []
    for lam, ckpt in points:
        codec = DCAECodec(cfg, params=load_params_only(ckpt), device=device)
        try:
            codec.update(force=True)
            rs = [eval_image_real(codec, batch[i:i + 1])
                  for i in range(batch.shape[0])]
        finally:
            codec.close()
        row = {"lambda": float(lam), "checkpoint": ckpt,
               "bpp": float(np.mean([r.bpp for r in rs])),
               "psnr": float(np.mean([r.psnr for r in rs])),
               "images": batch.shape[0]}
        rows.append(row)
        print(f"lambda {lam}: bpp {row['bpp']:.4f}  psnr {row['psnr']:.2f} "
              f"dB  ({ckpt})", flush=True)

    ref = REFERENCE_RD[anchor]
    try:
        bd = bd_rate(ref["bpp"], ref["psnr"], [r["bpp"] for r in rows],
                     [r["psnr"] for r in rows])
    except (ValueError, np.linalg.LinAlgError) as e:
        bd = None
        print(f"BD-rate not computable: {e}")
    if bd is not None:
        print(f"BD-rate vs {anchor} anchor: {bd:+.1f}% (positive = our "
              "curve needs more bits at equal PSNR; " + CAVEAT + ")")
    return {"points": rows, "anchor": anchor, "anchor_curve": ref,
            "bd_rate_vs_anchor_pct": bd, "caveat": CAVEAT}


def parse_points(specs) -> list:
    """'lambda:checkpoint' strings -> [(lambda, checkpoint)]."""
    out = []
    for spec in specs:
        lam, ckpt = spec.split(":", 1)
        out.append((float(lam), ckpt))
    return out


def main(argv=None) -> dict:
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.codec import resolve_device
    from dcae_tpu_torch.tools._cli import add_device_flag, synth_dir

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", nargs="+", required=True,
                    help="lambda:checkpoint pairs, high rate first")
    ap.add_argument("--data", default=synth_dir(),
                    help="validate_training's corpus (default: dcae_synth "
                    "under TMPDIR)")
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--dataset", default="Kodak",
                    help="reference anchor curve for BD-rate")
    add_device_flag(ap)
    a = ap.parse_args(argv)
    out = sweep(parse_points(a.points), DCAEConfig(), a.data, a.images,
                resolve_device(a.device), a.dataset)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {a.out}")
    return out


if __name__ == "__main__":
    main()
