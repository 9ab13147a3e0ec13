#!/usr/bin/env python3
"""Transforms-only autoencoder evaluation CLI of the PyTorch port.

Joint: PSNR, MS-SSIM (dB), the analytic compression ratio and encode /
decode time per image; per-image metrics files, reconstructed PNGs and a
summary file with --save_path. --split: the split deployment, g_a on
--device_encoder, the latent shipped as --latent_dtype (float16 by
default), g_s on --device_decoder; per-stage encode / transfer / decode
time, a size analysis of one image, and g_a / g_s sizes.

    python -m dcae_tpu_torch.tools.eval_autoencoder --data <dir> \
        [--checkpoint ae.ckpt | --from_dcae dcae.ckpt] [--split \
        --device_encoder cpu --latent_dtype float16]

--device and --device_decoder default to cuda (raise without a card);
--device_encoder defaults to cpu, the CPU edge of the split deployment,
as in the JAX tool. Images keep their resolution, padded to the model's
multiple.
"""

import argparse
import math
import os
import time

import numpy as np
import torch

from dcae_tpu_torch.data.datasets import list_images, load_image
from dcae_tpu_torch.models.autoencoder import (SimpleAutoencoder,
                                               params_from_dcae)
from dcae_tpu_torch.models.codec import resolve_device
from dcae_tpu_torch.ops.layers import crop_spatial, pad_spatial
from dcae_tpu_torch.tools._cli import add_device_flag, config, save_png
from dcae_tpu_torch.utils.checkpoint import load_params_only
from dcae_tpu_torch.utils.metrics import ms_ssim, msssim_db, psnr

LATENT_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                 "bfloat16": torch.bfloat16, "int8": torch.int8}
_LATENT_BITS = {"float32": 32, "float16": 16, "bfloat16": 16, "int8": 8}


def module_mb(module: torch.nn.Module) -> float:
    return sum(p.numel() * p.element_size()
               for p in module.parameters()) / 2**20


def size_analysis(x_shape, y_shape, latent_dtype: str) -> dict:
    """uint8 image against shipped-latent bytes, and the spatial / channel
    factors."""
    _, h, w, c = x_shape
    _, yh, yw, yc = y_shape
    orig_bits = h * w * c * 8
    latent_bits = yh * yw * yc * _LATENT_BITS[latent_dtype]
    return {
        "orig_resolution": (h, w, c),
        "orig_size_mb": orig_bits / (8 * 2**20),
        "latent_resolution": (yh, yw, yc),
        "latent_dtype": latent_dtype,
        "latent_size_mb": latent_bits / (8 * 2**20),
        "spatial_reduction": (h * w) / (yh * yw),
        "channel_expansion": yc / c,
        "compression_ratio": orig_bits / latent_bits,
    }


def ship(y: torch.Tensor, dtype: str, device) -> torch.Tensor:
    """The latent as the wire carries it (int8: max-abs scaled and
    rounded, as the DLT1 container does), then on `device` in f32."""
    if dtype == "int8":
        scale = y.abs().amax().clamp_min(1e-30) / 127.0
        q = torch.clamp(torch.round(y / scale), -128, 127).to(torch.int8)
        return q.to(device).to(torch.float32) * scale.to(device)
    return y.to(LATENT_DTYPES[dtype]).to(device).to(torch.float32)


def _sync(*devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def load_autoencoder(cfg, checkpoint=None, from_dcae=None, seed=100
                     ) -> SimpleAutoencoder:
    model = SimpleAutoencoder(cfg)
    if checkpoint:
        sd = load_params_only(checkpoint)
        print(f"loaded {checkpoint}")
    elif from_dcae:
        sd = params_from_dcae(load_params_only(from_dcae), strict=True)
        print(f"transforms from the DCAE checkpoint {from_dcae}")
    else:
        model.reset_parameters(torch.Generator().manual_seed(seed))
        return model.eval()
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()},
                          strict=True)
    return model.eval()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="SimpleAutoencoder checkpoint (train_autoencoder)")
    p.add_argument("--from_dcae", type=str, default=None,
                   help="g_a / g_s out of a full DCAE checkpoint")
    p.add_argument("--M", type=int, default=320,
                   help="latent channels (the reference split eval uses "
                        "160)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--save_path", type=str, default=None,
                   help="write reconstructed_*.png, metrics_*.txt and a "
                        "summary file here")
    p.add_argument("--split", action="store_true",
                   help="g_a on --device_encoder, the latent shipped as "
                        "--latent_dtype, g_s on --device_decoder")
    add_device_flag(p, help_="joint mode's device:")
    # the CPU edge of the split deployment, as the JAX tool defaults it
    p.add_argument("--device_encoder", type=str, default="cpu",
                   help="split mode's g_a device: cpu (default) or cuda")
    add_device_flag(p, "--device_decoder", "split mode's g_s device:")
    p.add_argument("--latent_dtype", type=str, default="float16",
                   choices=list(LATENT_DTYPES),
                   help="the shipped latent's dtype in split mode")
    p.add_argument("--seed", type=int, default=100)
    return p


@torch.no_grad()
def main(argv=None):
    a = parser().parse_args(argv)

    cfg = config(a.tiny, M=a.M)
    model = load_autoencoder(cfg, a.checkpoint, a.from_dcae, a.seed)
    g_a_mb, g_s_mb = module_mb(model.g_a), module_mb(model.g_s)
    print(f"model sizes: g_a {g_a_mb:.2f} MB, g_s {g_s_mb:.2f} MB, "
          f"total {g_a_mb + g_s_mb:.2f} MB")
    if a.split:
        enc_dev = resolve_device(a.device_encoder)
        dec_dev = resolve_device(a.device_decoder)
        print(f"split deployment: g_a on {enc_dev}, g_s on {dec_dev}, "
              f"latent shipped as {a.latent_dtype}")
    else:
        enc_dev = dec_dev = resolve_device(a.device)
    model.g_a.to(enc_dev)
    model.g_s.to(dec_dev)
    if a.save_path:
        os.makedirs(a.save_path, exist_ok=True)

    tot = {"psnr": 0.0, "msssim": 0.0, "ratio": 0.0,
           "enc": 0.0, "xfer": 0.0, "dec": 0.0}
    count = msssim_count = 0
    ana = None
    paths = list_images(a.data)
    if not paths:
        raise SystemExit(f"no images in {a.data}")
    for i, path in enumerate(paths):
        x = torch.from_numpy(load_image(path)[None])
        padded, padding = pad_spatial(x.to(enc_dev), cfg.pad_multiple)
        warm = i == 0              # the first image is left out of timing
        _sync(enc_dev, dec_dev)
        t0 = time.perf_counter()
        y = model.compress(padded)
        _sync(enc_dev)
        t1 = time.perf_counter()
        if a.split:
            y = ship(y, a.latent_dtype, dec_dev)
            _sync(enc_dev, dec_dev)
        t2 = time.perf_counter()
        x_hat = model.decompress(y)
        _sync(dec_dev)
        t3 = time.perf_counter()

        if ana is None:
            ana = size_analysis(padded.shape, y.shape,
                                a.latent_dtype if a.split else "float32")
            print("\nSIZE ANALYSIS (one padded image)")
            for k, v in ana.items():
                print(f"  {k}: {round(v, 3) if isinstance(v, float) else v}")
            print()

        x_hat = crop_spatial(x_hat.cpu(), padding)
        p_db = float(psnr(x, x_hat))
        try:
            ms_db = msssim_db(ms_ssim(x, x_hat))
        except RuntimeError:
            ms_db = float("nan")     # below the 5-scale minimum
        ratio = ana["compression_ratio"]
        count += 1
        tot["psnr"] += p_db
        if not math.isnan(ms_db):
            tot["msssim"] += ms_db
            msssim_count += 1
        tot["ratio"] += ratio
        if not warm:
            tot["enc"] += t1 - t0
            tot["xfer"] += t2 - t1
            tot["dec"] += t3 - t2
        stage = f"enc {1000 * (t1 - t0):.1f} ms, "
        if a.split:
            stage += f"xfer {1000 * (t2 - t1):.1f} ms, "
        stage += f"dec {1000 * (t3 - t2):.1f} ms"
        print(f"{os.path.basename(path)}: PSNR {p_db:.2f} dB, MS-SSIM "
              f"{ms_db:.4f} dB, {stage}" + (" [warm-up]" if warm else ""))
        if a.save_path:
            name = os.path.splitext(os.path.basename(path))[0]
            with open(os.path.join(a.save_path, f"metrics_{name}.txt"),
                      "w") as f:
                f.write(f"PSNR: {p_db:.2f}dB\nMS-SSIM: {ms_db:.4f}\n"
                        f"Compression Ratio: {ratio:.2f}\n")
            save_png(x_hat[0], os.path.join(a.save_path,
                                            f"reconstructed_{name}.png"))

    timed = max(count - 1, 1)
    lines = [
        f"Total images processed: {count}",
        f"Average PSNR: {tot['psnr'] / count:.2f} dB",
        f"Average MS-SSIM: {tot['msssim'] / max(msssim_count, 1):.4f} dB"
        + (f" (over {msssim_count}/{count} images large enough for 5-scale "
           "MS-SSIM)" if msssim_count != count else ""),
        f"Average Compression Ratio: {tot['ratio'] / count:.2f}",
        f"Average encode time per image: {1000 * tot['enc'] / timed:.3f} ms",
        f"Average decode time per image: {1000 * tot['dec'] / timed:.3f} ms",
    ]
    if a.split:
        lines.insert(0, f"Split Deployment: g_a on {enc_dev}, g_s on "
                        f"{dec_dev} ({a.latent_dtype} latent)")
        lines.append(f"Average transfer time per image: "
                     f"{1000 * tot['xfer'] / timed:.3f} ms")
    print("\n" + "=" * 50 + "\nEVALUATION RESULTS\n" + "=" * 50)
    print("\n".join(lines))
    if a.save_path:
        out = os.path.join(a.save_path, "summary_results"
                           + ("_split" if a.split else "") + ".txt")
        with open(out, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"results saved to {out}")
    return {"lines": lines, "size_analysis": ana}


if __name__ == "__main__":
    main()
