"""Evaluation layer: dataset eval with the reference protocol.

List the images of a directory, center pad-to-128, two modes: real
(entropy-coded round trip; bpp from stream bytes) and forward-only (bpp
from likelihoods); PSNR and MS-SSIM (reported in dB), per-image encode and
decode wall time with the device drained, the first image treated as
warm-up and left out of the timing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dcae_tpu_torch.data.datasets import list_images, load_image
from dcae_tpu_torch.entropy.rans import EscapeError
from dcae_tpu_torch.models.codec import DCAECodec
from dcae_tpu_torch.ops.layers import crop_spatial, pad_spatial
from dcae_tpu_torch.utils.metrics import (AverageMeter, likelihood_bpp,
                                          ms_ssim, msssim_db, psnr)


@dataclasses.dataclass
class ImageResult:
    name: str
    psnr: float
    msssim_db: float
    bpp: float
    enc_time: float
    dec_time: float


def _drain(codec: DCAECodec) -> None:
    """Wait for every card the codec runs on (a split codec has two
    devices)."""
    for dev in getattr(codec, "devices", (codec.device,)):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _quality(x: torch.Tensor, x_hat: torch.Tensor):
    """(PSNR dB, MS-SSIM dB); MS-SSIM is nan for an image smaller than
    the 5-scale minimum."""
    p = float(psnr(x, x_hat))
    try:
        ms = msssim_db(ms_ssim(x, x_hat))
    except RuntimeError:
        ms = float("nan")
    return p, ms


def _eval_coded_round_trip(codec: DCAECodec, x: np.ndarray,
                           compress_fn, decompress_fn,
                           byte_count_fn) -> ImageResult:
    """Shared scaffolding of the real-coded eval modes: pad, timed
    compress / decompress, crop, PSNR / MS-SSIM, bpp from byte_count_fn."""
    h, w = x.shape[1:3]
    x_dev = codec._input(x)
    padded, padding = pad_spatial(x_dev, codec.cfg.pad_multiple)

    _drain(codec)
    t0 = time.perf_counter()
    enc = compress_fn(padded)
    t1 = time.perf_counter()
    dec = decompress_fn(enc)
    _drain(codec)
    t2 = time.perf_counter()
    if not bool(dec.get("ok", True)):
        raise ValueError("interleaved decode lanes checksum failed")

    x_hat = crop_spatial(dec["x_hat"].to(x_dev.device, torch.float32),
                         padding)
    p, ms = _quality(x_dev, x_hat)
    return ImageResult("", p, ms, byte_count_fn(enc) * 8.0 / (h * w),
                       t1 - t0, t2 - t1)


def eval_image_real(codec: DCAECodec, x: np.ndarray) -> ImageResult:
    """Entropy-coded round trip of one image (B=1 NHWC in [0, 1])."""
    return _eval_coded_round_trip(
        codec, x,
        codec.compress,
        lambda enc: codec.decompress(enc["strings"], enc["shape"]),
        lambda enc: sum(len(s) for g in enc["strings"] for s in g))


def eval_image_interleaved(codec: DCAECodec, x: np.ndarray) -> ImageResult:
    """Entropy-coded round trip in the device-coding profile: bpp counts
    the whole container payload (streams + lane states + patches + z), so
    the profile's rate overhead is visible. An image whose out-of-table
    symbols exceed the patch list (EscapeError) falls back to the classic
    path, like every other surface of the profile."""
    try:
        return _eval_coded_round_trip(
            codec, x,
            codec.compress_device,
            codec.decompress_interleaved,
            lambda enc: (sum(len(s) for s in enc["istreams"])
                         + np.asarray(enc["states"]).nbytes
                         + sum(8 * len(p[0]) for p in enc["patches"])
                         + sum(len(s) for s in enc["z_strings"])))
    except EscapeError:
        return eval_image_real(codec, x)


def eval_image_forward(codec: DCAECodec, x: np.ndarray) -> ImageResult:
    """Forward-only eval: bpp from likelihoods, no bitstream."""
    h, w = x.shape[1:3]
    x_dev = codec._input(x)
    padded, padding = pad_spatial(x_dev, codec.cfg.pad_multiple)
    _drain(codec)
    t0 = time.perf_counter()
    out = codec.forward(padded)
    _drain(codec)
    t1 = time.perf_counter()
    x_hat = crop_spatial(torch.clamp(
        out["x_hat"].to(x_dev.device, torch.float32), 0, 1), padding)
    p, ms = _quality(x_dev, x_hat)
    bpp = float(likelihood_bpp(out["likelihoods"], h * w))
    return ImageResult("", p, ms, bpp, t1 - t0, 0.0)


def eval_directory(codec: DCAECodec, data_dir: str, real: bool = False,
                   limit: Optional[int] = None,
                   verbose: bool = True,
                   profile: str = "classic") -> Dict[str, float]:
    files = list_images(data_dir)
    if limit:
        files = files[:limit]
    if profile == "interleaved":
        if not real:
            raise ValueError(
                "profile='interleaved' requires real=True (the device-"
                "coding profile is an entropy-coded round trip; forward "
                "mode has no bitstream)")
        fn = eval_image_interleaved
    else:
        fn = eval_image_real if real else eval_image_forward

    meters = {k: AverageMeter() for k in
              ("psnr", "msssim_db", "bpp", "enc_time", "dec_time")}
    results: List[ImageResult] = []
    for i, path in enumerate(files):
        x = load_image(path)[None]
        r = fn(codec, x)
        r.name = path
        results.append(r)
        if i == 0 and len(files) > 1:
            continue  # warm-up left out of the averages
        meters["psnr"].update(r.psnr)
        if np.isfinite(r.msssim_db):
            meters["msssim_db"].update(r.msssim_db)
        meters["bpp"].update(r.bpp)
        meters["enc_time"].update(r.enc_time)
        meters["dec_time"].update(r.dec_time)
        if verbose:
            print(f"{path}: psnr {r.psnr:.2f} dB | msssim {r.msssim_db:.2f} "
                  f"dB | bpp {r.bpp:.4f} | enc {r.enc_time * 1e3:.0f} ms | "
                  f"dec {r.dec_time * 1e3:.0f} ms")

    summary = {k: m.avg for k, m in meters.items()}
    summary["n_images"] = len(files)
    if verbose:
        print(f"average: psnr {summary['psnr']:.3f} dB | "
              f"msssim {summary['msssim_db']:.3f} dB | "
              f"bpp {summary['bpp']:.4f} | "
              f"enc {summary['enc_time'] * 1e3:.1f} ms | "
              f"dec {summary['dec_time'] * 1e3:.1f} ms")
    return summary
