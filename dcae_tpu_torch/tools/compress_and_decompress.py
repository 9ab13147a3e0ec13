#!/usr/bin/env python3
"""Bitstream codec CLI of the PyTorch port: compress a directory of images
to .bin files (pad to the model's multiple, the reference's container), or
decompress .bin files back to PNGs.

    python -m dcae_tpu_torch.tools.compress_and_decompress --mode compress \
        --data <image dir> --save_path out [--interleaved | --latent int8]
    python -m dcae_tpu_torch.tools.compress_and_decompress \
        --mode decompress --data out/bin --save_path out

--interleaved writes the device-coding profile's DTI2 container (a classic
.bin when a symbol escapes the coding tables); --latent [dtype] writes the
raw latent as a DLT1 container. Decompress tells the three formats apart by
their magic. Files are those of the JAX package's CLI, byte for byte, on
the same weights. Runs on the CUDA device; --device cpu on the CPU.
"""

import argparse
import os

import torch

from dcae_tpu_torch.data.datasets import list_images, load_image
from dcae_tpu_torch.entropy.rans import EscapeError
from dcae_tpu_torch.ops.layers import crop_spatial, pad_spatial
from dcae_tpu_torch.runtime import container
from dcae_tpu_torch.tools._cli import (add_device_flag, config, load_codec,
                                       save_png)


def _write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def compress_dir(codec, data: str, save_path: str, interleaved: bool = False,
                 latent_dtype: str = None) -> None:
    bin_dir = os.path.join(save_path, "bin")
    os.makedirs(bin_dir, exist_ok=True)
    for path in list_images(data):
        x = codec._input(load_image(path)[None])
        h, w = x.shape[1:3]
        padded, _ = pad_spatial(x, codec.cfg.pad_multiple)
        name = os.path.splitext(os.path.basename(path))[0] + ".bin"
        out = os.path.join(bin_dir, name)
        if latent_dtype:
            blob = container.pack_latent(codec.compress_latent(padded),
                                         (h, w), dtype=latent_dtype)
            _write(out, blob)
            print(f"{path} -> {name} ({len(blob)} bytes, DLT1 "
                  f"{latent_dtype})")
            continue
        if interleaved:
            try:
                blob = container.pack_bin_interleaved(
                    codec.compress_device(padded), (h, w))
                _write(out, blob)
                print(f"{path} -> {name} ({len(blob)} bytes, "
                      f"{blob[:4].decode()})")
                continue
            except EscapeError:
                print(f"{path}: escape symbol; writing a classic .bin")
        enc = codec.compress(padded)
        container.save_bin(out, enc["strings"], (h, w))
        print(f"{path} -> {name} "
              f"({sum(len(s) for g in enc['strings'] for s in g)} bytes)")


def decode_blob(codec, raw: bytes, name: str = "") -> torch.Tensor:
    """Decode one container of any of the three formats -> the cropped
    x_hat (1, h, w, 3) on the codec's device."""
    cfg = codec.cfg
    if container.is_latent_bin(raw):
        y, padding, _ = container.unpack_latent(raw, cfg.pad_multiple)
        dec = codec.decompress_latent(y)
    elif container.is_interleaved_bin(raw):
        enc, padding, _ = container.unpack_bin_interleaved(
            raw, cfg.pad_multiple, cfg.z_downsample)
        dec = codec.decompress_interleaved(enc)
        if not bool(dec["ok"]):
            raise ValueError(f"{name}: lanes checksum failed (corrupt "
                             "stream or table mismatch)")
    else:
        strings, z_shape, padding, _ = container.unpack_bin(
            raw, cfg.pad_multiple, cfg.z_downsample)
        dec = codec.decompress(strings, z_shape)
    return crop_spatial(dec["x_hat"], padding)


def decompress_dir(codec, data: str, save_path: str) -> None:
    png_dir = os.path.join(save_path, "png")
    os.makedirs(png_dir, exist_ok=True)
    for name in sorted(f for f in os.listdir(data) if f.endswith(".bin")):
        with open(os.path.join(data, name), "rb") as f:
            x_hat = decode_blob(codec, f.read(), name)
        out = os.path.join(png_dir, os.path.splitext(name)[0] + ".png")
        save_png(x_hat[0], out)
        print(f"{name} -> {out}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=["compress", "decompress"],
                   required=True)
    p.add_argument("--data", type=str, required=True,
                   help="image dir (compress) or .bin dir (decompress)")
    p.add_argument("--save_path", type=str, default="./output")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="a checkpoint of this package (parameters and, "
                        "beside it, the baked tables)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--interleaved", action="store_true",
                   help="write the device-coding profile (DTI2); "
                        "decompress detects every format")
    p.add_argument("--latent", nargs="?", const="float32", default=None,
                   dest="latent_dtype", metavar="DTYPE",
                   choices=["float32", "float16", "bfloat16", "int8"],
                   help="write the raw latent (DLT1) in DTYPE instead of a "
                        "coded stream; int8 is max-abs scaled")
    add_device_flag(p)
    a = p.parse_args(argv)

    codec = load_codec(config(a.tiny), a.checkpoint, a.device)
    try:
        if a.mode == "compress":
            compress_dir(codec, a.data, a.save_path,
                         interleaved=a.interleaved,
                         latent_dtype=a.latent_dtype)
        else:
            decompress_dir(codec, a.data, a.save_path)
    finally:
        codec.close()


if __name__ == "__main__":
    main()
