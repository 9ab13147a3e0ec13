#!/usr/bin/env python3
"""Evaluation CLI of the PyTorch port: PSNR, MS-SSIM (dB), bpp and encode /
decode time over a directory of images.

    python -m dcae_tpu_torch.tools.eval --data <dir> [--real]
        [--profile classic|interleaved] [--checkpoint ck]
    python -m dcae_tpu_torch.tools.eval --data <dir> --mode compress \
        --save_path enc/      (then --mode decompress: two-phase eval)
    python -m dcae_tpu_torch.tools.eval --data <dir> --mode size_analysis
    python -m dcae_tpu_torch.tools.eval --data <dir> --real \
        --device_encoder cpu --device_decoder cuda [--ship_indexes]

With --device_encoder / --device_decoder the codec is split: an encoder
half on one device and a decoder half on the other (CrossDeviceCodec).
Runs on the CUDA device; --device cpu on the CPU.
"""

import argparse
import json
import os
import pickle

import numpy as np
import torch

from dcae_tpu_torch.data.datasets import list_images, load_image
from dcae_tpu_torch.eval_lib import eval_directory
from dcae_tpu_torch.models.codec import DCAECodec
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.models.split import compress_params, decompress_params
from dcae_tpu_torch.ops.layers import crop_spatial, pad_spatial
from dcae_tpu_torch.tools._cli import add_device_flag, config, load_codec
from dcae_tpu_torch.utils.checkpoint import load_params_only, load_tables
from dcae_tpu_torch.utils.metrics import psnr, real_bpp


class CrossDeviceCodec:
    """An encoder half on one device and a decoder half on another, driven
    as one codec: compress on the encoder's device, decompress on the
    decoder's. Both code under the encoder's tables and scale table.

    The decoder computes its coding indexes again on its own device; a
    device whose convolutions round differently may reach another index
    at a table boundary, and the stream then decodes wrong. ship_indexes
    makes the encoder ship its indexes with the streams
    (compress_with_indexes): the decoder then computes none, and the
    decode is exact on any pair of devices."""

    def __init__(self, enc: DCAECodec, dec: DCAECodec,
                 ship_indexes: bool = False):
        self.enc, self.dec = enc, dec
        self.cfg = enc.cfg
        self.ship = ship_indexes
        self._indexes = None

    @property
    def device(self) -> torch.device:
        return self.enc.device

    @property
    def devices(self) -> tuple:
        return (self.enc.device, self.dec.device)

    def _input(self, x) -> torch.Tensor:
        return self.enc._input(x)

    def update(self, *a, **k) -> bool:
        changed = self.enc.update(*a, **k)
        self.dec.tables = self.enc.tables
        self.dec._scale_table = self.enc._scale_table.to(self.dec.device)
        return changed

    @torch.no_grad()
    def forward(self, x) -> dict:
        """The eval-mode forward, split: encode_half on the encoder's
        device, decode_half on the decoder's."""
        y, z_hat, z_like = self.enc.model.encode_half(self.enc._input(x))
        dev = self.dec.device
        x_hat, y_like, means, scales, y_hat = self.dec.model.decode_half(
            y.to(dev), z_hat.to(dev))
        return {"x_hat": x_hat,
                "likelihoods": {"y": y_like, "z": z_like.to(dev)},
                "para": {"means": means, "scales": scales, "y": y.to(dev),
                         "y_hat": y_hat, "z_hat": z_hat.to(dev)}}

    def compress(self, x) -> dict:
        if self.ship:
            out = self.enc.compress_with_indexes(x)
            self._indexes = out.pop("indexes")
            return out
        return self.enc.compress(x)

    def decompress(self, strings, shape, **kw) -> dict:
        idx, self._indexes = self._indexes, None
        return self.dec.decompress(strings, shape, indexes=idx, **kw)

    def analyze_sizes(self, x) -> dict:
        """The encoder half's size analysis (model_params: what the
        encoder machine holds) and the decoder half's parameter count."""
        out = self.enc.analyze_sizes(x)
        n = sum(p.numel() for p in self.dec.model.parameters())
        out["decoder_model_params"] = n
        out["decoder_model_bytes_f32"] = n * 4
        return out

    def close(self) -> None:
        self.enc.close()
        self.dec.close()


def cross_device_codec(cfg, checkpoint, enc_device, dec_device,
                       ship_indexes: bool, seed: int = 0) -> CrossDeviceCodec:
    """Halves of the checkpoint's parameters (a seeded random init without
    one) on their devices, the decoder on the encoder's tables."""
    if checkpoint:
        params, tables = load_params_only(checkpoint), load_tables(checkpoint)
    else:
        model = DCAE(cfg)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        params, tables = model.state_dict(), None
    enc = DCAECodec(cfg, params=compress_params(params), tables=tables,
                    device=enc_device)
    dec = DCAECodec(cfg, params=decompress_params(params), tables=tables,
                    device=dec_device)
    codec = CrossDeviceCodec(enc, dec, ship_indexes=ship_indexes)
    codec.update()
    return codec


def two_phase(codec, a) -> None:
    """--mode compress pickles each image's whole encoder output (strings,
    shape, the original size and padding, and with --ship_indexes the
    indexes) to save_path; --mode decompress reloads them, decodes, and
    reports PSNR and bpp against the originals."""
    files = list_images(a.data)[:a.limit] if a.limit else list_images(a.data)
    os.makedirs(a.save_path, exist_ok=True)
    if a.mode == "compress":
        for path in files:
            x = codec._input(load_image(path)[None])
            padded, padding = pad_spatial(x, codec.cfg.pad_multiple)
            out_enc = codec.compress(padded)
            if getattr(codec, "_indexes", None) is not None:
                out_enc["indexes"], codec._indexes = codec._indexes, None
            out_enc["size"] = (x.shape[1], x.shape[2])
            out_enc["padding"] = padding
            name = os.path.splitext(os.path.basename(path))[0]
            with open(os.path.join(a.save_path, name + ".pkl"), "wb") as f:
                pickle.dump(out_enc, f)
            print(f"{path}: "
                  f"{real_bpp(out_enc['strings'], x.shape[1] * x.shape[2]):.4f}"
                  " bpp")
        return
    bpps, psnrs = [], []
    for path in files:
        name = os.path.splitext(os.path.basename(path))[0]
        pkl = os.path.join(a.save_path, name + ".pkl")
        if not os.path.exists(pkl):
            continue
        with open(pkl, "rb") as f:
            out_enc = pickle.load(f)
        x = load_image(path)[None]
        if isinstance(codec, CrossDeviceCodec):
            codec._indexes = out_enc.get("indexes")
            dec = codec.decompress(out_enc["strings"], out_enc["shape"])
        else:
            dec = codec.decompress(out_enc["strings"], out_enc["shape"],
                                   indexes=out_enc.get("indexes"))
        x_hat = crop_spatial(dec["x_hat"], out_enc["padding"]).cpu()
        p_ = float(psnr(torch.from_numpy(x), x_hat))
        b_ = real_bpp(out_enc["strings"], x.shape[1] * x.shape[2])
        bpps.append(b_)
        psnrs.append(p_)
        print(f"{path}: psnr {p_:.2f} dB | bpp {b_:.4f}")
    if not bpps:
        raise SystemExit(f"no encoded .pkl payloads in {a.save_path} for "
                         f"{len(files)} images: run --mode compress first")
    print(f"average: psnr {np.mean(psnrs):.3f} dB | bpp {np.mean(bpps):.4f} "
          f"over {len(bpps)} images")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--real", action="store_true",
                   help="entropy-coded round trip (default: forward only)")
    p.add_argument("--mode", type=str, default="both",
                   choices=["both", "size_analysis", "compress",
                            "decompress"],
                   help="size_analysis: payload and model bytes; compress / "
                        "decompress: the two-phase eval")
    p.add_argument("--save_path", type=str, default="./eval_out",
                   help="encoder-output pickles of the two-phase modes")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--bd_dataset", type=str, default=None,
                   choices=["Kodak", "CLIC", "Tecnick", "Kodak-msssim"],
                   help="print the golden RD curve for comparison")
    p.add_argument("--profile", choices=["classic", "interleaved"],
                   default="classic",
                   help="interleaved: the device-coding profile (real mode); "
                        "bpp counts the whole DTI payload")
    add_device_flag(p)
    p.add_argument("--device_encoder", type=str, default=None,
                   help="split the codec: the encoder half's device")
    p.add_argument("--device_decoder", type=str, default=None,
                   help="split the codec: the decoder half's device")
    p.add_argument("--ship_indexes", action="store_true",
                   help="split codec: the encoder ships its coding indexes, "
                        "so the decode is exact on any pair of devices")
    a = p.parse_args(argv)

    cfg = config(a.tiny)
    if a.device_encoder or a.device_decoder:
        codec = cross_device_codec(cfg, a.checkpoint,
                                   a.device_encoder or a.device,
                                   a.device_decoder or a.device,
                                   a.ship_indexes)
    else:
        codec = load_codec(cfg, a.checkpoint, a.device)
    try:
        if a.mode == "size_analysis":
            x = load_image(list_images(a.data)[0])[None]
            padded, _ = pad_spatial(torch.from_numpy(x), cfg.pad_multiple)
            print(json.dumps(codec.analyze_sizes(padded.numpy()), indent=2))
            return
        if a.mode in ("compress", "decompress"):
            two_phase(codec, a)
            return
        summary = eval_directory(codec, a.data, real=a.real, limit=a.limit,
                                 profile=a.profile)
        if a.bd_dataset:
            from dcae_tpu_torch.data.rd_reference import REFERENCE_RD
            golden = REFERENCE_RD[a.bd_dataset]
            q = "psnr" if "psnr" in golden else "msssim_db"
            print(f"golden {a.bd_dataset} RD (6 lambdas): bpp "
                  f"{golden['bpp']} / {q} {golden[q]}")
            print(f"this checkpoint: bpp {summary['bpp']:.4f} psnr "
                  f"{summary['psnr']:.3f} dB; the BD-rate needs all 6 "
                  "lambdas' checkpoints: dcae_tpu_torch.data.rd_reference."
                  "compare_to_reference")
    finally:
        codec.close()


if __name__ == "__main__":
    main()
