#!/usr/bin/env python3
"""Bitstream receive server of the PyTorch port: the JAX package's
tools/server.py (accept loop, name|size header, ACK, chunked receive into
./output/binary/bin/received_*), with --decode decoding every payload on
arrival: a classic .bin through decompress, a DTI1 / DTI2 container
through decompress_interleaved, each written as a PNG.

    python -m dcae_tpu_torch.tools.server --port 8888 --decode

Decodes on the CUDA device; --device cpu on the CPU.
"""

import argparse
import os

from dcae_tpu_torch.ops.layers import crop_spatial
from dcae_tpu_torch.runtime.container import (is_interleaved_bin,
                                              unpack_bin,
                                              unpack_bin_interleaved)
from dcae_tpu_torch.runtime.service import BitstreamServer
from dcae_tpu_torch.tools._cli import (add_device_flag, config, load_codec,
                                       save_png)


def payload_decoder(codec, out_dir: str, on_decoded=None):
    """on_payload(name, data) for a BitstreamServer: decode one payload
    with `codec` and write <out_dir>/<name>.png; on_decoded(name, x_hat),
    when given, gets the cropped (1, h, w, 3) decode on the codec's device
    first. The server calls it on its accept thread, one payload at a
    time."""
    cfg = codec.cfg

    def on_payload(name: str, data: bytes) -> None:
        if is_interleaved_bin(data):     # the device-coding profile
            enc, padding, _ = unpack_bin_interleaved(
                data, cfg.pad_multiple, cfg.z_downsample)
            dec = codec.decompress_interleaved(enc)
            if not bool(dec["ok"]):
                raise ValueError(f"{name}: lanes checksum failed")
        else:
            strings, z_shape, padding, _ = unpack_bin(
                data, cfg.pad_multiple, cfg.z_downsample)
            dec = codec.decompress(strings, z_shape)
        x_hat = crop_spatial(dec["x_hat"], padding)
        if on_decoded is not None:
            on_decoded(name, x_hat)
        out = os.path.join(out_dir, os.path.splitext(name)[0] + ".png")
        save_png(x_hat[0], out)
        print(f"decoded {name} -> {out}", flush=True)

    return on_payload


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--port", type=int, default=8888)
    p.add_argument("--out", type=str, default="./output/binary/bin")
    p.add_argument("--decode", action="store_true",
                   help="decode received payloads to png on arrival")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--tiny", action="store_true")
    add_device_flag(p, help_="device of the --decode codec:")
    a = p.parse_args(argv)

    on_payload = None
    if a.decode:
        # built (and cuDNN made deterministic) before the accept loop
        codec = load_codec(config(a.tiny), a.checkpoint, a.device)
        on_payload = payload_decoder(codec, a.out)

    server = BitstreamServer(a.port, a.out, on_payload)
    print(f"listening on :{a.port}", flush=True)
    server.start()


if __name__ == "__main__":
    main()
