#!/usr/bin/env python3
"""Edge-encode client of the PyTorch port, the JAX package's
tools/client.py: compress each image of --data (classic format, padded to
the model's multiple), pack it as a .bin and ship it to a receiver over
the name|size + ACK TCP protocol.

    python -m dcae_tpu_torch.tools.client --data <image dir> --port 8888

Compresses on the CUDA device; --device cpu on the CPU.
"""

import argparse
import os

from dcae_tpu_torch.data.datasets import list_images, load_image
from dcae_tpu_torch.ops.layers import pad_spatial
from dcae_tpu_torch.runtime.container import pack_bin
from dcae_tpu_torch.runtime.service import send_bytes
from dcae_tpu_torch.tools._cli import add_device_flag, config, load_codec


def encode_image(codec, path: str) -> tuple:
    """(name, payload): the image at `path` as a classic .bin."""
    x = codec._input(load_image(path)[None])
    h, w = x.shape[1:3]
    padded, _ = pad_spatial(x, codec.cfg.pad_multiple)
    enc = codec.compress(padded)
    name = os.path.splitext(os.path.basename(path))[0] + ".bin"
    return name, pack_bin(enc["strings"], (h, w))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--host", type=str, default="localhost")
    p.add_argument("--port", type=int, default=8888)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--tiny", action="store_true")
    add_device_flag(p)
    a = p.parse_args(argv)

    codec = load_codec(config(a.tiny), a.checkpoint, a.device)
    try:
        for path in list_images(a.data):
            name, payload = encode_image(codec, path)
            print(f"sending {name} ({len(payload)} bytes) "
                  f"-> {a.host}:{a.port}", flush=True)
            send_bytes(name, payload, a.host, a.port)
    finally:
        codec.close()


if __name__ == "__main__":
    main()
