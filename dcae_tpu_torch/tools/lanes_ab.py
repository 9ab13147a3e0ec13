#!/usr/bin/env python3
"""Lane-count A/B of the interleaved profile, the JAX package's
tools/lanes_ab.py on the port: the K-lane state header is fixed in size,
so at trained (low) rates it weighs on bpp. Runs K values round-robin in
one process (compress_device, then decompress_interleaved, each lanes
checksum asserted) and reports for each K the median encode and decode
ms, synchronized with the card (utils/profiling.force_sync), and the
exact split of the rate into header (the lane states) and payload
(streams, patches, z).

    python -m dcae_tpu_torch.tools.lanes_ab [--batch 8] [--rounds 3] \
        [--ks 1024,512,256,128] [--ckpt ck] [--tiny] [--device cpu]

Runs on the CUDA device; --device cpu on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from dcae_tpu_torch.data.synthetic import synthetic_kodak


def accounting(enc: dict) -> tuple:
    """(header bytes, payload bytes) of a compress_device output: the lane
    states; the y streams, the patch lists (8 bytes an entry) and the z
    streams."""
    hdr = int(np.asarray(enc["states"]).nbytes)
    pay = (sum(len(s) for s in enc["istreams"])
           + sum(len(s) for s in enc["z_strings"])
           + sum(8 * len(p[0]) for p in enc["patches"]))
    return hdr, pay


def ab(codec, imgs, ks, rounds: int) -> dict:
    """Each K of ks once to warm up, then `rounds` rounds of every K in
    turn on imgs[r % len(imgs)]: {K: {enc_ms, dec_ms, bpp, hdr_bytes,
    payload_bytes, tax_pct}} (medians over the rounds; the rate of the
    last round's image). Raises when a decode's lanes checksum fails."""
    from dcae_tpu_torch.utils.profiling import force_sync

    px = imgs[0].shape[0] * imgs[0].shape[1] * imgs[0].shape[2]
    res = {k: {"enc": [], "dec": []} for k in ks}
    for k in ks:
        d = codec.decompress_interleaved(codec.compress_device(imgs[0],
                                                               lanes=k))
        force_sync(d["x_hat"])
        print(f"K={k} warm, ok={bool(d['ok'])}", flush=True)

    for r in range(rounds):
        for k in ks:
            im = imgs[r % len(imgs)]
            t0 = time.perf_counter()
            e = codec.compress_device(im, lanes=k)
            t1 = time.perf_counter()
            d = codec.decompress_interleaved(e)
            force_sync(d["x_hat"])
            t2 = time.perf_counter()
            if not bool(d["ok"]):
                raise RuntimeError(f"decode checksum failed at K={k}")
            res[k]["enc"].append(t1 - t0)
            res[k]["dec"].append(t2 - t1)
            res[k]["hdr"], res[k]["pay"] = accounting(e)
        print(f"round {r} done", flush=True)

    out = {}
    for k in ks:
        hdr, pay = res[k]["hdr"], res[k]["pay"]
        out[k] = {"enc_ms": 1000 * float(np.median(res[k]["enc"])),
                  "dec_ms": 1000 * float(np.median(res[k]["dec"])),
                  "bpp": (hdr + pay) * 8 / px, "hdr_bytes": hdr,
                  "payload_bytes": pay, "tax_pct": 100 * hdr / pay}
    return out


def print_table(out: dict) -> None:
    print(f"\n{'K':>5} {'enc_ms':>8} {'dec_ms':>8} {'bpp':>8} "
          f"{'hdr_B':>7} {'pay_B':>8} {'tax%':>6}")
    for k, r in out.items():
        print(f"{k:>5} {r['enc_ms']:8.1f} {r['dec_ms']:8.1f} "
              f"{r['bpp']:8.4f} {r['hdr_bytes']:7d} {r['payload_bytes']:8d} "
              f"{r['tax_pct']:6.2f}")
    print(json.dumps(out))


def main(argv=None) -> dict:
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.tools._cli import add_device_flag, load_codec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--ks", default="1024,512,256,128")
    ap.add_argument("--ckpt", default="",
                    help="trained checkpoint (default: seeded weights)")
    ap.add_argument("--tiny", action="store_true")
    add_device_flag(ap)
    a = ap.parse_args(argv)
    ks = [int(k) for k in a.ks.split(",")]

    cfg = (DCAEConfig.tiny(compute_dtype="bfloat16") if a.tiny
           else DCAEConfig(compute_dtype="bfloat16"))
    codec = load_codec(cfg, None if a.tiny else a.ckpt, a.device)
    try:
        imgs = [synthetic_kodak(a.batch, seed=s) for s in (100, 101)]
        out = ab(codec, imgs, ks, a.rounds)
    finally:
        codec.close()
    print_table(out)
    return out


if __name__ == "__main__":
    main()
