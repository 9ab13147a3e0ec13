#!/usr/bin/env python3
"""bpp, size and compression ratio over a directory of .bin files (the
classic container; DTI1 / DTI2 and DLT1 files are counted whole).

    python -m dcae_tpu_torch.tools.cal_bin --data <.bin dir>
"""

import argparse
import os
import struct

from dcae_tpu_torch.runtime import container


def summarize(path: str) -> dict:
    """{h, w, bytes, y, z, bpp, ratio} of one file; y / z are the stream
    lengths of a classic .bin, None for the other formats."""
    with open(path, "rb") as f:
        raw = f.read()
    y_len = z_len = None
    if container.is_latent_bin(raw) or container.is_interleaved_bin(raw):
        h, w = struct.unpack(">HH", raw[4:8])
    else:
        strings, _, _, (h, w) = container.unpack_bin(raw)
        y_len, z_len = len(strings[0][0]), len(strings[1][0])
    n = len(raw)
    return {"h": h, "w": w, "bytes": n, "y": y_len, "z": z_len,
            "bpp": n * 8 / (h * w), "ratio": h * w * 3 / n}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", type=str, required=True, help=".bin directory")
    a = p.parse_args(argv)

    bins = [f for f in sorted(os.listdir(a.data)) if f.endswith(".bin")]
    if not bins:
        print(f"no .bin files under {a.data}")
        return
    rows = []
    for name in bins:
        r = summarize(os.path.join(a.data, name))
        rows.append(r)
        parts = (f" (y {r['y']}, z {r['z']})" if r["y"] is not None
                 else "")
        print(f"{name}: {r['h']}x{r['w']} | {r['bytes']} B{parts} | "
              f"bpp {r['bpp']:.4f} | ratio {r['ratio']:.1f}x")
    n = len(rows)
    print(f"average over {n}: bpp {sum(r['bpp'] for r in rows) / n:.4f} | "
          f"ratio {sum(r['ratio'] for r in rows) / n:.1f}x")


if __name__ == "__main__":
    main()
