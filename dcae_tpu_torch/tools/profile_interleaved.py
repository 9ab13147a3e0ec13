#!/usr/bin/env python3
"""Device-time budget of the interleaved codec by region, the JAX
package's tools/profile_interleaved.py on the port: torch.profiler over
compress_device and decompress_interleaved (utils/profiling.trace /
op_stats), each kernel's device time bucketed into the regions below by
its name.

    python -m dcae_tpu_torch.tools.profile_interleaved [--batch 8] \
        [--tiny] [--ckpt ck] [--stage encode|decode|both] [--device cpu]

Prints the device ms a call, the ms by region and by op type, and the
longest ops; DCAE_PROFILE_DUMP=<file> writes the whole op table there.
On the CPU the trace holds no device kernel and the host ops' self times
stand in (a CPU run measures the CPU, not the card).
"""

from __future__ import annotations

import argparse
import os
import re
import tempfile

from dcae_tpu_torch.data.synthetic import synthetic_kodak

# in order, first match wins. The hand kernels by their __global__ names
# (csrc/*.cu); cuDNN's convolutions (implicit GEMMs and the layout
# transposes around them) before cuBLAS's GEMMs, whose names they share;
# then PyTorch's elementwise, reduction, normalization and copy kernels.
REGIONS = (
    ("wmsa_kernel", re.compile(r"wmsa_(mma|tf32|pack|tf32_pack)_kernel")),
    ("conv_glu_kernel", re.compile(r"conv_glu_\w*kernel")),
    ("rans_lanes_kernel", re.compile(r"rans_lanes_\w*kernel")),
    ("conv_cudnn", re.compile(
        r"fprop|dgrad|wgrad|convolve|cudnn|conv2d|convolution|depthwise|"
        r"nchwToNhwc|nhwcToNchw", re.I)),
    ("gemm_cublas", re.compile(r"gemm|gemv|cutlass|cublas|addmm|\bmm\b|"
                               r"bmm|matmul|linear", re.I)),
    ("elementwise_copy", re.compile(
        r"elementwise|reduce|norm|softmax|memcpy|memset|copy|cat|index|"
        r"gather|scatter|fill|where|clamp|round|arange|scan|sort|pad|roll|"
        r"aten::", re.I)),
)


def bucket(op_name: str) -> str:
    for name, rx in REGIONS:
        if rx.search(op_name):
            return name
    return "other"


def profile_fn(label, fn, n_iters: int = 2, dump=None) -> dict:
    """fn once to warm up, then n_iters calls under the profiler; prints
    and returns op_stats with the regions as groups."""
    from dcae_tpu_torch.utils.profiling import op_stats, trace

    with tempfile.TemporaryDirectory() as d:
        fn()
        with trace(d):
            for _ in range(n_iters):
                fn()
        s = op_stats(d, group_fn=bucket, keep_rows=dump is not None)
    if dump:
        with open(dump, "w") as f:
            for ms, occ, typ, op in s.pop("rows"):
                f.write(f"{ms:.3f}\t{occ}\t{typ}\t{op}\n")
        print(f"full op table -> {dump}")
    print(f"\n=== {label}: total device {s['total_ms'] / n_iters:.3f} ms "
          f"per call ({n_iters} calls traced) ===")
    print("by region (ms/call):")
    for k, v in sorted(s["by_group"].items(), key=lambda kv: -kv[1]):
        print(f"  {k:18s} {v / n_iters:8.3f}")
    print("by op type (ms/call, top 12):")
    for k, v in sorted(s["by_type"].items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {k:28s} {v / n_iters:8.3f}")
    print("top ops (ms total over trace | occurrences | type | name):")
    for ms, occ, typ, op in s["top"][:20]:
        print(f"  {ms:8.3f} {occ:5d}  {typ:24s} {op[:90]}")
    s["n_iters"] = n_iters
    return s


def profile(codec, batch: int, stage: str = "both") -> dict:
    """{stage: op_stats} of compress_device and / or decompress_interleaved
    on `batch` structured 768x512 images, two inputs in turn."""
    from dcae_tpu_torch.utils.profiling import force_sync

    seq = [synthetic_kodak(batch), synthetic_kodak(batch, seed=101)]
    out = {}
    if stage in ("encode", "both"):
        i = [0]

        def run_enc():
            i[0] ^= 1
            codec.compress_device(seq[i[0]])

        out["encode"] = profile_fn(
            "compress_device (analysis + replay + lane encode)", run_enc)

    if stage in ("decode", "both"):
        encs = [codec.compress_device(im) for im in seq]
        j = [0]

        def run_dec():
            j[0] ^= 1
            force_sync(codec.decompress_interleaved(encs[j[0]])["x_hat"])

        out["decode"] = profile_fn(
            "decompress_interleaved (lane decode + synthesis)", run_dec,
            dump=os.environ.get("DCAE_PROFILE_DUMP"))
    return out


def main(argv=None) -> dict:
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.tools._cli import add_device_flag, load_codec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt", default="",
                    help="trained checkpoint (default: seeded weights)")
    ap.add_argument("--stage", default="both",
                    choices=["encode", "decode", "both"])
    add_device_flag(ap)
    a = ap.parse_args(argv)

    cfg = (DCAEConfig.tiny(compute_dtype="bfloat16") if a.tiny
           else DCAEConfig(compute_dtype="bfloat16"))
    codec = load_codec(cfg, None if a.tiny else a.ckpt, a.device)
    try:
        return profile(codec, a.batch, a.stage)
    finally:
        codec.close()


if __name__ == "__main__":
    main()
