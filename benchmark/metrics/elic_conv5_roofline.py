"""Share of their least time that the 5x5 launches of the hand
convolution kernel (conv2d_nhwc_k5_tf32x3_kernel: ELIC's channel and
masked spatial contexts) take on the device: their work counted from the
shapes (elic_yardstick.conv5_launches, 3xTF32 at the card's TF32 peak)
over the device time of that kernel; None where it did not run."""

import re

from harness import elic_yardstick, readers

KERNEL = re.compile(r"conv2d_nhwc_k5_\w*kernel")


def read(v, name):
    n = readers.per_request(v)
    if not n:
        return None
    ks = [d for k, _, d in v.result.trace["kernels"] if KERNEL.search(k)]
    if not ks:
        return None
    w = readers.work(v)
    B, H, W = readers.shapes(v)
    launches = elic_yardstick.conv5_launches(
        readers.model_config(v), B, H, W, int(w["entropy_passes"]))
    least = sum(elic_yardstick.least_time(f, b) for f, b in launches)
    return 100.0 * least * n / (sum(ks) / 1e6)
