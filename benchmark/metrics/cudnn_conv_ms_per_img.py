"""Device ms an image in cuDNN's convolutions and the layout transposes
around them, from the trace (yardstick.REGIONS)."""

from harness import readers


def read(v, name):
    n, t = readers.images(v), None
    if n:
        t = readers.region_s(v, "conv_cudnn")
    return None if t is None else 1e3 * t / n
