"""Device ms an image in the lane coders (rans_lanes_*kernel), from the
trace."""

from harness import readers


def read(v, name):
    n, t = readers.images(v), None
    if n:
        t = readers.region_s(v, "rans_lanes_kernel")
    return None if t is None else 1e3 * t / n
