"""Device ms a step in NCCL's kernels (the gradient all-reduce) on rank 0,
from the trace."""

from harness import readers


def read(v, name):
    n, t = readers.per_request(v), None
    if n:
        t = readers.region_s(v, "nccl")
    return None if t is None else 1e3 * t / n
