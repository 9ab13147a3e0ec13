"""max_memory_allocated over the window, after reset_peak_memory_stats at
its start, in GiB (rank 0 in a multi-card cell)."""


def read(v, name):
    b = v.result.counts.get("window_peak_bytes")
    return None if not b else b / 2 ** 30
