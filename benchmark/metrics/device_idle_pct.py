"""Share of the traced sub-window in which no kernel, copy or memset runs
on the device (rank 0's in a multi-card cell): one minus busy_s over
window_s, both from the profiler's timeline of that one interval.

The profiler slows the host and not the device's work, so where the host
sets the pace this share reads higher than the window's untraced
requests would show. That figure, the device's busy time a request over
the untraced time a request before the sub-window (two intervals), goes
on standard error as a note, not into the metric."""

from harness import readers, trace


def read(v, name):
    tr = v.result.trace
    if tr is None or trace.window_s(tr) <= 0:
        return None
    busy = trace.busy_s(tr)
    n, t = readers.per_request(v), readers.request_s(v)
    if n and t:
        v.result.notes.append(
            f"{name}: busy a request {1e3 * busy / n:.3f} ms against "
            f"{1e3 * t:.3f} ms a request untraced, idle "
            f"{100.0 * (1.0 - busy / n / t):.3f}% (two intervals)")
    return 100.0 * (1.0 - busy / trace.window_s(tr))
