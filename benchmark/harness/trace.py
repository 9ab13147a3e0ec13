"""The device trace of a traced run: torch.profiler over a steady
sub-window, recording the device's activity only (kernels, copies,
memsets; recording every host op would slow a host-bound loop several
fold), written as a Chrome trace and read back into kernel intervals.

The host side is timed by the host clock: the benchmark's own spans
(perf_counter around each call into the program) and the sub-window
itself, from one synchronise to the next. The two clocks are tied by a
marker: right after the synchronise that opens the sub-window, one
one-element fill is launched on the idle device, so the trace's first
device event starts one launch latency (some microseconds) after the
host read the clock.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Profile:
    """torch.profiler over start() .. stop(); the caller synchronises the
    device before each. stop() returns the parsed trace (parse), the host
    spans recorded in between moved onto the trace's clock."""

    def __init__(self):
        from torch.profiler import ProfilerActivity

        cuda = torch.cuda.is_available()
        self.prof = torch.profiler.profile(activities=[
            ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        self.spans: List[Tuple[str, float, float]] = []
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        self.prof.start()
        self.t0 = time.perf_counter()
        if torch.cuda.is_available():
            torch.empty(1, device="cuda").fill_(0.0)     # the clock marker

    def stop(self) -> Dict:
        self.t1 = time.perf_counter()
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.remove(path)
        return parse(doc, self.t0, self.t1, self.spans)


class Tracer:
    """Host spans and the profiled sub-window of a traced run; no-ops in
    an untraced one.

    The profiler slows the host (CUPTI hooks every launch, and stays
    attached once started), so a traced run keeps two records: the part
    of the window before the sub-window, untraced, with its host spans
    and its requests (`pre`), and the sub-window's device trace with its
    spans on the trace's clock. Host times a request come from the first,
    device times from the second."""

    def __init__(self, on: bool, skip_s: float, seconds: float):
        self.on, self.skip_s, self.seconds = on, skip_s, seconds
        self.prof = self.result = None
        self.images = 0
        self.requests = 0
        self.pre = {"seconds": 0.0, "images": 0, "requests": 0,
                    "spans": defaultdict(float)}

    def begin(self) -> None:
        """The window opens: what set-up's calls recorded is dropped."""
        self.pre["spans"].clear()

    @contextlib.contextmanager
    def _span(self, name):
        t = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if self.prof is not None:
                self.prof.spans.append((name, t, t1))
            elif self.result is None:
                self.pre["spans"][name] += t1 - t

    def span(self, name):
        return self._span(name) if self.on else contextlib.nullcontext()

    @property
    def active(self) -> bool:
        return self.prof is not None

    def tick(self, t_start: float, sync) -> None:
        """Between requests of the window opened at `t_start`: start the
        profile `skip_s` into it, stop it `seconds` after it started."""
        if not self.on or self.result is not None:
            return
        if self.prof is None and time.perf_counter() - t_start >= \
                self.skip_s:
            sync()
            self.pre["seconds"] = time.perf_counter() - t_start
            self.prof = Profile()
            self.prof.start()
        elif self.prof is not None and \
                time.perf_counter() - self.prof.t0 >= self.seconds:
            self.stop(sync)

    def stop(self, sync) -> None:
        if self.prof is not None and self.result is None:
            sync()
            self.result = self.prof.stop()
            self.result["pre"] = dict(self.pre, spans=dict(self.pre["spans"]))
            self.prof = None

    def count(self, images: int) -> None:
        """A request of `images` images has been sent (and, in a loop that
        waits for each, finished)."""
        if self.active:
            self.images += images
            self.requests += 1
        elif self.result is None:
            self.pre["images"] += images
            self.pre["requests"] += 1

    def overhead_note(self) -> str:
        """The traced sub-window's time a request against the untraced
        part of the window before it: what the profiler costs."""
        if self.result is None or not self.requests:
            return "profiler: no traced sub-window"
        inside = window_s(self.result) / self.requests
        n = self.pre["requests"]
        out = self.pre["seconds"] / n if n else float("nan")
        return (f"profiler: {1e3 * inside:.3f} ms a request in the traced "
                f"sub-window ({self.requests} requests), {1e3 * out:.3f} ms "
                f"before it, untraced ({n})")


def parse(doc: dict, t0: float, t1: float,
          host_spans: List[Tuple[str, float, float]]) -> Dict:
    """{"kernels": [(name, start_us, dur_us)], "spans": [(name, start_us,
    dur_us)], "window": (start_us, dur_us)}, all on the trace's clock:
    the window runs from the first device event (the marker) for the
    host's t1 - t0, and the device work is clipped to it."""
    kernels = [(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
               for e in doc.get("traceEvents", [])
               if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    lo = min((ts for _, ts, _ in kernels), default=0.0)
    off = lo - 1e6 * t0                  # trace us = host us + off
    window = (lo, 1e6 * (t1 - t0))
    hi = lo + window[1]
    clipped = []
    for name, ts, dur in kernels:
        a, b = max(ts, lo), min(ts + dur, hi)
        if b > a:
            clipped.append((name, a, b - a))
    spans = [(n, 1e6 * a + off, 1e6 * (b - a)) for n, a, b in host_spans]
    return {"kernels": clipped, "spans": spans, "window": window}


def busy_intervals(kernels: List[Tuple[str, float, float]]
                   ) -> List[Tuple[float, float]]:
    """The union of the device's busy intervals (start, end), in order."""
    iv = sorted((ts, ts + dur) for _, ts, dur in kernels)
    out: List[List[float]] = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(tr: Dict) -> float:
    return sum(b - a for a, b in busy_intervals(tr["kernels"])) / 1e6


def window_s(tr: Dict) -> float:
    return tr["window"][1] / 1e6


def breakdown(tr: Dict, top: int = 10) -> Dict:
    """The device ops that took the most time, and the idle gaps summed by
    the host span they fell in, each [name, seconds]."""
    by_op: Dict[str, float] = defaultdict(float)
    for name, _, dur in tr["kernels"]:
        by_op[name] += dur / 1e6
    lo, hi = tr["window"][0], tr["window"][0] + tr["window"][1]
    busy = busy_intervals(tr["kernels"])
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    spans = sorted(tr["spans"], key=lambda s: s[1])
    by_span: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label = "outside spans"
        for name, ts, dur in spans:
            if ts <= mid <= ts + dur:
                label = name       # the innermost span that holds it
        by_span[label] += (b - a) / 1e6
    pick = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": pick(by_op), "idle_gaps": pick(by_span)}
