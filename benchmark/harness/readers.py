"""What the per-layer readers share: device time by kernel region in the
traced sub-window, host times from the untraced part of the window
before it (the profiler slows the host), and the least times of the
yardstick."""

from __future__ import annotations

from typing import Optional

from harness import yardstick


def per_request(v) -> Optional[int]:
    """Requests (batches or steps) completed inside the traced window."""
    if v.result.trace is None:
        return None
    n = v.result.counts.get("requests", 0)
    return n or None


def images(v) -> Optional[int]:
    if v.result.trace is None:
        return None
    n = v.result.counts.get("images", 0)
    return n or None


def region_s(v, region: str) -> Optional[float]:
    """Device seconds of the kernels of one region in the traced window;
    None when none ran."""
    ks = [d for name, _, d in v.result.trace["kernels"]
          if yardstick.region(name) == region]
    return sum(ks) / 1e6 if ks else None


def pre(v) -> Optional[dict]:
    """The untraced part of a traced run's window before the profiled
    sub-window: {"seconds", "images", "requests", "spans": {name: s}}."""
    tr = v.result.trace
    p = tr.get("pre") if tr is not None else None
    return p if p and p["requests"] else None


def pre_span_ms_per_image(v, name: str) -> Optional[float]:
    """Host ms an image in one span, untraced."""
    p = pre(v)
    if p is None or name not in p["spans"] or not p["images"]:
        return None
    return 1e3 * p["spans"][name] / p["images"]


def request_s(v) -> Optional[float]:
    """Seconds a request (or step) takes untraced, in the same run."""
    p = pre(v)
    return None if p is None else p["seconds"] / p["requests"]


def work(v) -> dict:
    """The traffic's statement of one request's model work."""
    return v.cell.traffic["work"]


def shapes(v):
    """(batch, height, width) of one device's share of a request."""
    c = v.result.counts
    return int(c["batch"]), int(c["height"]), int(c["width"])


def model_config(v) -> dict:
    """The configuration's widths, as its file states them."""
    return v.cell.config["model"]


def kernel_roofline_pct(v, layer: str, region: str) -> Optional[float]:
    """Least time of one layer's launches (yardstick.stack_launches) over
    the device time of its kernels, in %; None when they did not run."""
    n = per_request(v)
    t = region_s(v, region) if n else None
    if t is None:
        return None
    w = work(v)
    B, H, W = shapes(v)
    launches = yardstick.stack_launches(
        model_config(v), B, H, W, v.cell.config["dtypes"]["transforms"],
        int(w["entropy_passes"]))
    least = sum(yardstick.least_time(f, b, d) for f, b, d in launches[layer])
    return 100.0 * least * n / t
