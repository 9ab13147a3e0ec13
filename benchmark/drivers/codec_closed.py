"""Closed-loop codec traffic: one caller codes a request (a batch of
`batch` images of height x width) with compress_device and then
decompress_interleaved, waits for x_hat, and sends the next. The requests
cycle over `distinct` batches of synthetic images drawn from the seed. A
request whose symbols do not fit the interleaved profile falls back to
the classic codec, as the program's own serving loop does, and is counted.

Quantities: img_per_s (images completed over the whole window),
request_ms_p95 / request_ms_p50 (every request of the window, from its
compress_device call to its x_hat synchronised). A traced run profiles
`trace_seconds` of the window from `trace_skip_s` on. After the window a
sample of `sample` finished requests, drawn from the seed, goes to the
judge (reference/codec_check.py).

Traffic file keys: batch, height, width, distinct, sample, trace_skip_s,
trace_seconds, work (the yardstick's statement of a request's model
work); "report" maps end-to-end metric names to the quantities above.
"""

from __future__ import annotations

import dataclasses
import gc
import heapq
import math
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from harness import corpus, core, program, trace, weights
from reference import codec_check


class Capture:
    """Keeps the decoder's own latent, indexes and symbols of the requests
    the sample holds: a pass-through around the model's decode function."""

    def __init__(self, model):
        self.armed = False
        self.last = None
        self._fn = model.decode_device_streams

        def decode_device_streams(*args, **kwargs):
            out = self._fn(*args, **kwargs)
            if self.armed:
                self.last = out
            return out

        model.decode_device_streams = decode_device_streams


def run(ctx: core.Context, device: str = "cuda") -> core.Result:
    from dcae_tpu_torch.entropy import rans
    from dcae_tpu_torch.models.codec import DCAECodec

    cell, tf = ctx.cell, ctx.cell.traffic
    cfg = program.model_config(cell.config)
    c = dataclasses.asdict(cfg)
    B, H, W = int(tf["batch"]), int(tf["height"]), int(tf["width"])
    n_distinct = int(tf["distinct"])
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    notes = []

    with ThreadPoolExecutor(max_workers=min(n_distinct, 6)) as pool:
        batches = list(pool.map(
            lambda r: corpus.synthetic_kodak(B, H, W, seed=ctx.subseed(1, r)),
            range(n_distinct)))
    state = weights.make(c, ctx.subseed(2), device)
    # drawn weights put many symbols outside the table rows, more on some
    # seeds than the program's default bound on a slice's patch list: a
    # bound of a slice's symbol count keeps every seed on the interleaved
    # profile, so the seed does not change the work
    cap = B * (H // cfg.y_downsample) * (W // cfg.y_downsample) \
        * cfg.slice_dim
    codec = DCAECodec(cfg, params=state, device=device, patch_cap=cap)
    del state
    codec.update()
    cap = Capture(codec.model)
    tracer = trace.Tracer(ctx.trace, float(tf.get("trace_skip_s", 1.0)),
                    float(tf.get("trace_seconds", 3.0)))
    fallbacks = [0]

    def serve(x, keep: bool):
        """One request: (enc or None, x_hat, ok)."""
        with tracer.span("encode"):
            try:
                enc = codec.compress_device(x)
            except rans.EscapeError:
                enc = None
        if enc is None:
            fallbacks[0] += 1
            with tracer.span("classic"):
                e = codec.compress(x)
                d = codec.decompress(e["strings"], e["shape"])
                sync()
            return None, d["x_hat"], True
        with tracer.span("decode"):
            cap.armed = keep
            dec = codec.decompress_interleaved(enc)
            cap.armed = False
            sync()
            ok = bool(dec["ok"])
        return enc, dec["x_hat"], ok

    # warm-up: every distinct request once, as the window sends it
    for r in range(n_distinct):
        serve(batches[r], False)
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # the sample: the `k` finished requests of highest priority, the
    # priorities drawn from the seed in request order
    k = int(tf["sample"])
    prio = np.random.default_rng(ctx.subseed(3))
    kept = []                                   # heap of (prio, r, item)
    lat, failed, attempted = [], 0, 0
    tracer.begin()
    t_start = time.perf_counter()
    ctx.mark_first_call(t_start)
    deadline = t_start + ctx.seconds
    r = 0
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        tracer.tick(t_start, sync)
        p = float(prio.random())
        keep = len(kept) < k or p > kept[0][0]
        x = batches[r % n_distinct]
        attempted += 1
        t0 = time.perf_counter()
        try:
            enc, x_hat, ok = serve(x, keep)
        except Exception as e:          # a request that raised has failed
            notes.append(f"request {r} raised {type(e).__name__}: {e}")
            enc, x_hat, ok = None, None, False
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        tracer.count(B)
        if not ok:
            failed += 1
        elif keep and enc is not None:
            item = {"r": r, "enc": enc, "x_hat": x_hat, "dec": cap.last}
            if len(kept) < k:
                heapq.heappush(kept, (p, r, item))
            else:
                heapq.heapreplace(kept, (p, r, item))
        cap.last = None
        r += 1
    t_end = time.perf_counter()
    tracer.stop(sync)
    if ctx.trace:
        notes.append(tracer.overhead_note())
    memory_peak = max(setup_peak, torch.cuda.max_memory_allocated()
                      if cuda else 0)
    done = attempted - failed
    window = t_end - t_start
    lat_ms = sorted(1e3 * v for v in lat)
    q = {"img_per_s": done * B / window,
         "request_ms_p95": _rank(lat_ms, 0.95),
         "request_ms_p50": _rank(lat_ms, 0.50)}
    notes.append(
        f"window {window:.3f} s, {attempted} requests of {B} image(s), "
        f"{failed} failed, {fallbacks[0]} coded classic; latency ms "
        f"p50 {q['request_ms_p50']:.3f} p95 {q['request_ms_p95']:.3f} "
        f"p99 {_rank(lat_ms, 0.99):.3f} max {lat_ms[-1]:.3f} "
        f"over {len(lat_ms)}")

    # the judge: outputs to the host, the program's state freed
    samples = []
    for _, rr, item in sorted(kept, key=lambda t: t[1]):
        y_hat, _, idxs, syms = item["dec"]
        samples.append({"x": batches[rr % n_distinct], "enc": item["enc"],
                        "y_hat": y_hat.cpu(), "idxs": idxs.cpu(),
                        "syms": syms.cpu(), "x_hat": item["x_hat"].cpu()})
    del kept, cap, codec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_j = time.perf_counter()
    checks, judged = [], False
    if samples:
        got = codec_check.judge(c, weights.make(c, ctx.subseed(2), device),
                                samples, device)
        judged = True
        limits = cell.limits["checks"]
        checks = [(n, got[n], float(limits[n])) for n in limits]
        notes.append(f"judged {got.pop('requests')} requests, "
                     f"{got.pop('images')} images, in "
                     f"{time.perf_counter() - t_j:.3f} s; readings {got}")
    else:
        notes.append("no finished interleaved request to judge")
    res = core.Result(
        attempted=attempted, failed=failed, quantities=q, checks=checks,
        memory_peak_bytes=memory_peak, device_count=1, notes=notes,
        judged=judged, trace=tracer.result,
        counts={"images": tracer.images, "requests": tracer.requests,
                "batch": B, "height": H, "width": W})
    return res


def _rank(sorted_ms, q: float) -> float:
    """The nearest-rank quantile of sorted values (nan when empty)."""
    if not sorted_ms:
        return math.nan
    return sorted_ms[min(len(sorted_ms) - 1,
                         max(0, math.ceil(q * len(sorted_ms)) - 1))]
