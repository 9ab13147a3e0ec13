#!/usr/bin/env python3
"""Host <-> card link microbenchmark, the JAX package's tools/bench_link.py
on the port: dispatch latency and transfer bandwidth.

The codec's wall-clock model prices every classic decode slice at one
round trip and the encode hand-off at one fetch; this measures what those
cost on this host's link: a trivial kernel then torch.cuda.synchronize, a
tiny result fetched to the host, and host-to-card / card-to-host copies of
1, 8 and 32 MB from pageable and from pinned host memory. Every
card-to-host copy fetches a freshly computed tensor. Best of `reps`.

    python -m dcae_tpu_torch.tools.bench_link [reps]

Prints one JSON line. Needs a card.
"""

from __future__ import annotations

import json
import sys
import time


def _best(fn, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _row(mb: int, h2d: float, d2h: float) -> dict:
    return {"h2d_ms": 1000 * h2d, "d2h_ms": 1000 * d2h,
            "h2d_MBps": mb / h2d, "d2h_MBps": mb / d2h}


def bench(reps: int = 5) -> dict:
    import torch

    from dcae_tpu_torch.tools._cli import require_card

    require_card("bench_link")
    dev = torch.device("cuda", torch.cuda.current_device())
    tiny = torch.zeros(8, device=dev)
    torch.cuda.synchronize()

    def dispatch_sync():
        tiny.add(1)
        torch.cuda.synchronize()

    lat = _best(dispatch_sync, reps)
    tiny_get = _best(lambda: tiny.add(1).cpu(), reps)

    pageable, pinned = {}, {}
    for mb in (1, 8, 32):
        n = mb * (1 << 20)
        host = torch.zeros(n, dtype=torch.uint8)
        host_pin = torch.zeros(n, dtype=torch.uint8).pin_memory()
        back_pin = torch.empty(n, dtype=torch.uint8).pin_memory()
        on_card = host.to(dev)

        def h2d(src):
            src.to(dev, non_blocking=src.is_pinned())
            torch.cuda.synchronize()

        def d2h_pinned():
            back_pin.copy_(on_card.add(1), non_blocking=True)
            torch.cuda.synchronize()

        pageable[f"{mb}MB"] = _row(mb, _best(lambda: h2d(host), reps),
                                   _best(lambda: on_card.add(1).cpu(), reps))
        pinned[f"{mb}MB"] = _row(mb, _best(lambda: h2d(host_pin), reps),
                                 _best(d2h_pinned, reps))
    return {"device": torch.cuda.get_device_name(dev),
            "dispatch_sync_ms": 1000 * lat,
            "tiny_device_get_ms": 1000 * tiny_get,
            "transfers": pageable, "pinned": pinned, "reps_best_of": reps}


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    out = bench(int(argv[0]) if argv else 5)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
