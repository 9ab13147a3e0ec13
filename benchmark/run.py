#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell's files are found by its name in
BENCHMARK.json (harness/core.py). The last line of standard output is
one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), device
(and with --trace 1 busy_s, window_s and a breakdown), and last the
checks that decided `correct`, each with its limit. Without enough CUDA
devices it prints an error and exits 2.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def cache_env() -> None:
    """The driver's JIT cache at a fixed path inside the checkout (the
    program builds its kernels with nvcc into build/dcae_tpu_torch, there
    too), and libraries kept from loading JAX on their own."""
    os.environ.setdefault("CUDA_CACHE_PATH",
                          os.path.join(ROOT, "build", "bench_cache", "nv"))
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env()
    for path in (ROOT, BENCH):
        if path not in sys.path:
            sys.path.insert(0, path)
    from harness import core
    return core.run(args, T0, ROOT)


if __name__ == "__main__":
    sys.exit(main())
