"""One run of one cell: find the cell's files by name, check the card, hand
the run to the cell's traffic generator, and print the result line.

Everything that belongs to a cell, a configuration, a traffic mix or a
per-layer metric is a file of its own, found by the names in
BENCHMARK.json:

    configs:   the entry's "file" (sizes, dtypes, recipe, source)
    traffic:   traffic/<traffic>.json   (parameters; names its generator)
    generator: drivers/<generator>.py   (run(ctx) -> Result)
    cell:      workloads/<cell>.json    (the limits of its checks)
    metric:    metrics/<name before the first dot>.py (read(ctx, name))
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from typing import Callable, Dict, List, Optional, Tuple

FORBIDDEN = ("jax", "jaxlib", "flax", "dcae_tpu")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A cell's files, resolved from BENCHMARK.json by name."""
    name: str
    entry: dict          # the BENCHMARK.json workload entry
    config: dict         # the configuration's file
    traffic: dict        # traffic/<traffic>.json
    limits: dict         # workloads/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str            # the benchmark's folder

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def generator(self):
        g = self.traffic["generator"]
        return load_module(os.path.join(self.root, "drivers", g + ".py"),
                           "bench_driver_" + g)


def applies(metric: dict, cell: str, reported: Optional[set] = None
            ) -> bool:
    """A metric is a cell's when its workloads list the cell, or, without
    the key, when the cell reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def load_cell(bench_json: str, name: str) -> Cell:
    spec = read_json(bench_json)
    root = os.path.dirname(os.path.abspath(bench_json))
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in {bench_json}")
    w = entries[name]
    cfgs = {c["name"]: c for c in spec["configs"]}
    config = read_json(os.path.join(root, cfgs[w["config"]]["file"]))
    here = os.path.join(root, "benchmark")
    traffic = read_json(os.path.join(here, "traffic", w["traffic"] + ".json"))
    limits = read_json(os.path.join(here, "workloads", name + ".json"))
    e2e = [m for m in spec["end_to_end"] if applies(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if applies(m, name, names)]
    return Cell(name, w, config, traffic, limits, e2e, per_layer, here)


@dataclasses.dataclass
class Result:
    """What a generator returns. quantities: the end-to-end numbers by the
    names the traffic file maps; checks: (name, value, limit), a check
    passes when value <= limit; trace: the parsed device trace and the
    untraced record before it (traced runs); counts: what the readers
    divide by ("images", "requests") and one device's shapes."""
    attempted: int
    failed: int
    quantities: Dict[str, float]
    checks: List[Tuple[str, float, float]]
    memory_peak_bytes: int
    device_count: int
    notes: List[str] = dataclasses.field(default_factory=list)
    trace: Optional[dict] = None
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    judged: bool = False
    # forbidden modules that another process of the run (a rank) loaded
    forbidden: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Context:
    """What a generator gets."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float                     # the process's start, perf_counter
    first_call: Optional[float] = None
    bench_json: str = ""          # the BENCHMARK.json the cell came from

    def mark_first_call(self, t: float) -> None:
        if self.first_call is None:
            self.first_call = t

    def subseed(self, *tags: int) -> int:
        """A seed of its own for each use of the run's seed."""
        import numpy as np
        return int(np.random.SeedSequence(
            [self.seed % (1 << 63), *tags]).generate_state(1, np.uint64)[0]
            >> 1)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


def read_metrics(cell: Cell, res: Result, ctx: Context, trace: bool,
                 setup_s: float) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                v = setup_s
            else:
                key = cell.traffic["report"][m["name"]]
                v = res.quantities[key]
            out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        family = m["name"].split(".")[0]
        reader = load_module(os.path.join(cell.root, "metrics",
                                          family + ".py"),
                             "bench_metric_" + family)
        v = reader.read(ReaderView(cell, res, ctx), m["name"])
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


@dataclasses.dataclass
class ReaderView:
    """What a per-layer reader sees: the cell, the generator's result
    (its trace, spans and counts) and the run."""
    cell: Cell
    result: Result
    ctx: Context


def run(args, t0: float, repo_root: str,
        out: Callable[[str], None] = print) -> int:
    import torch

    bench_json = os.path.join(repo_root, "BENCHMARK.json")
    cell = load_cell(bench_json, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"error: cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = Context(cell, int(args.seed), float(args.seconds),
                  bool(int(args.trace)), "cuda", t0, bench_json=bench_json)
    res = cell.generator().run(ctx)
    return finish(cell, ctx, res, out)


def finish(cell: Cell, ctx: Context, res: Result,
           out: Callable[[str], None] = print) -> int:
    """Print the notes and checks on stderr and the result line last on
    stdout; 0, or 3 when a forbidden module was loaded in this process or
    in another process of the run."""
    bad = forbidden_modules()
    where = ([f"this process's: {bad}"] if bad else []) + res.forbidden
    if where:
        print(f"error: modules loaded that the run may not load: {where}",
              file=sys.stderr)
        return 3
    setup_s = (ctx.first_call or ctx.t0) - ctx.t0
    metrics = read_metrics(cell, res, ctx, ctx.trace, setup_s)
    checks = {name: {"value": v, "limit": lim} for name, v, lim in res.checks}
    correct = bool(res.judged and res.failed == 0 and res.checks and all(
        finite(v) and v <= lim for _, v, lim in res.checks))
    device = {"platform": "gpu" if ctx.device == "cuda" else ctx.device,
              "kind": _device_kind(ctx.device),
              "count": res.device_count,
              "memory_peak_bytes": int(res.memory_peak_bytes)}
    line = {"correct": correct, "attempted": res.attempted,
            "failed": res.failed, "metrics": metrics, "device": device}
    if ctx.trace and res.trace is not None:
        from harness import trace as tr
        device["busy_s"] = tr.busy_s(res.trace)
        device["window_s"] = tr.window_s(res.trace)
        line["breakdown"] = tr.breakdown(res.trace)
    line["checks"] = checks
    for note in res.notes:
        print(note, file=sys.stderr)
    for name, v, lim in res.checks:
        print(f"check {name} {v!r} limit {lim!r} "
              f"{'ok' if finite(v) and v <= lim else 'FAIL'}",
              file=sys.stderr)
    out(json.dumps(line))
    return 0


def _device_kind(device: str) -> str:
    if device != "cuda":
        return device
    import torch
    return torch.cuda.get_device_name(0)
