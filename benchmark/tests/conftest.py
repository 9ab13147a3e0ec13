"""Fixtures of the benchmark's own tests: the benchmark's folder on the
import path, a copy of the benchmark cut to the tiny widths on the CPU,
and a skip for tests that need a card (decided inside the fixture).

    python -m pytest benchmark/tests -q     (from the root of the repo)
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

CELLS = tuple(w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"])


def tiny_copy(dest: str) -> str:
    """A copy of BENCHMARK.json and benchmark/ under `dest` whose
    configurations have the tiny widths and whose traffic is small; the
    limits are the real ones. Returns the copy's root."""
    from dcae_tpu_torch.config import DCAEConfig

    shutil.copytree(BENCH, os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    tiny = {k: list(v) if isinstance(v, tuple) else v for k, v in
            dataclasses.asdict(DCAEConfig.tiny(
                window_size=8, hyper_window_size=4)).items()}
    for c in spec["configs"]:
        path = os.path.join(dest, c["file"])
        d = json.load(open(path))
        d["model"] = dict(tiny, compute_dtype=d["model"]["compute_dtype"])
        json.dump(d, open(path, "w"))
    tdir = os.path.join(dest, "benchmark", "traffic")
    for name in os.listdir(tdir):
        path = os.path.join(tdir, name)
        d = json.load(open(path))
        if d["generator"] == "codec_closed":
            d.update(height=128, width=256, batch=min(d["batch"], 2),
                     distinct=2, sample=2)
        else:
            d.update(batch=2, crop=128, pool=3, pool_size=160)
        d.update(trace_skip_s=0.3, trace_seconds=0.6)
        json.dump(d, open(path, "w"))
    return dest


def run_copy(root: str, cell: str, seed: int = 7, seconds: float = 1.5,
             variant: str = "sound", trace: int = 0):
    """variants.py of the copy at `root` in a fresh process on the CPU:
    (exit code, parsed last stdout line or None, stderr)."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2",
               CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, os.path.join(root, "benchmark", "tests",
                                      "variants.py"),
         "--workload", cell, "--seed", str(seed), "--seconds",
         str(seconds), "--variant", variant, "--device", "cpu",
         "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, env=env)
    lines = p.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    return p.returncode, line, p.stderr


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("tiny")))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
