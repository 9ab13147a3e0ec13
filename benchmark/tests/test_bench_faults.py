"""Each fault a cell can have, planted underneath a whole run on the CPU at
the tiny widths (the harness's look for a card skipped), turns `correct`
false; and each cell's control, the program with its f32 work in TF32 or
its bf16 transforms in fp8, does so on the card at the cells' widths.

The CPU runs carry the cells' own limits; the control's readings at the
cells' full sizes are in PERF.md."""

from __future__ import annotations

import pytest

from conftest import run_copy

CODEC = "dcae-bf16.kodak-b8-interleaved"
TRAIN = "dcae-f32.train-b8-256"


@pytest.mark.parametrize("cell,variant", [
    (CODEC, "half"), (CODEC, "altered"), (CODEC, "stream"),
    (CODEC, "scales"),
    (TRAIN, "half"), (TRAIN, "altered"), (TRAIN, "stale")])
def test_a_planted_fault_is_not_correct(tiny, cell, variant):
    rc, line, err = run_copy(tiny, cell, seed=31, variant=variant)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line


@pytest.mark.cuda
@pytest.mark.parametrize("cell,variant", [
    (CODEC, "tf32"), (CODEC, "fp8"), (TRAIN, "tf32")])
def test_the_control_is_not_correct_on_the_card(card, cell, variant):
    """The cells' widths at a size a test run holds: the codec on one
    batch of two 256x256 images, training on two 128x128 crops."""
    import json
    import os
    import shutil
    import subprocess
    import sys
    import tempfile

    from conftest import BENCH, ROOT

    with tempfile.TemporaryDirectory() as d:
        shutil.copytree(BENCH, os.path.join(d, "benchmark"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), d)
        tdir = os.path.join(d, "benchmark", "traffic")
        for name in os.listdir(tdir):
            path = os.path.join(tdir, name)
            t = json.load(open(path))
            if t["generator"] == "codec_closed":
                t.update(batch=2, height=256, width=256, distinct=1,
                         sample=1)
            else:
                t.update(batch=2, crop=128, pool=2, pool_size=192)
            json.dump(t, open(path, "w"))
        p = subprocess.run(
            [sys.executable, os.path.join(d, "benchmark", "tests",
                                          "variants.py"),
             "--workload", cell, "--seed", "41", "--seconds", "1",
             "--variant", variant],
            capture_output=True, text=True, timeout=900,
            env=dict(os.environ, PYTHONPATH=ROOT))
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is False
