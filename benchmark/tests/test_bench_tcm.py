"""The TCM cell (drivers/codec_tcm.py) on the CPU at the tiny widths:
sound (traced and not) and under each planted fault; TCM's seeded
weights against the program's state dict; the TCM reference against the
tests' copy of it; the TCM FLOP count and the window kernel's launches
against hand counts.

A copy of the benchmark is cut to the tiny widths as conftest.tiny_copy
does, with the TCM configuration at TCMConfig.tiny's widths and the TCM
traffic at 256 x 256 (TCM's windows need 256 px)."""

from __future__ import annotations

import dataclasses
import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT, tiny_copy

CELL = "tcm-bf16.kodak-b8-interleaved"
# the per-layer metrics a traced CPU run reads from the host alone
HOST_METRICS = {"encode_ms_per_img.codec", "decode_ms_per_img.codec",
                "tcm_mfu_pct.codec", "tcm_mix_ms_per_img.codec",
                "tcm_swatten_ms_per_img.codec"}


@pytest.fixture(scope="module")
def tcm_copy(tmp_path_factory):
    from dcae_tpu_torch.config import TCMConfig

    dest = tiny_copy(str(tmp_path_factory.mktemp("tcm")))
    tiny = {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(TCMConfig.tiny()).items()}
    path = os.path.join(dest, "benchmark", "configs",
                        "tcm-n128m320-bf16.json")
    d = json.load(open(path))
    d["model"] = dict(tiny, compute_dtype=d["model"]["compute_dtype"])
    json.dump(d, open(path, "w"))
    path = os.path.join(dest, "benchmark", "traffic",
                        "kodak-b8-interleaved-tcm.json")
    d = json.load(open(path))
    d.update(height=256, width=256, batch=2, distinct=2, sample=2,
             trace_skip_s=0.3, trace_seconds=0.6)
    json.dump(d, open(path, "w"))
    return dest


def run_tcm(root: str, seed: int = 7, variant: str = "sound",
            trace: int = 0):
    """variants.py of the copy at `root` on the CPU: (exit code, last
    stdout line or None, stderr)."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2",
               CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, os.path.join(root, "benchmark", "tests",
                                      "variants.py"),
         "--workload", CELL, "--seed", str(seed), "--seconds", "1.5",
         "--variant", variant, "--device", "cpu", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, env=env)
    lines = p.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    return p.returncode, line, p.stderr


@pytest.mark.parametrize("trace", (0, 1))
def test_tcm_cell_end_to_end_on_the_cpu(tcm_copy, trace):
    spec = json.load(open(os.path.join(tcm_copy, "BENCHMARK.json")))
    rc, line, err = run_tcm(tcm_copy, seed=2 ** 31 + 99, trace=trace)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line
    assert line["attempted"] > 0 and line["failed"] == 0
    if trace:
        allowed = {m["name"] for m in spec["per_layer"]
                   if CELL in m["workloads"]}
        assert HOST_METRICS <= set(line["metrics"]) <= allowed
    else:
        assert set(line["metrics"]) == {"codec_img_per_s", "setup_s"}
    for v in line["metrics"].values():
        assert isinstance(v["value"], float) and np.isfinite(v["value"])


@pytest.mark.parametrize("variant", ("half", "altered", "stream", "scales"))
def test_a_planted_fault_is_not_correct(tcm_copy, variant):
    rc, line, err = run_tcm(tcm_copy, seed=31, variant=variant)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line


def test_tcm_weights_fill_the_programs_state_dict():
    from dcae_tpu_torch.config import TCMConfig
    from dcae_tpu_torch.models.tcm import TCM
    from harness import tcm_weights

    cfg = TCMConfig.tiny()
    c = dataclasses.asdict(cfg)
    sd = tcm_weights.make(c, 2 ** 31 + 3, "cpu")
    m = TCM(cfg)
    m.load_state_dict(sd, strict=True)
    again = tcm_weights.make(c, 2 ** 31 + 3, "cpu")
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    other = tcm_weights.make(c, 4, "cpu")
    assert not torch.equal(sd["g_a.0.conv1.weight"],
                           other["g_a.0.conv1.weight"])
    # GDN starts at the published beta 1, gamma 0.1 I, as the program's
    fresh = TCM(cfg)
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    for name in ("g_a.0.gdn.beta", "g_a.0.gdn.gamma", "h_mean_s.0.igdn.gamma"):
        assert torch.equal(sd[name], fresh.state_dict()[name]), name


def test_the_tcm_reference_is_the_tests_copy_and_loads_nothing():
    """The benchmark's TCM reference is the tests' one; the generator, the
    judge and the yardstick load nothing of the program on import (the
    generator reaches for TCM only when a run starts)."""
    assert filecmp.cmp(os.path.join(BENCH, "reference", "tcm_model.py"),
                       os.path.join(ROOT, "tests", "torch_tcm_reference.py"),
                       shallow=False)
    code = ("import sys; sys.path[:0] = [%r]\n"
            "from reference import tcm_model, tcm_check\n"
            "from harness import tcm_weights, tcm_yardstick\n"
            "from drivers import codec_tcm\n"
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'dcae_tpu_torch', 'dcae_tpu', 'jax', 'jaxlib', 'flax'}\n"
            "assert not bad, bad\n" % BENCH)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr


def test_tcm_flops_against_a_hand_count():
    """FlopCounterMode's count of g_a's first stride unit and of one
    SWAtten at the tiny widths against 2 x MACs worked by hand."""
    from dcae_tpu_torch.config import TCMConfig
    from harness import tcm_yardstick
    from reference import tcm_model
    from torch.utils.flop_counter import FlopCounterMode

    c = dataclasses.asdict(TCMConfig.tiny())
    with FlopCounterMode(display=False) as fc:
        tcm_model.ResidualBlockWithStride(3, 16)(torch.zeros(1, 3, 32, 32))
    # conv1 3x3 s2 3->16, conv2 3x3 16->16, GDN's 1x1 16->16, skip 1x1 s2
    assert fc.get_total_flops() == 2 * 16 * 16 * 16 * (
        9 * 3 + 9 * 16 + 16 + 3)
    f = tcm_yardstick.model_flops(c, 1, 256, 256)
    assert set(f) == {"g_a", "h_a", "entropy", "g_s"}
    assert all(v > 0 for v in f.values()) and f["g_s"] > f["h_a"]


def test_tcm_window_launches_against_a_hand_count():
    """TCM-L on a batch of 8 at 768 x 512: two bf16 blocks a stage of g_a
    and g_s at 128 channels, and 2 passes x 5 slices x 2 SWAttens x 2
    blocks in f32 at the latent's 48 x 32."""
    from harness import tcm_yardstick, yardstick

    cfg = json.load(open(os.path.join(BENCH, "configs",
                                      "tcm-n128m320-bf16.json")))["model"]
    got = tcm_yardstick.window_launches(cfg, 8, 512, 768, "bfloat16", 2)
    bf16 = [f for f, _, d in got if d == "bfloat16"]
    f32 = [f for f, _, d in got if d == "float32"]
    assert len(bf16) == 12 and len(f32) == 40
    tok = 8 * (256 * 384 + 128 * 192 + 64 * 96)
    assert sum(bf16) == 2 * 2 * tok * (8 * 128 ** 2 + 256 * 128)
    assert sum(f32) == 40 * 8 * 32 * 48 * (8 * 128 ** 2 + 256 * 128)
    # the heads of a stage: 128 over its head_dim, g_a's first at 8
    w = yardstick.window_block_work(8 * 256 * 384, 128, 16, "bfloat16")
    assert got[0] == w + ("bfloat16",)
    cfg4 = dict(cfg, window_size=4)
    assert tcm_yardstick.window_launches(cfg4, 8, 512, 768, "bfloat16",
                                         2) == []
