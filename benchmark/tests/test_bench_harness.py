"""The harness: BENCHMARK.json against the contract's rules of form, every
file found by name, each cell driven end to end on the CPU at the tiny
widths, the refusal without a card, the whole-name module check, and a
cell and a metric added by new files alone."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from conftest import BENCH, CELLS, ROOT, run_copy

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def line_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_form_of_benchmark_json():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(line_ok(w) for w in SPEC["command"])
    for w in SPEC["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_names_units_and_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"])
        assert line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/")
        names.append(c["name"])
    assert len(set(names)) == len(names)
    pairs, cells = set(), []
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"])
        assert NAME.match(w["traffic"]) and line_ok(w["why"])
        assert w["chips"] in (1, 4) and w["config"] in names
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cells.append(w["name"])
    assert len(set(cells)) == len(cells) and 1 <= len(cells) <= 24
    fours = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert fours <= max(1, len(cells) // 4)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == set(names)
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    layers = set()
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and line_ok(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.add(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in cells
    # every cell reports setup_s, another end-to-end metric, a per-layer one
    for cell in cells:
        mine = [m for m in SPEC["end_to_end"]
                if cell in m.get("workloads", [cell])]
        assert len(mine) >= 2
        assert any(cell in m.get("workloads", []) for m in SPEC["per_layer"])
    # a per-layer metric's cells report the end-to-end metric it moves
    by_name = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        for cell in m["workloads"]:
            assert cell in by_name[m["moves"]].get("workloads", [cell])


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_is_found_by_name(cell):
    from harness import core

    c = core.load_cell(os.path.join(ROOT, "BENCHMARK.json"), cell)
    assert c.traffic["generator"] in ("codec_closed", "train_closed")
    assert os.path.exists(os.path.join(BENCH, "drivers",
                                       c.traffic["generator"] + ".py"))
    assert c.limits["checks"]
    for m in c.end_to_end:
        assert m["name"] == "setup_s" or m["name"] in c.traffic["report"]
    for m in c.per_layer:
        reader = core.load_module(os.path.join(
            BENCH, "metrics", m["name"].split(".")[0] + ".py"), "r")
        assert callable(reader.read)


def test_without_a_card_the_command_refuses():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert "error" in p.stderr


def test_module_check_compares_whole_top_level_names(monkeypatch):
    from harness import core

    for name in ("dcae_tpu_torch", "dcae_tpu_torch.models", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(core.forbidden_modules()) & {
        "dcae_tpu", "jax", "jaxlib", "flax"}
    for name in ("jax", "jaxlib.xla", "flax.core", "dcae_tpu.models"):
        monkeypatch.setitem(sys.modules, name, sys)
        assert name.split(".")[0] in core.forbidden_modules()


def test_a_rank_that_loads_jax_leaves_no_result(tiny, tmp_path):
    """A data-parallel run of two ranks on the CPU (gloo) in which rank 1
    loads a module named jax: the run exits 3 and prints no result."""
    import shutil

    root = str(tmp_path / "two")
    shutil.copytree(tiny, root)
    path = os.path.join(root, "benchmark", "traffic",
                        "train-dp4-b8-256.json")
    t = json.load(open(path))
    t["world"] = 2
    json.dump(t, open(path, "w"))
    rc, line, err = run_copy(root, "dcae-f32.train-dp4", seconds=0.5,
                             variant="rankjax")
    assert rc == 3 and line is None, err[-3000:]
    assert "rank 1 loaded modules" in err and "['jax']" in err


@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("cell", CELLS)
def test_cell_end_to_end_on_the_cpu(tiny, cell, trace):
    rc, line, err = run_copy(tiny, cell, seed=2 ** 31 + 99, trace=trace)
    assert rc == 0, err[-3000:]
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    assert err.strip().splitlines()[-1].startswith("check ")
    want = {m["name"] for m in SPEC["end_to_end"]
            if cell in m.get("workloads", [cell])}
    if trace:
        assert "busy_s" in line["device"] and "breakdown" in line
        allowed = {m["name"] for m in SPEC["per_layer"]
                   if cell in m["workloads"]}
        assert set(line["metrics"]) <= allowed
    else:
        assert set(line["metrics"]) == want
    for v in line["metrics"].values():
        assert isinstance(v["value"], float)


def test_a_new_cell_and_metric_need_only_new_files(tiny, tmp_path):
    import shutil

    root = str(tmp_path / "grown")
    shutil.copytree(tiny, root)
    before = {os.path.relpath(os.path.join(d, f), root): open(
        os.path.join(d, f), "rb").read()
        for d, _, fs in os.walk(os.path.join(root, "benchmark"))
        for f in fs if "__pycache__" not in d}
    b = os.path.join(root, "benchmark")
    json.dump({"generator": "codec_closed", "batch": 1, "height": 128,
               "width": 128, "distinct": 1, "sample": 1,
               "trace_skip_s": 0.3, "trace_seconds": 0.6,
               "work": {"entropy_passes": 2},
               "report": {"codec_img_per_s": "img_per_s"}},
              open(os.path.join(b, "traffic", "square-one.json"), "w"))
    shutil.copy(os.path.join(b, "workloads",
                             "dcae-bf16.kodak-b8-interleaved.json"),
                os.path.join(b, "workloads", "dcae-bf16.square-one.json"))
    with open(os.path.join(b, "metrics", "requests_traced.py"), "w") as f:
        f.write("def read(v, name):\n"
                "    return float(v.result.counts.get('requests', 0))\n")
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["workloads"].append({"name": "dcae-bf16.square-one",
                              "config": "dcae-n192m320-bf16",
                              "traffic": "square-one", "chips": 1,
                              "why": "a test cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "codec_img_per_s":
            m["workloads"].append("dcae-bf16.square-one")
    spec["per_layer"].append({"name": "requests_traced.square", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "codec driver",
                              "moves": "codec_img_per_s",
                              "workloads": ["dcae-bf16.square-one"]})
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))
    rc, line, err = run_copy(root, "dcae-bf16.square-one", trace=1)
    assert rc == 0, err[-3000:]
    assert line["metrics"]["requests_traced.square"]["value"] >= 1
    rc, line, err = run_copy(root, "dcae-bf16.square-one", trace=0)
    assert rc == 0 and set(line["metrics"]) == {"codec_img_per_s", "setup_s"}
    for rel, data in before.items():
        assert open(os.path.join(root, rel), "rb").read() == data, rel


def test_a_reader_with_nothing_to_read_returns_none():
    from harness import core, readers

    cell = core.load_cell(os.path.join(ROOT, "BENCHMARK.json"), CELLS[0])
    res = core.Result(1, 0, {}, [], 0, 1, trace={
        "kernels": [("some_other_kernel", 0.0, 10.0)], "spans": [],
        "window": (0.0, 100.0)},
        counts={"images": 8, "requests": 1, "batch": 8, "height": 512,
                "width": 768})
    view = core.ReaderView(cell, res, None)
    for family in ("wmsa_block_roofline", "conv_glu_roofline",
                   "lane_coder_ms_per_img", "cudnn_conv_ms_per_img",
                   "encode_ms_per_img"):
        reader = core.load_module(os.path.join(BENCH, "metrics",
                                               family + ".py"), family)
        assert reader.read(view, family + ".codec") is None
    res.trace["kernels"] = [("void wmsa_mma_kernel<true>(...)", 0.0, 1e4)]
    got = readers.kernel_roofline_pct(view, "wmsa", "wmsa_kernel")
    assert 0 < got < 100


def test_tracer_keeps_the_windows_untraced_spans_only():
    from harness import trace

    t = trace.Tracer(True, skip_s=1e9, seconds=1.0)
    with t.span("encode"):
        pass                          # set-up's call, before the window
    t.begin()
    assert t.pre["spans"] == {}
    with t.span("encode"):
        t.count(8)
    assert set(t.pre["spans"]) == {"encode"} and t.pre["images"] == 8
    quiet = trace.Tracer(False, 0.0, 1.0)
    with quiet.span("encode"):
        quiet.count(8)
    assert quiet.pre["spans"] == {}
