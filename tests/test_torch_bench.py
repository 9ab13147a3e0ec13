"""bench_torch.py, the port's bench, tiny and on the CPU:

  * run() on DCAEConfig.tiny() and 2 structured 64x64 images, 1 round,
    budget 0, 1 pipeline batch: the JSON line carries every key of
    bench.py's line as BENCH_r05.json records it;
  * the rule that keeps an interleaved serving round with a batch coded
    classic out of the interleaved median, the rules that keep a failed or
    thin interleaved median from the headline, and the skipped profile;
  * where an unset DCAE_BENCH_CKPT looks (the run's TMPDIR);
  * the capture guard (SIGALRM prints the line so far, exit 0), the refusal
    to run without a card unless asked for the CPU, and a named checkpoint
    that does not load, as subprocesses.

The numbers a CPU run gives are not device numbers: these tests check
keys, rules and exit codes, not times.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import pytest
import torch

import bench_torch
from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.data.synthetic import synthetic_kodak
from dcae_tpu_torch.entropy import rans
from dcae_tpu_torch.models.codec import DCAECodec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def codec():
    c = DCAECodec(DCAEConfig.tiny(), device="cpu")
    c.update()
    yield c
    c.close()


@pytest.fixture(scope="module")
def images():
    return synthetic_kodak(2, h=64, w=64)


def _bench_r05_keys():
    """(top-level, detail, interleaved_profile) keys of bench.py's line."""
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        parsed = json.load(f)["parsed"]
    return (set(parsed), set(parsed["detail"]),
            set(parsed["detail"]["interleaved_profile"]))


def _bench(env_extra: dict, *args: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DCAE_BENCH_")}
    env.update(OMP_NUM_THREADS="1", DCAE_BENCH_CONFIG="tiny", **env_extra)
    return subprocess.run([sys.executable, "bench_torch.py", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)


def test_tiny_run_has_bench_py_line(codec, images):
    """Rule: every top-level, detail and interleaved_profile key of
    bench.py's line (BENCH_r05.json "parsed") is present; value > 0;
    vs_baseline == round(value / (1000 / 193), 4) exactly; bpp > 0; the
    interleaved profile ok with no batch coded classic."""
    res = bench_torch.run(codec, images, 1, 0.0, 1)
    top, detail, il = _bench_r05_keys()
    assert top <= set(res), top - set(res)
    assert detail <= set(res["detail"]), detail - set(res["detail"])
    prof = res["detail"]["interleaved_profile"]
    assert il <= set(prof), il - set(prof)
    assert "error" not in res["detail"]
    assert res["metric"] == "kodak768x512_encdec_images_per_sec"
    assert res["value"] > 0
    assert res["vs_baseline"] == round(res["value"] / (1000 / 193), 4)
    assert res["detail"]["bpp"] > 0 and prof["bpp"] > 0
    assert prof["ok"] is True and prof["classic_batches"] == 0
    assert prof["rounds"] == res["detail"]["rounds"] == 1
    assert res["detail"]["device"] == "cpu"
    assert res["detail"]["fast_encoder"] is True


def test_round_with_classic_batch_left_out(codec, images, monkeypatch):
    """Rule: a serving round of the interleaved loop in which a batch fell
    back to the classic codec is counted (classic_batches,
    rounds_excluded) and gives no interleaved median; the headline is then
    the classic loop's."""
    loop = codec.encdec_pipeline_interleaved

    def one_classic(batches, **kw):
        outs = loop(batches, **kw)
        outs[0]["profile"] = "classic"
        return outs

    monkeypatch.setattr(codec, "encdec_pipeline_interleaved", one_classic)
    res = bench_torch.run(codec, images, 2, 0.0, 2)
    prof = res["detail"]["interleaved_profile"]
    assert prof["ok"] is True
    assert prof["classic_batches"] == 2 and prof["rounds_excluded"] == 2
    assert "pipeline_median_img_per_sec" not in prof
    assert "interleaved_classic_ratio" not in res
    assert res["detail"]["profile"] == "classic"
    assert res["value"] == res["classic_median_img_per_sec"] > 0


@pytest.mark.parametrize("case", ["failed_checksum", "too_few_rounds"])
def test_headline_falls_back_to_classic(codec, images, monkeypatch, case):
    """Rule: the interleaved median is the headline only while the profile
    is ok and holds at least half as many rounds as the classic median.
    The classic loop is slowed by 0.3 s a round, so the interleaved median
    is the higher one and only the rule keeps it from the headline.
    failed_checksum (2 rounds): the loop's second round fails a lanes
    checksum; the profile turns not ok and the loop runs no more turns,
    while 1 interleaved round against 2 classic ones would pass the rounds
    rule. too_few_rounds (3 rounds): its second and third rounds code a
    batch classic, which leaves 1 interleaved round against 3 classic
    ones."""
    il_loop, classic_loop = (codec.encdec_pipeline_interleaved,
                             codec.encdec_pipeline)
    calls = []

    def interleaved(batches, **kw):
        outs = il_loop(batches, **kw)
        calls.append(1)
        if len(calls) > 1:
            if case == "failed_checksum":
                outs[0]["ok"] = torch.tensor(False)
            else:
                outs[0]["profile"] = "classic"
        return outs

    def slow_classic(batches, **kw):
        time.sleep(0.3)
        return classic_loop(batches, **kw)

    monkeypatch.setattr(codec, "encdec_pipeline_interleaved", interleaved)
    monkeypatch.setattr(codec, "encdec_pipeline", slow_classic)
    n_rounds = 2 if case == "failed_checksum" else 3
    res = bench_torch.run(codec, images, n_rounds, 0.0, 1)
    prof = res["detail"]["interleaved_profile"]
    assert prof["rounds"] == 1 and res["detail"]["rounds"] == n_rounds
    assert prof["pipeline_median_img_per_sec"] > res[
        "classic_median_img_per_sec"]
    if case == "failed_checksum":
        assert prof["ok"] is False and len(calls) == 2
        assert prof["failed_batches"] == 1 and prof["rounds_excluded"] == 1
    else:
        assert prof["ok"] is True and len(calls) == 3
        assert prof["classic_batches"] == 2 and prof["rounds_excluded"] == 2
    assert res["detail"]["profile"] == "classic"
    assert res["value"] == res["classic_median_img_per_sec"] > 0


def test_auto_checkpoints_lie_under_tmpdir(tmp_path, monkeypatch):
    """Rule: with DCAE_BENCH_CKPT unset the bench looks for
    checkpoint_latest.ckpt, then checkpoint_best.ckpt, in
    dcae_bench_ckpt under the run's temporary directory, nowhere else."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    d = tmp_path / "dcae_bench_ckpt"
    assert bench_torch.auto_ckpts() == (
        str(d / "checkpoint_latest.ckpt"), str(d / "checkpoint_best.ckpt"))


def test_escaping_profile_is_skipped(codec, images, monkeypatch):
    """Rule: when the interleaved profile's encoder raises EscapeError the
    profile is reported skipped (ok false, the reason kept), its serving
    loop is not raced, and the bench still gives the classic headline."""
    def escape(x, **kw):
        raise rans.EscapeError("escape patch list overflow")

    monkeypatch.setattr(codec, "compress_device", escape)
    res = bench_torch.run(codec, images, 1, 0.0, 1)
    prof = res["detail"]["interleaved_profile"]
    assert prof == {"ok": False, "skipped": "escape patch list overflow"}
    assert res["detail"]["profile"] == "classic" and res["value"] > 0
    assert res["detail"]["single_image_profile"] != "interleaved"


def test_alarm_prints_line_and_exits_0():
    """Rule: with DCAE_BENCH_TOTAL_S=1 the SIGALRM guard prints the line so
    far (value 0 and its error, terminated_by_signal 14) as the last stdout
    line and the exit code is 0."""
    out = _bench({"DCAE_BENCH_TOTAL_S": "1", "DCAE_BENCH_DEVICE": "cpu"})
    assert out.returncode == 0, out.stderr
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["detail"]["terminated_by_signal"] == 14
    assert last["metric"] == "kodak768x512_encdec_images_per_sec"


def test_no_card_is_an_error():
    """Rule: without a card and without DCAE_BENCH_DEVICE=cpu the bench
    prints an error line (value 0) and exits non-zero: no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _bench({})
    assert out.returncode != 0
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["value"] == 0.0 and "no CUDA device" in last["detail"][
        "error"]


def test_named_checkpoint_that_does_not_load_is_an_error(tmp_path):
    """Rule: a checkpoint named by DCAE_BENCH_CKPT that does not load
    stops the bench with an error line and a non-zero exit, not a run on
    seeded weights."""
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"not a checkpoint")
    out = _bench({"DCAE_BENCH_DEVICE": "cpu", "DCAE_BENCH_CKPT": str(bad)})
    assert out.returncode != 0
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["value"] == 0.0 and str(bad) in last["detail"]["error"]
