"""The port's registry of spans and counters (utils/profiling.py) on the
CPU, tiny config:

- with no sink registered, span() is one shared object that reads no
  clock and count() records nothing;
- with a sink, spans nest by their intervals, also across threads (a
  backward's final callback runs on another thread), and close on an
  exception;
- compress_device + decompress_interleaved record the five codec spans
  once each, in order, and the same streams and x_hat bit for bit with a
  sink and without; a patch-list overflow closes its spans;
- a training step records its forward, backward and update; in two gloo
  ranks (tests/torch_span_worker.py) the all-reduce lies inside the
  backward;
- cost_analysis counts the hand kernels' FLOPs through a sink, and
  note_launch reads no tensor's data.
"""

import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import dcae_tpu_torch.ops.kernels as kernels
from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.entropy import rans
from dcae_tpu_torch.models.codec import DCAECodec
from dcae_tpu_torch.ops.kernels import note_launch
from dcae_tpu_torch.utils import profiling
from dcae_tpu_torch.utils.profiling import count, registered, span
from tests.torch_dp_common import state_and_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODEC_SPANS = ["codec.encode.dispatch", "codec.encode.wait",
               "codec.encode.host", "codec.decode.host",
               "codec.decode.dispatch"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class Recorder(profiling.Sink):
    """Everything the registry hands a sink, in order."""

    def __init__(self):
        self.spans, self.counts, self.launches = [], {}, []

    def span(self, name, start, end):
        self.spans.append((name, start, end))

    def count(self, name, n):
        self.counts[name] = self.counts.get(name, 0) + n

    def launch(self, name, flops, nbytes):
        self.launches.append((name, flops, nbytes))

    def names(self):
        return [s[0] for s in sorted(self.spans, key=lambda s: s[1])]


@pytest.fixture(scope="module")
def codec():
    """A tiny codec on drawn weights and a batch of two 128x128 images."""
    c = DCAECodec(DCAEConfig.tiny(window_size=8, hyper_window_size=4),
                  device="cpu")
    c.update()
    x = torch.rand((2, 128, 128, 3),
                   generator=torch.Generator().manual_seed(0))
    yield c, x
    c.close()


def test_no_sink_span_and_count_are_shared_noops(monkeypatch):
    assert profiling.sinks == []

    def no_clock():
        raise AssertionError("a span read the clock with no sink")

    monkeypatch.setattr(profiling.time, "perf_counter", no_clock)
    a, b = span("train.forward"), span("codec.encode.host")
    assert a is b is profiling._NO_SPAN
    with span("train.forward"):
        count("codec.patched_symbols", 5)


def test_spans_nest_by_their_intervals():
    rec = Recorder()
    with registered(rec):
        with span("outer"):
            with span("middle"):
                with span("inner"):
                    pass
            with span("second"):
                pass
        with span("alone"):
            pass
    assert profiling.sinks == []
    by = {n: (a, b) for n, a, b in rec.spans}
    assert [s[0] for s in rec.spans] == ["inner", "middle", "second",
                                         "outer", "alone"]
    assert by["outer"][0] <= by["middle"][0] <= by["inner"][0] \
        <= by["inner"][1] <= by["middle"][1] <= by["second"][0] \
        <= by["second"][1] <= by["outer"][1] <= by["alone"][0]


def test_span_closes_on_an_exception():
    rec = Recorder()
    with registered(rec), pytest.raises(KeyError):
        with span("outer"):
            with span("inner"):
                raise KeyError("x")
    (inner, a, b), (outer, c, d) = rec.spans
    assert (inner, outer) == ("inner", "outer") and c <= a <= b <= d


def test_a_span_on_another_thread_lies_in_the_open_one():
    """The dp all-reduce runs as a final callback of the backward, on
    autograd's device thread on the card: its span closes inside the
    backward's interval."""
    rec = Recorder()

    def worker():
        with span("callback"):
            pass

    with registered(rec):
        with span("caller"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
    (inner, a, b), (outer, c, d) = rec.spans
    assert (inner, outer) == ("callback", "caller") and c <= a <= b <= d


def test_spans_from_many_threads_all_close():
    """More threads than cores open and close spans at once, switching
    every microsecond: every span reaches the sink, with its own name and
    an interval that runs forward."""
    rec = Recorder()
    names = {f"t{i}" for i in range(16)}

    def worker(name):
        for _ in range(200):
            with span(name):
                pass

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with registered(rec):
            threads = [threading.Thread(target=worker, args=(n,))
                       for n in sorted(names)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in threads)
    assert len(rec.spans) == 16 * 200
    assert {n for n, *_ in rec.spans} == names
    assert all(a <= b for _, a, b in rec.spans)


def test_counts_reach_every_sink():
    a, b = Recorder(), Recorder()
    with registered(a), registered(b):
        count("codec.patched_symbols", 7)
        count("other")
        count("codec.patched_symbols", 3)
    count("codec.patched_symbols", 100)        # no sink: nowhere
    for r in (a, b):
        assert r.counts == {"codec.patched_symbols": 10, "other": 1}


def test_codec_records_its_five_spans_in_order(codec):
    c, x = codec
    rec = Recorder()
    with registered(rec):
        enc = c.compress_device(x)
        dec = c.decompress_interleaved(enc)
    assert bool(dec["ok"])
    assert rec.names() == CODEC_SPANS
    ordered = sorted(rec.spans, key=lambda s: s[1])
    for (_, _, end), (_, start, _) in zip(ordered, ordered[1:]):
        assert end <= start
    assert rec.counts == {"codec.patched_symbols": sum(
        len(p[0]) for p in enc["patches"])}


def test_codec_output_is_the_same_with_a_sink_and_without(codec):
    c, x = codec
    plain = c.compress_device(x)
    plain_x = c.decompress_interleaved(plain)["x_hat"]
    with registered(Recorder()):
        traced = c.compress_device(x)
        traced_x = c.decompress_interleaved(traced)["x_hat"]
    assert traced["istreams"] == plain["istreams"]
    assert traced["z_strings"] == plain["z_strings"]
    np.testing.assert_array_equal(traced["states"], plain["states"])
    for (pa, va), (pb, vb) in zip(traced["patches"], plain["patches"]):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(va, vb)
    assert torch.equal(traced_x, plain_x)


def test_patch_overflow_closes_the_spans(codec, monkeypatch):
    """patch_cap 0 with the device encoder's rows narrowed to two in-range
    buckets (the tiny drawn weights put no symbol outside the table):
    every clamped symbol overflows the patch list."""
    c, x = codec
    orig = c._enc_luts

    def narrowed():
        enc_sf, offs, mp, stride = orig()
        return enc_sf, offs, torch.clamp(mp, max=2), stride

    monkeypatch.setattr(c, "_enc_luts", narrowed)
    monkeypatch.setattr(c, "patch_cap", 0)
    rec = Recorder()
    with registered(rec), pytest.raises(rans.EscapeError,
                                        match="patch list overflow"):
        c.compress_device(x)
    assert rec.counts == {}
    assert rec.names() == CODEC_SPANS[:3]
    assert all(a <= b for _, a, b in rec.spans)


def test_train_step_records_forward_backward_update():
    _, state, step = state_and_step()
    batch = torch.rand((2, 64, 64, 3),
                       generator=torch.Generator().manual_seed(1))
    rec = Recorder()
    with registered(rec):
        step(state, batch)
    assert rec.names() == ["train.forward", "train.backward",
                           "train.update"]
    ordered = sorted(rec.spans, key=lambda s: s[1])
    for (_, _, end), (_, start, _) in zip(ordered, ordered[1:]):
        assert end <= start


def test_dp_allreduce_lies_inside_the_backward(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_span_worker.py"),
         str(port), "2", str(r), str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    for r in range(2):
        with open(tmp_path / f"r{r}.json") as f:
            spans = json.load(f)
        assert [n for n, *_ in spans] == [
            "train.forward", "train.backward", "train.allreduce",
            "train.update"]
        by = {n: (a, b) for n, a, b in spans}
        back, red = by["train.backward"], by["train.allreduce"]
        assert back[0] <= red[0] <= red[1] <= back[1]


def test_cost_analysis_counts_hand_kernels_through_the_registry():
    assert not hasattr(kernels, "launch_costs")
    a = torch.ones(32, 16)

    def with_kernel(x):
        note_launch("wmsa_block", 1000, x, x)
        return x * 2

    rec = Recorder()
    with registered(rec):
        k = profiling.cost_analysis(with_kernel, a)
    assert k["kernel_flops"] == k["flops"] == 1000
    assert k["bytes_accessed"] == 4 * 4 * 32 * 16
    # the other sink saw the launch too, and nothing is left registered
    assert rec.launches == [("wmsa_block", 1000, 2 * 4 * 32 * 16)]
    assert profiling.sinks == []


def test_note_launch_reads_no_tensor_data():
    """A tensor on the meta device has a shape and no data: reading a
    value, copying it to the host or synchronising on it raises."""
    meta = torch.empty((3, 5), device="meta", dtype=torch.bfloat16)
    rec = Recorder()
    note_launch("conv_glu", 7, meta)     # no sink: nothing
    with registered(rec):
        note_launch("conv_glu", 7, meta, meta)
    assert rec.launches == [("conv_glu", 7, 2 * 2 * 15)]
