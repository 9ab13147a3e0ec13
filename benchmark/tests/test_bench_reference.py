"""The yardstick: the plain reference against the program at the tiny widths
on the CPU, its tables and decoders against the program's streams, the
corpus copies byte for byte, the counters against hand-worked values, and
that the reference loads nothing of the program."""

from __future__ import annotations

import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH


@pytest.fixture(scope="module")
def tiny_cfg():
    from dcae_tpu_torch.config import DCAEConfig

    return DCAEConfig.tiny(window_size=8, hyper_window_size=4)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r]\n"
            "from reference import model, entropy, codec_check, train_check\n"
            "from harness import weights, yardstick, corpus, trace\n"
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'dcae_tpu_torch', 'dcae_tpu', 'jax', 'jaxlib', 'flax'}\n"
            "assert not bad, bad\n" % BENCH)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr


def test_corpus_copies_give_the_programs_bytes():
    from dcae_tpu_torch.data import synthetic
    from harness import corpus

    for seed in (0, 2 ** 31 + 5):
        assert np.array_equal(corpus.synthetic_kodak(2, 128, 192, seed),
                              synthetic.synthetic_kodak(2, 128, 192, seed))
        a = corpus.synth_image(np.random.default_rng(seed), 64)
        b = synthetic.synth_image(np.random.default_rng(seed), 64)
        assert np.array_equal(a, b)


def test_seeded_weights_fill_the_programs_state_dict(tiny_cfg):
    from dcae_tpu_torch.models.dcae import DCAE
    from harness import weights

    c = dataclasses.asdict(tiny_cfg)
    sd = weights.make(c, 2 ** 31 + 3, "cpu")
    m = DCAE(tiny_cfg)
    m.load_state_dict(sd, strict=True)
    again = weights.make(c, 2 ** 31 + 3, "cpu")
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    other = weights.make(c, 4, "cpu")
    assert not torch.equal(sd["g_a.0.conv.weight"],
                           other["g_a.0.conv.weight"])


def test_reference_forward_and_step_match_the_program(tiny_cfg):
    """At the tiny widths on the CPU both sides are f32 plain operations:
    the pieces agree to rounding, and so do a training step's loss and
    gradients under the same noise."""
    from dcae_tpu_torch.models.dcae import DCAE
    from harness import weights
    from reference import model as ref
    from reference import train_check

    torch.manual_seed(0)
    c = dataclasses.asdict(tiny_cfg)
    sd = weights.make(c, 11, "cpu")
    prog = DCAE(tiny_cfg)
    prog.load_state_dict(sd)
    plain = ref.DCAE(c)
    plain.load_state_dict(sd)
    x = torch.rand(2, 128, 128, 3)
    with torch.no_grad():
        y = plain.g_a(x)
        assert torch.allclose(prog.analysis(x), y, atol=1e-5, rtol=1e-5)
        z = plain.h_a(y)
        assert torch.allclose(prog.hyper_analysis(y), z, atol=1e-5,
                              rtol=1e-5)
        ls, lm = plain.hyper_prior(z)
        pls, plm = prog.hyper_synthesis(z)
        assert torch.allclose(pls, ls, atol=1e-5, rtol=1e-5)
        prev = []
        for i, ys in enumerate(y.split(plain.slice_dim, dim=-1)):
            sup, mu, sig = plain.slice_context(i, ls, lm, prev)
            psup, pmu, psig = prog._slice_context(i, ls, lm, prev,
                                                  *y.shape[1:3])
            assert torch.allclose(pmu, mu, atol=1e-5, rtol=1e-5)
            assert torch.allclose(psig, sig, atol=1e-5, rtol=1e-5)
            q = torch.round(ys - mu) + mu
            assert torch.allclose(prog._slice_lrp(i, psup, q),
                                  plain.lrp(i, sup, q), atol=1e-5)
            prev.append(q + plain.lrp(i, sup, q))
        y_hat = torch.cat(prev, dim=-1)
        assert torch.allclose(prog.synthesis(y_hat), plain.g_s(y_hat),
                              atol=1e-5, rtol=1e-5)
    # one training step's loss and gradients under the program's noise
    from dcae_tpu_torch.train.step import make_loss_fn

    gen = torch.Generator().manual_seed(5)
    loss, met = make_loss_fn(prog, 0.0483)(x, gen)
    loss.backward()
    gen = torch.Generator().manual_seed(5)
    noise = [torch.rand(s, generator=gen) for s in
             train_check.noise_shapes(c, 2, 128, 128)]
    xh, yl, zl = plain.forward_train(x, noise)
    rl, _, _ = ref.rd_loss(xh, yl, zl, x, 0.0483)
    total = rl + plain.entropy_bottleneck.aux_loss()
    total.backward()
    assert math.isclose(float(loss.detach()), float(total.detach()),
                        rel_tol=1e-5)
    pg = dict(prog.named_parameters())
    top = max(float(p.grad.abs().max()) for p in plain.parameters())
    for n, p in plain.named_parameters():
        # to the largest gradient: some leaves' are nought to rounding
        assert torch.allclose(pg[n].grad, p.grad, atol=1e-5 * top,
                              rtol=1e-3), n


def test_tables_and_decoders_read_the_programs_streams(tiny_cfg):
    from dcae_tpu_torch.entropy import rans
    from dcae_tpu_torch.models.codec import DCAECodec
    from harness import weights
    from reference import codec_check
    from reference import entropy as E

    c = dataclasses.asdict(tiny_cfg)
    sd = weights.make(c, 21, "cpu")
    codec = DCAECodec(tiny_cfg, params=sd, device="cpu", patch_cap=4096)
    codec.update()
    t = codec_check.Tables(c, sd)
    g, f = codec.tables.gaussian, codec.tables.factorized
    assert np.array_equal(t.gauss.cdf, g.quantized_cdf)
    assert np.array_equal(t.gauss.length, g.cdf_length)
    assert np.array_equal(t.gauss.offset, g.offset)
    assert np.array_equal(t.fact.cdf, f.quantized_cdf)
    assert np.array_equal(t.fact.offset, f.offset)
    rng = np.random.default_rng(1)
    for _ in range(5):
        pmf = rng.dirichlet(np.full(40, 0.3)).astype(np.float32)
        pmf[rng.integers(0, 40, 5)] = 0
        assert np.array_equal(E.pmf_to_quantized_cdf(pmf),
                              rans.pmf_to_quantized_cdf(pmf, 16))
    cap = {}
    fn = codec.model.decode_device_streams

    def keep(*a, **k):
        cap["out"] = fn(*a, **k)
        return cap["out"]

    x = (rng.uniform(0, 1, (2, 128, 128, 3)) * 255).astype(np.uint8)
    enc = codec.compress_device(x)
    codec.model.decode_device_streams = keep
    dec = codec.decompress_interleaved(enc)
    assert bool(dec["ok"])
    _, _, idxs, syms = cap["out"]
    zh, zw = enc["shape"]
    z_index = np.repeat(np.arange(c["eb_channels"]), zh * zw)
    for b, s in enumerate(enc["z_strings"]):
        want = rans.decode_with_indexes(s, z_index, f.quantized_cdf,
                                        f.cdf_length, f.offset)
        assert np.array_equal(E.decode_classic(s, z_index, t.fact), want)
    x_ = np.asarray(enc["states"]).astype(np.int64)
    for s in range(c["num_slices"]):
        w = np.frombuffer(enc["istreams"][s], np.uint16)
        got, x_, ptr = E.decode_lanes(w, x_, idxs[s].numpy().reshape(-1),
                                      t.gauss, t.lut)
        pos, val = enc["patches"][s]
        got[pos] = val
        assert ptr == len(w)
        assert np.array_equal(got, syms[s].numpy().reshape(-1))
    assert (x_ == E.RANS_L16).all()


def test_counters_against_hand_worked_values():
    from harness import yardstick as Y

    f, b = Y.window_block_work(64, 96, 12, "bfloat16")
    assert f == 64 * (8 * 96 * 96 + 256 * 96) == 6291456
    assert b == (2 * 64 * 96 + 4 * 96 * 96 + 4 * 96 + 3 * 96
                 + 12 * 225) * 2
    f, b = Y.glu_work(10, 256, 512, "float32")
    assert f == 10 * (6 * 256 * 512 + 18 * 512) == 7956480
    assert b == (2 * 10 * 256 + 2 * 256 + 2 * 256 * 512 + 2 * 512
                 + 10 * 512 + 512 * 256 + 256) * 4
    assert Y.least_time(989e12, 0, "bfloat16") == 1.0
    assert Y.least_time(495e12, 0, "float32") == 1.0
    assert Y.least_time(1.0, 3.35e12, "float32") == 1.0
    import json
    c = json.load(open(os.path.join(
        BENCH, "configs", "dcae-n192m320-bf16.json")))["model"]
    codec = Y.stack_launches(c, 8, 512, 768, "bfloat16", 2)
    train = Y.stack_launches(c, 8, 256, 256, "float32", 1)
    # the launches the program's counters count (PERF.md): 30 / 34 a
    # compress + decompress, 30 / 29 a training step
    assert (len(codec["wmsa"]), len(codec["glu"])) == (30, 34)
    assert (len(train["wmsa"]), len(train["glu"])) == (30, 29)
    assert Y.region("void wmsa_tf32_kernel<1>(float)") == "wmsa_kernel"
    assert Y.region("rans_lanes_decode_kernel") == "rans_lanes_kernel"
    assert Y.region("sm80_xmma_fprop_implicit_gemm_f32f32") == "conv_cudnn"
    # FlopCounterMode's convention, on one convolution: 2 x MACs
    from torch.utils.flop_counter import FlopCounterMode
    conv = torch.nn.Conv2d(3, 8, 5, stride=2, padding=2)
    with FlopCounterMode(display=False) as fc:
        conv(torch.zeros(1, 3, 16, 16))
    assert fc.get_total_flops() == 2 * 8 * 8 * 8 * 3 * 25
