"""ELIC in the port against its plain reference
(benchmark/reference/elic_model.py, loaded from the benchmark's folder)
on the CPU, tiny widths (ELICConfig.tiny: five uneven groups 2, 2, 4, 4,
8):

- each block (the residual bottleneck, the residual unit, the attention
  block, the checkerboard-masked convolution, a channel ramp) and the
  whole training forward under the same noise, within F32_TOL of the
  largest value; the same forward with bf16 transforms misses that
  tolerance;
- one state dict loads strictly both ways, under the published names;
  the ramps' widths are the published ones;
- the checkerboard's order (take / merge against a mask) and its
  causality: a non-anchor's latent moves no parameter of its own group;
- the classic and the interleaved codec decode exactly the symbols the
  forward quantised, and x_hat is the reference's g_s of the decoded
  latent; every encode mode writes one stream;
- the entropy pass on its graph's static buffers (the words padded, the
  patch list padded) and chained or not is bitwise the eager pass;
- one make_train_step step's loss is the reference's;
- the elic.transform spans are recorded with a sink and not without one.
"""

import dataclasses
import math
import os
import sys

import numpy as np
import pytest
import torch

from dcae_tpu_torch.config import ELICConfig
from dcae_tpu_torch.models import elic as E
from dcae_tpu_torch.models import entropy_graph as eg
from dcae_tpu_torch.models.base import build_model
from dcae_tpu_torch.models.codec import DCAECodec
from dcae_tpu_torch.ops import blocks
from dcae_tpu_torch.ops import elic_blocks as eb
from dcae_tpu_torch.ops.kernels import conv2d_nhwc as cv
from dcae_tpu_torch.utils import profiling

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
sys.path.insert(0, BENCH)
try:
    from reference import elic_model as R
finally:
    sys.path.remove(BENCH)

# max |port - reference| / max |reference| in f32: summation order only
# (the CPU runs the convolutions' plain statements, on NHWC views against
# the reference's NCHW); 1e-4 leaves two orders of room over the 1e-7 -
# 3e-6 seen. bf16 transforms miss it by orders of magnitude.
F32_TOL = 1e-4
CFG = ELICConfig.tiny()
C = dataclasses.asdict(CFG)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops beside other test processes: one intra-op thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max())


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


@torch.no_grad()
def _perturb(module, seed: int) -> None:
    """Every parameter moved off its initial value, so that the
    comparison sees each one."""
    g = torch.Generator().manual_seed(seed)
    for p in module.parameters():
        p.add_(0.05 * torch.randn(p.shape, generator=g))


def _pair(port, ref, seed=0):
    """The reference's parameters, perturbed, loaded into the port."""
    _perturb(ref, seed)
    port.load_state_dict(ref.state_dict(), strict=True)
    return port, ref


def _x(shape, seed=1):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


BLOCKS = {
    "bottleneck": (lambda: blocks.ResidualBottleneckBlock(12, 12),
                   lambda: R.ResidualBottleneckBlock(12), (2, 8, 8, 12)),
    "unit": (lambda: eb.ResidualUnit(12), lambda: R.ResidualUnit(12),
             (2, 8, 8, 12)),
    "attention": (lambda: eb.AttentionBlock(12),
                  lambda: R.AttentionBlock(12), (2, 8, 8, 12)),
    "checkerboard": (lambda: eb.CheckerboardConv(6, 12),
                     lambda: R.CheckerboardMaskedConv2d(6, 12),
                     (2, 8, 10, 6)),
    "ramp5": (lambda: eb.Ramp(10, 14, 16, 5), lambda: R.ramp(10, 14, 16, 5),
              (2, 8, 8, 10)),
    "ramp1": (lambda: eb.Ramp(40, 6, 24, 1), lambda: R.ramp(40, 6, 24, 1),
              (2, 8, 8, 40)),
}


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_against_the_reference(kind, grad):
    """Eval (the routed convolutions) and under autograd (cuDNN's path, the
    mask on the weight)."""
    make_port, make_ref, shape = BLOCKS[kind]
    port, ref = _pair(make_port(), make_ref())
    x = _x(shape)
    with torch.set_grad_enabled(grad):
        assert _rel(port(x), _nhwc(ref(_nchw(x)))) <= F32_TOL


def test_checkerboard_mask_runs_twelve_taps():
    """The masked convolution reads the taps with row + column odd only,
    on both paths: its weight's other taps change nothing, and a gradient
    reaches none of them."""
    conv = eb.CheckerboardConv(3, 4)
    x = _x((1, 7, 7, 3))
    mask = cv.tap_mask(5, "odd")
    assert int(mask.sum()) == 12 and mask[2, 2] == 0 and mask[0, 1] == 1
    with torch.no_grad():
        before = conv(x)
        conv.weight.add_(1.0 - mask)            # the masked-out taps only
        assert torch.equal(conv(x), before)
    conv(x).sum().backward()
    assert not conv.weight.grad[..., mask == 0].any()
    assert conv.weight.grad[..., mask == 1].abs().sum() > 0


def test_packed_weight_of_the_checkerboard_taps():
    """(C_out, 12, C_in rounded up to 32): the odd taps in row-major order,
    kept until the weight changes; the plain statement's masked copy
    too."""
    w = torch.randn(5, 6, 5, 5)
    p = cv.packed_weight(w, "odd")
    assert p.shape == (5, 12, 32)
    odd = [(r, s) for r in range(5) for s in range(5) if (r + s) % 2]
    for t, (r, s) in enumerate(odd):
        assert torch.equal(p[:, t, :6], w[:, :, r, s])
    assert cv.packed_weight(w, "odd") is p
    assert cv.packed_weight(w).shape == (5, 25, 32)
    m = cv.masked_weight(w, "odd")
    assert cv.masked_weight(w, "odd") is m
    assert torch.equal(m, w * cv.tap_mask(5, "odd"))
    with torch.no_grad():
        w.mul_(2)
    assert torch.equal(cv.masked_weight(w, "odd"), 2 * m)


def test_routes_takes_5x5_where_the_layer_asks():
    conv = eb.ContextConv(8, 8, 5)
    x = torch.randn(1, 4, 4, 8)
    with torch.no_grad():
        assert cv.routes(conv, x, sizes=(1, 3, 5))
        assert not cv.routes(conv, x)
        before = cv.conv2d_nhwc.launches
        want = cv.conv2d_nhwc_ref(x, conv.weight, conv.bias)
        assert torch.equal(conv(x), want)
        assert cv.conv2d_nhwc.launches == before     # the CPU launches none
    with pytest.raises(ValueError):
        cv.launch(x, conv.weight, conv.bias, act="none", taps="odd")
    with pytest.raises(ValueError):       # "odd" is 5x5 only
        cv.launch(x, conv.weight[..., 1:4, 1:4], conv.bias, act="none",
                  taps="odd")


def test_ramp_widths_are_the_published_ones():
    full = ELICConfig()
    with torch.device("meta"):
        m = E.ELIC(full)

    def widths(ramp):
        return [ramp[0].in_channels] + [ramp[i].out_channels
                                        for i in (0, 2, 4)]

    assert [widths(m.channel_context[f"y{k}"]) for k in range(1, 5)] == [
        [16, 192, 192, 32], [32, 192, 192, 64], [64, 192, 192, 128],
        [128, 213, 298, 384]]
    assert [widths(r) for r in m.entropy_parameters] == [
        [672, 458, 384, 32], [704, 480, 384, 32], [768, 533, 384, 64],
        [896, 640, 384, 128], [1408, 1066, 725, 384]]
    assert sum(p.numel() for p in m.parameters()) == 37_777_940
    assert isinstance(build_model(full), E.ELIC)


def test_state_dicts_load_both_ways_under_the_published_names():
    port = E.ELIC(CFG)
    port.reset_parameters(torch.Generator().manual_seed(0))
    ref = R.ELIC(C)
    ref.load_state_dict(port.state_dict(), strict=True)
    port.load_state_dict(ref.state_dict(), strict=True)
    names = set(port.state_dict())
    assert {"g_a.0.weight", "g_a.1.conv1.weight", "g_a.8.conv_a.2.conv.4.bias",
            "g_a.8.conv_b.3.weight", "g_a.14.conv_b.0.conv.2.weight",
            "g_s.0.conv_a.0.conv.0.weight", "g_s.1.weight", "g_s.14.bias",
            "h_a.0.weight", "h_a.4.weight", "h_s.0.weight", "h_s.4.bias",
            "channel_context.y1.0.weight", "channel_context.y4.4.bias",
            "context_prediction.0.weight", "context_prediction.4.bias",
            "entropy_parameters.0.0.weight", "entropy_parameters.4.4.bias",
            "entropy_bottleneck.quantiles"} <= names
    assert not any(n.endswith("mask") for n in names)


def test_take_and_merge_are_the_checkerboard():
    """take(., p) keeps, row by row, the columns whose row + column parity
    is p (anchors: even), the positions a mask picks; merge inverts it."""
    t = _x((2, 6, 8, 3))
    r = torch.arange(6)[:, None] + torch.arange(8)[None, :]
    for parity in (0, 1):
        want = t[:, r % 2 == parity].reshape(2, 6, 4, 3)
        assert torch.equal(E.take(t, parity), want)
    assert torch.equal(E.merge(E.take(t, 0), E.take(t, 1)), t)


def _models(seed=0):
    """The port's seeded init (the reference leaves its tensors empty),
    perturbed, in both."""
    port = E.ELIC(CFG)
    port.reset_parameters(torch.Generator().manual_seed(seed))
    ref = R.ELIC(C)
    ref.load_state_dict(port.state_dict(), strict=True)
    return _pair(port, ref, seed)


@torch.no_grad()
def test_a_non_anchor_moves_no_parameter_of_its_group():
    """With z_hat fixed: one non-anchor of group 2 moved changes no (mu,
    sigma) of groups 0-2, anchors or not, and some of group 3's (the
    channel context reads it); one anchor moved changes some non-anchor's
    of its group and no anchor's."""
    port, _ = _models(1)
    y = 3 * _x((1, 8, 8, CFG.M), 2)
    z_hat = torch.round(_x((1, 2, 2, CFG.eb_channels), 3))
    c0, c1 = port.bounds[2]

    def params(y):
        _, _, mu, sigma, _ = port.decode_half(y, z_hat)
        return mu, sigma

    mu, sigma = params(y)
    moved = y.clone()
    moved[0, 3, 4, c0] += 7.0                   # (3 + 4) odd: a non-anchor
    mu2, sigma2 = params(moved)
    for a, b in ((mu, mu2), (sigma, sigma2)):
        assert torch.equal(a[..., :c1], b[..., :c1])
        assert not torch.equal(a[..., c1:], b[..., c1:])
    moved = y.clone()
    moved[0, 3, 3, c0] += 7.0                   # an anchor
    mu3, _ = params(moved)
    anchor = (torch.arange(8)[:, None] + torch.arange(8)[None, :]) % 2 == 0
    assert torch.equal(mu[0][anchor][:, :c1], mu3[0][anchor][:, :c1])
    assert not torch.equal(mu[0][~anchor][:, c0:c1],
                           mu3[0][~anchor][:, c0:c1])


def _noise(port, x, seed):
    """The training noise the port draws from `seed`, in its order, as
    the reference takes it: z's, then y's whole map."""
    g = torch.Generator().manual_seed(seed)
    B, H, W, _ = x.shape
    z = torch.rand((B, H // 64, W // 64, CFG.eb_channels), generator=g)
    steps = [torch.rand((B, H // 16, W // 32, gk), generator=g)
             for gk in CFG.groups for _ in range(2)]
    return [z, port.step_map(steps)]


def test_training_forward_against_the_reference_and_bf16_misses():
    port, ref = _models()
    x = torch.rand(1, 128, 128, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        out = port(x, training=True,
                   generator=torch.Generator().manual_seed(3))
        xh, yl, zl = ref.forward_train(x, _noise(port, x, 3))
        errs = [_rel(out["x_hat"], xh), _rel(out["likelihoods"]["y"], yl),
                _rel(out["likelihoods"]["z"], zl)]
        assert max(errs) <= F32_TOL, errs
        port.set_transform_dtype(torch.bfloat16)
        low = port(x, training=True,
                   generator=torch.Generator().manual_seed(3))
        assert _rel(low["x_hat"], xh) > 10 * F32_TOL


def _codec(seed=4):
    port, ref = _models(seed)
    codec = DCAECodec(CFG, params=port.state_dict(), device="cpu",
                      patch_cap=1 << 20)
    codec.update()
    return codec, ref


def _images(seed=5, n=2):
    return (np.random.default_rng(seed).uniform(0, 1, (n, 128, 128, 3))
            * 255).astype(np.uint8)


def test_classic_and_interleaved_decode_the_forwards_symbols():
    codec, ref = _codec()
    model = codec.model
    x = _images()
    with torch.no_grad():
        para = model(torch.from_numpy(x).float() / 255.0)["para"]
    want = torch.round(para["y"] - para["means"]).to(torch.int32)
    latents = []
    synth = model.decode_synthesis
    model.decode_synthesis = lambda y: latents.append(y) or synth(y)
    rec_enc, rec_dec = [], []
    enc = codec.compress(x, record=rec_enc)
    dec = codec.decompress(enc["strings"], enc["shape"], record=rec_dec)
    assert len(rec_dec) == model.num_steps == 10
    got = model.step_map([torch.from_numpy(s) for _, s in rec_dec])
    assert torch.equal(got, want)
    assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(rec_enc, rec_dec))
    with torch.no_grad():
        x_ref = torch.clamp(ref.g_s(latents[-1]), 0, 1)
    assert _rel(dec["x_hat"], x_ref) <= F32_TOL
    for mode in ("split", "fused"):
        assert codec.compress(x, mode=mode)["strings"] == enc["strings"]
    shipped = codec.compress_with_indexes(x)
    assert [i.shape for i in shipped["indexes"]] == [
        (2, 8, 4, g) for g in CFG.groups for _ in range(2)]
    assert torch.equal(codec.decompress(shipped["strings"], shipped["shape"],
                                        indexes=shipped["indexes"])["x_hat"],
                       dec["x_hat"])
    for chain in (True, False):
        ienc = codec.compress_device(x, chain=chain)
        host = codec.compress_interleaved(x, chain=chain)
        assert ienc["istreams"] == host["istreams"]
        idec = codec.decompress_interleaved(ienc)
        assert bool(idec["ok"])
        assert torch.equal(idec["x_hat"], dec["x_hat"])
    assert codec.self_check() and codec.encode_mode == "split"


def test_a_corrupt_stream_is_caught():
    codec, _ = _codec(6)
    enc = codec.compress_device(_images(7))
    b = bytearray(enc["istreams"][9])
    b[len(b) // 2] ^= 0x5A
    enc["istreams"][9] = bytes(b)
    assert not bool(codec.decompress_interleaved(enc)["ok"])


@torch.no_grad()
def _pass_args(codec, x, override: bool, chained: bool) -> dict:
    common = dict(scale_table=codec._scale_table, chained=chained)
    if override:
        y, _, z_hat = codec.model.encode_analysis(codec._input(x))
        return dict(z_hat=z_hat, words=None, n_words=None, states=None,
                    patch_pos=None, patch_val=None, override=True, true_y=y,
                    lut_sym=None, lut_sf=None, **common)
    words, n_words, states, ppos, pval, luts, chained, z_hat = \
        codec._interleaved_inputs(codec.compress_device(x, chain=chained))
    return dict(z_hat=z_hat, words=words, n_words=n_words, states=states,
                patch_pos=ppos, patch_val=pval, override=False, true_y=None,
                lut_sym=luts[0], lut_sf=luts[1], **common)


def _flat(t):
    return list(t) if isinstance(t, tuple) else [t]


@pytest.mark.parametrize("chained", [False, True])
@pytest.mark.parametrize("override", [False, True])
def test_the_pass_on_static_buffers_is_the_eager_pass(override, chained):
    """The words padded to the largest step's bound, the patch list to its
    bucket, stale contents overwritten: the four outputs bitwise as the
    eager pass's, the steps' arrays a tuple of ten."""
    codec, _ = _codec(8)
    model = codec.model
    a = _pass_args(codec, _images(9, 1), override, chained)
    with torch.no_grad():
        want = model._entropy_pass(**a)
        bufs = eg.static_inputs(model.cfg, a)
        for b in bufs.values():
            b.fill_(3)
        got = model._entropy_pass(**eg.fill(bufs, a))
    assert bool(want[1])
    assert isinstance(want[2], tuple) and len(want[2]) == 10
    assert [t.shape for t in want[3]] == [
        (1, 8, 4, g) for g in CFG.groups for _ in range(2)]
    for g, w in zip(got, want):
        for gt, wt in zip(_flat(g), _flat(w)):
            assert gt.dtype == wt.dtype and torch.equal(gt, wt)
    if not override:
        # the bound: the largest step, the 8-channel group's non-anchors
        assert bufs["words"].shape[1] == eg.words_width(
            model.cfg, a["z_hat"]) == 8 * 4 * 8 + 1


def test_one_train_step_loss_is_the_references():
    from dcae_tpu_torch.train.state import create_train_state, make_optimizer
    from dcae_tpu_torch.train.step import make_train_step

    port, ref = _models(6)
    x = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(7))
    tx = make_optimizer(1e-4)
    state = create_train_state(port, tx, torch.Generator().manual_seed(8))
    before = port.context_prediction[0].weight.detach().clone()
    noise = _noise(port, x, 8)
    state, met = make_train_step(port, tx, 0.0483)(state, x)
    xh, yl, zl = ref.forward_train(x, noise)
    bpp = (torch.log(yl).sum() + torch.log(zl).sum()) / (
        -math.log(2) * 2 * 128 * 128)
    rd = 0.0483 * 255 ** 2 * torch.mean((xh - x) ** 2) + bpp
    assert math.isclose(float(met["loss"]), float(rd.detach()), rel_tol=1e-5)
    assert state.step == 1
    after = port.context_prediction[0].weight
    assert not torch.equal(after, before)
    # the masked taps take no update
    mask = cv.tap_mask(5, "odd")
    assert torch.equal(after[..., mask == 0], before[..., mask == 0])


class _Spans(profiling.Sink):
    def __init__(self):
        self.names = []

    def span(self, name, start, end):
        self.names.append(name)


def test_spans_with_a_sink_and_not_without():
    codec, _ = _codec(10)
    x = _images(11)
    base = codec.compress_device(x)
    sink = _Spans()
    with profiling.registered(sink):
        enc = codec.compress_device(x)
        dec = codec.decompress_interleaved(enc)
    after = _Spans()
    with profiling.registered(after):
        pass
    plain = codec.decompress_interleaved(base)
    assert enc["istreams"] == base["istreams"]
    assert torch.equal(dec["x_hat"], plain["x_hat"])
    # g_a and h_a in the encoder, g_s in the decoder
    assert sink.names.count("elic.transform") == 3
    assert after.names == []


@pytest.mark.slow
def test_full_width_forward_against_the_reference():
    cfg = ELICConfig()
    c = dataclasses.asdict(cfg)
    ref = R.ELIC(c)
    port = E.ELIC(cfg)
    port.load_state_dict(ref.state_dict(), strict=True)
    x = torch.rand(1, 128, 128, 3, generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        out = port(x, training=True, generator=g)
        gz = torch.Generator().manual_seed(2)
        z = torch.rand((1, 2, 2, cfg.eb_channels), generator=gz)
        steps = [torch.rand((1, 8, 4, gk), generator=gz)
                 for gk in cfg.groups for _ in range(2)]
        xh, yl, zl = ref.forward_train(x, [z, port.step_map(steps)])
    assert _rel(out["x_hat"], xh) <= F32_TOL
    assert _rel(out["likelihoods"]["y"], yl) <= F32_TOL
