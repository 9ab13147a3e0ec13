"""The conv2d_nhwc route on the CPU: which convolutions of the model go
through the wrapper, and that on the CPU they run exactly the ops the
layers ran before it (F.conv2d on the channels-last view, then the
activation), bitwise. The CUDA kernel itself is held to the plain statement
on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import collections

import pytest
import torch
import torch.nn.functional as F
from torch import nn

import dcae_tpu_torch.ops.layers as layers
from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.ops.kernels import conv2d_nhwc as cv

# routed convolutions of one pass of the entropy side, by top-level module:
# 3 per slice net, 8 per dictionary attention (s, 3 x in_trans,
# 3 x out_trans, proj), 10 per hyper synthesis (its stack's conv and three
# bottlenecks), with 5 slices
ENTROPY_PASS = {"cc_mean_transforms": 15, "cc_scale_transforms": 15,
                "lrp_transforms": 15, "dt_cross_attention": 40,
                "h_z_s1": 10, "h_z_s2": 10}
# the f32 transforms' stride-1 convolutions: three bottlenecks of three
# convs a down- or upsample unit and one conv a Swin stack
F32_TRANSFORMS = {"g_a": 30, "g_s": 30, "h_a": 10}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops beside other test processes: one intra-op thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _model(cfg):
    model = DCAE(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    if cfg.compute_dtype == "bfloat16":
        model.set_transform_dtype(torch.bfloat16)
    return model


def _image(size):
    return torch.rand((1, size, size, 3),
                      generator=torch.Generator().manual_seed(1))


@pytest.fixture
def routed(monkeypatch):
    """Records the top-level module of every convolution `routes` sends to
    conv2d_nhwc; call it with the model first."""
    seen = collections.Counter()
    owner = {}
    real = layers.routes

    def record(conv, x):
        taken = real(conv, x)
        if taken:
            seen[owner[id(conv)]] += 1
        return taken

    def watch(model):
        owner.update({id(m): name.split(".")[0]
                      for name, m in model.named_modules()})
        return seen

    monkeypatch.setattr(layers, "routes", record)
    return watch


@pytest.mark.parametrize("cfg,size", [
    (DCAEConfig.tiny(compute_dtype="bfloat16"), 64),
    (DCAEConfig(compute_dtype="bfloat16"), 64)], ids=["tiny", "full"])
def test_a_pass_routes_the_entropy_side_only(routed, cfg, size):
    """bf16 transforms: a forward routes the 105 f32 convolutions of the
    entropy side (45 slice nets, 40 dictionary attention, 20 hyper
    synthesis) and none of g_a, h_a, g_s."""
    model = _model(cfg)
    seen = routed(model)
    with torch.no_grad():
        model(_image(size))
    assert dict(seen) == ENTROPY_PASS
    assert sum(seen.values()) == 105


def test_f32_transforms_route_their_stride1_convolutions(routed):
    model = _model(DCAEConfig.tiny())
    seen = routed(model)
    with torch.no_grad():
        model(_image(64))
    assert dict(seen) == {**ENTROPY_PASS, **F32_TRANSFORMS}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nothing_routes_under_grad(routed, dtype):
    """A training forward wants gradients: every convolution keeps cuDNN's
    path, with or without a generator's noise."""
    model = _model(DCAEConfig.tiny(compute_dtype=dtype))
    seen = routed(model)
    out = model(_image(64), training=True,
                generator=torch.Generator().manual_seed(2))
    assert out["x_hat"].requires_grad
    assert sum(seen.values()) == 0


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_model_output_unchanged(monkeypatch, dtype, training):
    """The whole model on the CPU, with the route as it is and with every
    convolution sent down the layers' own path (nn.Conv2d, then the
    activation module or function): bitwise the same outputs."""
    model = _model(DCAEConfig.tiny(compute_dtype=dtype))
    x = _image(64)

    def run():
        gen = torch.Generator().manual_seed(3) if training else None
        with torch.set_grad_enabled(training):
            out = model(x, training=training, generator=gen)
        return [out["x_hat"], out["likelihoods"]["y"],
                out["likelihoods"]["z"], out["para"]["means"],
                out["para"]["scales"], out["para"]["y_hat"]]

    got = run()
    monkeypatch.setattr(layers, "routes", lambda conv, x: False)
    want = run()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("act", ["none", "gelu", "relu"])
@pytest.mark.parametrize("k", [1, 3])
def test_plain_statement_is_the_modules_ops(k, act, bias):
    """On the CPU the wrapper, and a routed Conv, equal nn.Conv2d on the
    channels-last view followed by nn.GELU / F.relu / nothing, bitwise;
    the CPU launches nothing."""
    torch.manual_seed(4)
    conv = layers.Conv(12, 20, k, bias=bias)
    x = torch.randn(2, 7, 9, 12)
    after = {"none": lambda t: t, "gelu": nn.GELU(), "relu": F.relu}[act]
    with torch.no_grad():
        want = after(nn.Conv2d.forward(conv, x.permute(0, 3, 1, 2))
                     .permute(0, 2, 3, 1))
        assert cv.routes(conv, x)
        before = cv.conv2d_nhwc.launches
        assert torch.equal(cv.conv2d_nhwc(x, conv.weight, conv.bias,
                                          act=act), want)
        assert torch.equal(conv(x, act=act), want)
        assert cv.conv2d_nhwc.launches == before


@pytest.mark.parametrize("case", [
    dict(k=5), dict(stride=2), dict(groups=4), dict(dtype=torch.bfloat16),
    dict(grad=True), dict(k=7), dict(ok=True)])
def test_routes_takes_only_f32_stride1_1x1_3x3_without_grad(case):
    conv = layers.Conv(8, 8, case.get("k", 3), stride=case.get("stride", 1),
                       groups=case.get("groups", 1))
    x = torch.randn(1, 4, 4, 8)
    if "dtype" in case:
        conv, x = conv.to(case["dtype"]), x.to(case["dtype"])
    if case.get("grad"):
        assert not cv.routes(conv, x)            # the weight requires grad
        with torch.no_grad():
            assert cv.routes(conv, x)
        conv.requires_grad_(False)
        assert cv.routes(conv, x)
        assert not cv.routes(conv, x.requires_grad_())
        return
    with torch.no_grad():
        assert cv.routes(conv, x) == case.get("ok", False)


@pytest.mark.parametrize("c_in,k", [(6, 3), (32, 3), (40, 1), (64, 1),
                                    (213, 5)])
def test_packed_weight_is_the_kernels_k_order(c_in, k):
    """Two halves, each (C_out, k * k, C_in rounded up to 32): tap by tap,
    then channel, zeros past C_in. hi is a tf32 value (its low 13 mantissa
    bits zero), hi + lo is the weight exactly in f32; both are kept until
    the weight changes in place, then made anew."""
    w = torch.randn(5, c_in, k, k, generator=torch.Generator().manual_seed(5))
    hi, lo = p = cv.packed_weight(w)
    cp = -(-c_in // 32) * 32
    for half in p:
        assert half.shape == (5, k * k, cp) and half.is_contiguous()
        assert half.dtype == torch.float32
        assert not half[:, :, c_in:].any()
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert lo.abs().max() <= 2.0 ** -10 * hi.abs().max()
    for r in range(k):
        for s in range(k):
            assert torch.equal(hi[:, r * k + s, :c_in] + lo[:, r * k + s,
                                                              :c_in],
                               w[:, :, r, s])
    assert cv.packed_weight(w) is p
    with torch.no_grad():
        w.mul_(3)
    hi3, lo3 = cv.packed_weight(w)
    assert hi3 is not hi and lo3 is not lo
    assert torch.equal(hi3 + lo3, cv.pack_weight(w)[0] + cv.pack_weight(w)[1])
    assert torch.equal((hi3 + lo3)[:, :, :c_in],
                       3 * (hi + lo)[:, :, :c_in])


@pytest.mark.parametrize("value", [1.0, -1.5, 1 + 2.0 ** -12, 3e-39, 0.1,
                                   -7.123456e5])
def test_split_tf32_is_the_kernels_split(value):
    """hi keeps the sign, exponent and top 10 mantissa bits; lo = v - hi,
    exact: as the kernel's split_tf32 on the card."""
    v = torch.tensor([value], dtype=torch.float32)
    hi, lo = cv.split_tf32(v)
    bits = v.view(torch.int32)
    assert torch.equal(hi.view(torch.int32), bits & ~0x1FFF)
    assert torch.equal(hi + lo, v)
    assert torch.equal(lo, v - hi)


# (M, N): shapes of the codec cells (batch 8 of 768 x 512: the latent at
# 32 x 48, the hyper synthesis at 16 x 24) and the tile picked there
@pytest.mark.parametrize("M,N,tile", [
    (12288, 224, (192, 112)),   # the slice nets' first layers
    (12288, 128, (192, 64)),    # their second
    (12288, 64, (64, 64)),      # their third; TCM's SWAtten convolutions
    (12288, 640, (192, 112)),   # the dictionary attention's 1x1s
    (12288, 32, (64, 32)),      # ELIC's first channel and spatial contexts
    (3072, 96, (64, 32)),       # the hyper synthesis's 192 -> 96 1x1
    (3072, 192, (64, 64))])     # its stack's 3x3
def test_pick_tile_at_the_codec_cells_shapes(M, N, tile):
    """On a 132-SM H100, the tile picked at each shape: the one of the five
    the kernel was fastest with there (every tile timed on an H100)."""
    assert cv.TILES[cv.pick_tile(M, N, 132)] == tile


def test_slice_conv1_fills_the_card_in_one_wave():
    """The slice nets' first layers (M 12,288, N 224) make at most one tile
    an SM of a 132-SM H100."""
    bm, bn = cv.TILES[cv.pick_tile(12288, 224, 132)]
    assert -(-12288 // bm) * -(-224 // bn) <= 132


def test_tiles_are_warpgroup_shapes():
    """Each tile is 64 rows a consumer warpgroup, at most three of them, and
    a wgmma width (a multiple of 8 up to 112: an accumulator and a partial
    of BN / 2 registers each); TILE_COST gives each a cost."""
    assert len(cv.TILE_COST) == len(cv.TILES)
    for bm, bn in cv.TILES:
        assert bm in (64, 128, 192) and bn % 8 == 0 and 8 <= bn <= 112
    assert all(c > 0 for c in cv.TILE_COST)
    assert len(set(cv.TILES)) == len(cv.TILES)
