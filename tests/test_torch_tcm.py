"""TCM in the port against its plain reference (tests/torch_tcm_reference.py)
on the CPU, tiny widths (TCMConfig.tiny: windows 8 / 4, so 256 px
images):

- each layer and block (GDN / IGDN, the NHWC sub-pixel shuffle,
  ResidualBlockWithStride / ResidualBlockUpsample, ConvTransBlock at
  both windows, SWAtten) and the whole training forward under the same
  noise, within F32_TOL of the largest value; the same forward with
  bf16 transforms misses that tolerance;
- one state dict loads strictly both ways, under the published names;
- the classic and the interleaved codec decode exactly the symbols the
  forward quantised, and x_hat is the reference's g_s of the decoded
  latent;
- one make_train_step step's loss is the reference's;
- the tcm.mix and tcm.swatten spans are recorded with a sink and not
  without one, and the streams are the same either way.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from dcae_tpu_torch.config import TCMConfig
from dcae_tpu_torch.models.base import build_model
from dcae_tpu_torch.models.codec import DCAECodec
from dcae_tpu_torch.models.tcm import TCM
from dcae_tpu_torch.ops import tcm_blocks as tb
from dcae_tpu_torch.utils import profiling
from tests import torch_tcm_reference as R

# max |port - reference| / max |reference| in f32: summation order only
# (the CPU runs the window kernel's and the convolutions' plain
# statements); 1e-4 leaves two orders of room over the 2e-7 - 3e-6 seen
F32_TOL = 1e-4
CFG = TCMConfig.tiny()
C = dataclasses.asdict(CFG)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops beside other test processes: one intra-op thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


@torch.no_grad()
def _perturb(module, seed: int) -> None:
    """Every parameter moved off its initial value (GDN's identity, unit
    LN scales), so that the comparison sees each one."""
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


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_against_the_reference(inverse):
    port, ref = _pair(tb.GDN(16, inverse=inverse), R.GDN(16, inverse))
    x = _x((2, 8, 8, 16))
    with torch.no_grad():
        assert _rel(port(x), _nhwc(ref(_nchw(x)))) <= F32_TOL
    # the published initial values: beta 1, gamma 0.1 I (effective)
    fresh = tb.GDN(4)
    eff = lambda p, b: torch.clamp_min(p, b) ** 2 - tb.PEDESTAL  # noqa
    assert torch.allclose(eff(fresh.beta, fresh.beta_bound), torch.ones(4))
    assert torch.allclose(eff(fresh.gamma, fresh.gamma_bound),
                          0.1 * torch.eye(4), atol=1e-9)


def test_subpel_shuffle_on_nhwc_is_pixel_shuffle():
    x = _x((2, 5, 7, 12))
    want = torch.nn.PixelShuffle(2)(_nchw(x))
    assert torch.equal(tb.PixelShuffle(2)(x), _nhwc(want))


BLOCKS = {
    "stride": (lambda: tb.ResidualBlockWithStride(12, 16),
               lambda: R.ResidualBlockWithStride(12, 16), (2, 16, 16, 12)),
    "upsample": (lambda: tb.ResidualBlockUpsample(12, 16),
                 lambda: R.ResidualBlockUpsample(12, 16), (2, 8, 8, 12)),
    "mix-w8": (lambda: tb.ConvTransBlock(8, 8, 4, 8),
               lambda: R.ConvTransBlock(8, 8, 4, 8, "W"), (2, 16, 24, 16)),
    "mix-sw8": (lambda: tb.ConvTransBlock(8, 8, 4, 8, shifted=True),
                lambda: R.ConvTransBlock(8, 8, 4, 8, "SW"), (2, 16, 24, 16)),
    "mix-sw4": (lambda: tb.ConvTransBlock(8, 8, 4, 4, shifted=True),
                lambda: R.ConvTransBlock(8, 8, 4, 4, "SW"), (2, 8, 12, 16)),
    "swatten": (lambda: tb.SWAtten(24, 4, 8, 8),
                lambda: R.SWAtten(24, 4, 8, 8), (2, 16, 24, 24)),
}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_against_the_reference(kind):
    make_port, make_ref, shape = BLOCKS[kind]
    port, ref = _pair(make_port(), make_ref())
    x = _x(shape)
    with torch.no_grad():
        assert _rel(port(x), _nhwc(ref(_nchw(x)))) <= F32_TOL


def test_swatten_refuses_a_latent_no_larger_than_the_window():
    with pytest.raises(ValueError, match="256 px"):
        tb.SWAtten(24, 4, 8, 8)(torch.zeros(1, 8, 16, 24))


def test_state_dicts_load_both_ways_under_the_published_names():
    port = TCM(CFG)
    port.reset_parameters(torch.Generator().manual_seed(0))
    ref = R.TCM(C)
    ref.load_state_dict(port.state_dict(), strict=True)
    port.load_state_dict(ref.state_dict(), strict=True)
    names = set(port.state_dict())
    assert {"g_a.0.conv1.weight", "g_a.0.gdn.gamma", "g_a.0.skip.weight",
            "g_a.1.conv1_1.weight", "g_a.2.trans_block.msa."
            "relative_position_params", "g_a.1.trans_block.mlp.2.bias",
            "g_a.9.weight", "g_s.0.subpel_conv.0.weight",
            "g_s.0.igdn.beta", "g_s.9.0.weight", "h_a.1.conv_block.conv2."
            "bias", "h_mean_s.3.0.weight", "h_scale_s.0.upsample.0.bias",
            "atten_mean.0.0.in_conv.weight",
            "atten_scale.4.0.non_local_block.block_2.ln1.weight",
            "atten_mean.2.0.conv_a.2.conv.4.weight",
            "atten_mean.1.0.conv_b.3.weight",
            "cc_mean_transforms.0.0.weight", "lrp_transforms.4.4.bias",
            "entropy_bottleneck.quantiles"} <= names
    assert not any("unit_scale" in n for n in names)
    assert isinstance(build_model(CFG), TCM)


def _noise(x, seed):
    """The training noise the port draws from `seed`, in its order."""
    g = torch.Generator().manual_seed(seed)
    B, H, W, _ = x.shape
    shapes = [(B, H // 64, W // 64, C["eb_channels"])] + \
        [(B, H // 16, W // 16, CFG.slice_dim)] * CFG.num_slices
    return [torch.rand(s, generator=g) for s in shapes]


def _models(seed=0):
    ref = R.TCM(C)
    _perturb(ref, seed)
    port = TCM(CFG)
    port.load_state_dict(ref.state_dict(), strict=True)
    return port, ref


def test_training_forward_against_the_reference_and_bf16_misses():
    port, ref = _models()
    x = torch.rand(1, 256, 256, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        out = port(x, training=True,
                   generator=torch.Generator().manual_seed(3))
        xh, yl, zl = ref.forward_train(x, _noise(x, 3))
        errs = [_rel(out["x_hat"], xh), _rel(out["likelihoods"]["y"], yl),
                _rel(out["likelihoods"]["z"], zl)]
        assert max(errs) <= F32_TOL, errs
        # the precision the configuration states matters: bf16 transforms
        # miss the f32 tolerance by orders of magnitude
        port.set_transform_dtype(torch.bfloat16)
        low = port(x, training=True,
                   generator=torch.Generator().manual_seed(3))
        assert _rel(low["x_hat"], xh) > 10 * F32_TOL


def _codec():
    port, ref = _models(4)
    codec = DCAECodec(CFG, params=port.state_dict(), device="cpu",
                      patch_cap=1 << 20)
    codec.update()
    return codec, ref


def _images(seed=5):
    return (np.random.default_rng(seed).uniform(0, 1, (2, 256, 256, 3))
            * 255).astype(np.uint8)


def test_classic_and_interleaved_decode_the_forwards_symbols():
    codec, ref = _codec()
    x = _images()
    with torch.no_grad():
        para = codec.model(torch.from_numpy(x).float() / 255.0)["para"]
    want = torch.round(para["y"] - para["means"]).to(torch.int32).numpy()
    latents = []
    synth = codec.model.decode_synthesis
    codec.model.decode_synthesis = lambda y: latents.append(y) or synth(y)
    rec_enc, rec_dec = [], []
    enc = codec.compress(x, record=rec_enc)
    dec = codec.decompress(enc["strings"], enc["shape"], record=rec_dec)
    assert np.array_equal(np.concatenate([s for _, s in rec_dec], -1), want)
    assert all(np.array_equal(a[1], b[1]) for a, b in zip(rec_enc, rec_dec))
    with torch.no_grad():
        x_ref = torch.clamp(ref.g_s(latents[-1]), 0, 1)
    assert _rel(dec["x_hat"], x_ref) <= F32_TOL
    ienc = codec.compress_device(x)
    idec = codec.decompress_interleaved(ienc)
    assert bool(idec["ok"])
    # the same latent, so the same symbols
    assert torch.equal(idec["x_hat"], dec["x_hat"])


def test_one_train_step_loss_is_the_references():
    from dcae_tpu_torch.train.state import create_train_state, make_optimizer
    from dcae_tpu_torch.train.step import make_train_step

    port, ref = _models(6)
    x = torch.rand(2, 256, 256, 3, generator=torch.Generator().manual_seed(7))
    tx = make_optimizer(1e-4)
    state = create_train_state(port, tx, torch.Generator().manual_seed(8))
    before = port.g_a[0].gdn.gamma.detach().clone()
    state, met = make_train_step(port, tx, 0.0483)(state, x)
    xh, yl, zl = ref.forward_train(x, _noise(x, 8))
    bpp = (torch.log(yl).sum() + torch.log(zl).sum()) / (
        -math.log(2) * 2 * 256 * 256)
    rd = 0.0483 * 255 ** 2 * torch.mean((xh - x) ** 2) + bpp
    assert math.isclose(float(met["loss"]), float(rd.detach()), rel_tol=1e-5)
    assert math.isclose(float(met["aux_loss"]),
                        float(ref.entropy_bottleneck.aux_loss().detach()),
                        rel_tol=1e-5)
    assert state.step == 1
    assert not torch.equal(port.g_a[0].gdn.gamma, before)


class _Spans(profiling.Sink):
    def __init__(self):
        self.names = []

    def span(self, name, start, end):
        self.names.append(name)


def test_spans_with_a_sink_and_not_without():
    codec, _ = _codec()
    x = _images(9)
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
    # g_a 6 and h_a 2 mixed blocks, two passes of the hyper synthesis (4
    # each) and g_s 6; two SWAtten a slice, in both passes
    assert sink.names.count("tcm.mix") == 6 + 2 + 2 * 4 + 6
    assert sink.names.count("tcm.swatten") == 2 * 2 * CFG.num_slices
    assert after.names == []


@pytest.mark.slow
def test_full_width_forward_against_the_reference():
    cfg = TCMConfig()
    c = dataclasses.asdict(cfg)
    ref = R.TCM(c)
    port = TCM(cfg)
    port.load_state_dict(ref.state_dict(), strict=True)
    assert sum(p.numel() for p in port.parameters()) == 76_568_148
    x = torch.rand(1, 256, 256, 3, generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        out = port(x, training=True, generator=g)
        xh, yl, zl = ref.forward_train(x, _noise_full(x, cfg, c, 2))
    assert _rel(out["x_hat"], xh) <= F32_TOL
    assert _rel(out["likelihoods"]["y"], yl) <= F32_TOL


def _noise_full(x, cfg, c, seed):
    g = torch.Generator().manual_seed(seed)
    B, H, W, _ = x.shape
    shapes = [(B, H // 64, W // 64, c["eb_channels"])] + \
        [(B, H // 16, W // 16, cfg.slice_dim)] * cfg.num_slices
    return [torch.rand(s, generator=g) for s in shapes]
