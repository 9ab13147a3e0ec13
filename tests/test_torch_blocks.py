"""The port's modules against the JAX package's Flax modules on the same
weights: each Flax module is initialized, its parameters are carried across
with dcae_tpu_torch.utils.convert.FlaxToTorch and loaded with strict=True,
and both run the same numpy input in f32 on the CPU.

Tolerance: f32 on both sides with different summation orders; outputs are
O(1), so atol 5e-5 (relative 1e-5) covers the rounding and catches any
layout, geometry or wiring fault, which shows at O(1e-2) or more.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcae_tpu.config import DCAEConfig as JaxConfig
from dcae_tpu.models import transforms as jt
from dcae_tpu.ops import blocks as jb
from dcae_tpu.ops import dictionary as jd
from dcae_tpu.ops import layers as jl
from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.models import transforms as tt
from dcae_tpu_torch.ops import blocks as tb
from dcae_tpu_torch.ops import dictionary as td
from dcae_tpu_torch.ops import layers as tl
from dcae_tpu_torch.utils.convert import FlaxToTorch

ATOL = 5e-5


def _run_both(flax_module, port_module, emit, *inputs, seed=0):
    """Init the Flax module on `inputs`, carry its params into the port
    module (strict load), return (flax_out, port_out) as numpy."""
    jin = [jnp.asarray(a) for a in inputs]
    variables = flax_module.init(jax.random.PRNGKey(seed), *jin)
    params = jax.tree.map(np.asarray, variables["params"])
    e = FlaxToTorch()
    emit(e, "m", params)
    sd = {k[2:]: torch.from_numpy(v.copy()) for k, v in e.out.items()}
    port_module.load_state_dict(sd, strict=True)
    port_module.eval()
    want = np.asarray(flax_module.apply(variables, *jin))
    with torch.no_grad():
        got = port_module(*(torch.from_numpy(a) for a in inputs)).numpy()
    assert got.shape == want.shape
    return want, got


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("kind,k,s,shape", [
    ("conv", 5, 2, (1, 12, 10, 4)),
    ("conv", 5, 2, (1, 11, 9, 4)),      # odd sizes: torch stride-2 geometry
    ("deconv", 5, 2, (1, 6, 5, 4)),
    ("deconv", 3, 2, (1, 3, 2, 4)),
])
def test_conv_deconv_geometry(kind, k, s, shape):
    if kind == "conv":
        fm = jl.Conv(8, k, stride=s)
        pm = tl.Conv(4, 8, k, stride=s)
        emit = lambda e, d, p: e.conv(d, p)  # noqa: E731
    else:
        fm = jl.Deconv(8, k, s)
        pm = tl.Deconv(4, 8, k, s)
        emit = lambda e, d, p: e.deconv(d, p)  # noqa: E731
    want, got = _run_both(fm, pm, emit, _x(shape))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("unit", ["rbb_skip", "stride", "upsample"])
def test_residual_bottleneck_units(unit):
    if unit == "rbb_skip":
        fm, pm = jb.ResidualBottleneckBlock(8), tb.ResidualBottleneckBlock(4,
                                                                           8)
        emit = lambda e, d, p: e.rbb(d, p)  # noqa: E731
        x = _x((1, 8, 8, 4))
    elif unit == "stride":
        fm = jb.ResidualBottleneckBlockWithStride(8)
        pm = tb.ResidualBottleneckBlockWithStride(4, 8)
        emit = lambda e, d, p: e.rbb_stride(d, p)  # noqa: E731
        x = _x((1, 16, 12, 4))
    else:
        fm = jb.ResidualBottleneckBlockWithUpsample(3)
        pm = tb.ResidualBottleneckBlockWithUpsample(8, 3)
        emit = lambda e, d, p: e.rbb_upsample(d, p)  # noqa: E731
        x = _x((1, 6, 8, 8))
    want, got = _run_both(fm, pm, emit, x)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("C,head_dim,window,block_num,hw", [
    (32, 8, 8, 2, (16, 16)),     # W + SW through wmsa_block
    (32, 8, 8, 4, (16, 24)),     # scanned pairs in Flax -> layers.0..3
    (128, 32, 8, 2, (8, 16)),    # the GLU through conv_glu (C % 128 == 0)
    (16, 8, 4, 1, (2, 3)),       # window-4 hyper stack, pad + crop
])
def test_swin_stack(C, head_dim, window, block_num, hw):
    fm = jb.SwinStack(head_dim, window, block_num)
    pm = tb.SwinStack(C, head_dim, window, block_num)
    emit = lambda e, d, p: e.swin_stack(d, p, block_num)  # noqa: E731
    want, got = _run_both(fm, pm, emit, _x((1, *hw, C)))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("head_num,head_dim", [(2, 8), (4, 32)])
def test_dictionary_cross_attention(head_num, head_dim):
    """(4, 32): d = 128, so the GLU runs through conv_glu."""
    d = head_num * head_dim
    fm = jd.DictionaryCrossAttention(output_dim=20, head_num=head_num,
                                     head_dim=head_dim)
    pm = td.DictionaryCrossAttention(40, 20, head_num=head_num,
                                     head_dim=head_dim)
    emit = lambda e, dst, p: e.dict_attention(dst, p)  # noqa: E731
    want, got = _run_both(fm, pm, emit, _x((1, 8, 8, 40)),
                          _x((8, d), seed=2))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_slice_net():
    jcfg, cfg = JaxConfig.tiny(), DCAEConfig.tiny()
    fm, pm = jt.SliceNet(jcfg), tt.SliceNet(cfg, cfg.support_dim(2))
    emit = lambda e, d, p: e.slice_net(d, p)  # noqa: E731
    want, got = _run_both(fm, pm, emit, _x((1, 4, 6, cfg.support_dim(2))))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("zhw", [(2, 2), (1, 1)])
def test_hyper_synthesis(zhw):
    """(1, 1): the window-4 stack sees 2x2 and pads to its window."""
    kw = dict(window_size=8, hyper_window_size=4)
    jcfg, cfg = JaxConfig.tiny(**kw), DCAEConfig.tiny(**kw)
    fm, pm = jt.HyperSynthesis(jcfg), tt.HyperSynthesis(cfg)
    emit = lambda e, d, p: e.hyper_synthesis(d, p)  # noqa: E731
    want, got = _run_both(fm, pm, emit, _x((1, *zhw, cfg.eb_channels)))
    np.testing.assert_allclose(got, want, atol=ATOL)
