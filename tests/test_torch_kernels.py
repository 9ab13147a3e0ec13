"""The port's kernels (dcae_tpu_torch.ops.kernels) against the JAX
package's Pallas kernels, in interpret mode on the CPU (wmsa_attention's
parity tests are in tests/test_torch_wmsa_attention.py).

On the CPU a kernel wrapper runs its plain PyTorch statement, so these
tests hold that statement to the TPU kernel's math; the CUDA kernels are
held to the same statement on the card (tests/test_torch_cuda.py and
chip_smoke.py).

Tolerances: both sides compute in f32 with different summation orders and
erf implementations (the Pallas GLU uses an erf approximation with 1.5e-7
error), so f32 results agree to ~1e-6 of their scale: atol 3e-5 on O(1)
outputs, the bar the JAX package's own kernel tests use.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dcae_tpu.ops.pallas.conv_glu import fused_conv_glu
from dcae_tpu.ops.pallas.wmsa_v4 import _block_einsum_f32, fused_wmsa_block_v4
from dcae_tpu_torch.ops.kernels import conv2d_nhwc as cv
from dcae_tpu_torch.ops.kernels import conv_glu as cg
from dcae_tpu_torch.ops.kernels import wmsa_attention as wa
from dcae_tpu_torch.ops.kernels import wmsa_block as wm

ATOL = 3e-5


def _wmsa_params(rng, C, heads):
    """Flax-layout params of the attention half-block."""
    b = C ** -0.5
    return dict(
        ln_scale=1 + 0.1 * rng.normal(size=C),
        ln_bias=0.1 * rng.normal(size=C),
        rs=1 + 0.1 * rng.normal(size=C),
        wqkv=rng.uniform(-b, b, (C, 3 * C)),
        bqkv=rng.uniform(-b, b, 3 * C),
        wproj=rng.uniform(-b, b, (C, C)),
        bproj=rng.uniform(-b, b, C),
        rel=0.02 * rng.normal(size=(heads, 15, 15)),
    )


def _wmsa_torch_args(p):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa
    return (t(p["ln_scale"]), t(p["ln_bias"]), t(p["rs"]), t(p["wqkv"].T),
            t(p["bqkv"]), t(p["wproj"].T), t(p["bproj"]), t(p["rel"]))


def _wmsa_jax_args(p):
    j = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    return tuple(j(p[k]) for k in ("ln_scale", "ln_bias", "rs", "wqkv",
                                   "bqkv", "wproj", "bproj", "rel"))


@pytest.mark.parametrize("reference", ["pallas_v4", "einsum"])
@pytest.mark.parametrize("shifted", [False, True])
def test_wmsa_block_ref_matches_jax(shifted, reference):
    rng = np.random.default_rng(10)
    C, heads = 32, 4
    x = rng.normal(size=(1, 16, 16, C)).astype(np.float32)
    p = _wmsa_params(rng, C, heads)
    kw = dict(window=8, heads=heads, shifted=shifted)
    if reference == "pallas_v4":
        want = fused_wmsa_block_v4(jnp.asarray(x), *_wmsa_jax_args(p),
                                   interpret=True, **kw)
    else:
        want = _block_einsum_f32(jnp.asarray(x), *_wmsa_jax_args(p), **kw)
    got = wm.wmsa_block_ref(torch.from_numpy(x), *_wmsa_torch_args(p),
                            heads=heads, shifted=shifted)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_wmsa_block_bf16_rounding_points():
    """bf16 inputs: the plain statement rounds operands to bf16 where the
    TPU kernel does, and stays within bf16 noise of the f32 result."""
    rng = np.random.default_rng(11)
    C, heads = 32, 4
    x = torch.from_numpy(rng.normal(size=(1, 16, 16, C)).astype(np.float32))
    args = _wmsa_torch_args(_wmsa_params(rng, C, heads))
    f32 = wm.wmsa_block_ref(x, *args, heads=heads, shifted=True)
    bf = wm.wmsa_block_ref(x.bfloat16(), *(a.bfloat16() for a in args),
                           heads=heads, shifted=True)
    assert bf.dtype == torch.bfloat16
    err = float((bf.float() - f32).abs().max() / f32.abs().max())
    assert err <= 3e-2, err


def _glu_params(rng, C, h):
    """Flax-layout params of LN + ConvolutionalGLU (dwk as (3, 3, h))."""
    b1, b2 = C ** -0.5, h ** -0.5
    return dict(
        ln_scale=1 + 0.1 * rng.normal(size=C),
        ln_bias=0.1 * rng.normal(size=C),
        w1=rng.uniform(-b1, b1, (C, 2 * h)), b1=rng.uniform(-b1, b1, 2 * h),
        dwk=rng.uniform(-1 / 3, 1 / 3, (3, 3, h)),
        dwb=rng.uniform(-1 / 3, 1 / 3, h),
        w2=rng.uniform(-b2, b2, (h, C)), b2=rng.uniform(-b2, b2, C),
    )


def _glu_torch_args(p):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa
    h = p["dwb"].shape[0]
    return (t(p["ln_scale"]), t(p["ln_bias"]), t(p["w1"].T), t(p["b1"]),
            t(p["dwk"].transpose(2, 0, 1).reshape(h, 1, 3, 3)), t(p["dwb"]),
            t(p["w2"].T), t(p["b2"]))


@pytest.mark.parametrize("apply_ln", [True, False])
def test_conv_glu_ref_matches_pallas(apply_ln):
    """Includes the halo logic: tile_h=2 over H=8 gives the Pallas kernel
    interior tiles and both border tiles (zero padding in g-space)."""
    rng = np.random.default_rng(12)
    C, h = 16, 32
    x = rng.normal(size=(2, 8, 12, C)).astype(np.float32)
    p = _glu_params(rng, C, h)
    j = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    want = fused_conv_glu(
        j(x), j(p["ln_scale"]), j(p["ln_bias"]), j(p["w1"]), j(p["b1"]),
        j(p["dwk"]), j(p["dwb"]), j(p["w2"]), j(p["b2"]),
        apply_ln=apply_ln, interpret=True, tile_h=2)
    got = cg.conv_glu_ref(torch.from_numpy(x), *_glu_torch_args(p),
                          apply_ln=apply_ln)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("kernel", ["wmsa_block", "wmsa_attention",
                                    "conv_glu", "conv2d_nhwc"])
def test_wrapper_takes_plain_version_on_cpu(kernel):
    """A CPU tensor runs the plain statement (bitwise) and launches
    nothing; a tensor elsewhere than CPU or CUDA raises."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(size=(1, 8, 16, 32)).astype(np.float32))
    if kernel == "wmsa_block":
        args = _wmsa_torch_args(_wmsa_params(rng, 32, 4))
        fn, ref, kw = wm.wmsa_block, wm.wmsa_block_ref, dict(heads=4,
                                                           shifted=True)
    elif kernel == "wmsa_attention":
        # the block's weights without ln_w, ln_b, rs
        args = _wmsa_torch_args(_wmsa_params(rng, 32, 4))[3:]
        fn, ref, kw = wa.wmsa_attention, wa.wmsa_attention_ref, dict(
            heads=4, shifted=True)
    elif kernel == "conv_glu":
        args = _glu_torch_args(_glu_params(rng, 32, 64))
        fn, ref, kw = cg.conv_glu, cg.conv_glu_ref, dict(apply_ln=True)
    else:
        args = (torch.from_numpy(rng.normal(size=(24, 32, 3, 3)).astype(
            np.float32)), torch.from_numpy(rng.normal(size=24).astype(
                np.float32)))
        fn, ref, kw = cv.conv2d_nhwc, cv.conv2d_nhwc_ref, dict(act="gelu")
    before = fn.launches
    assert torch.equal(fn(x, *args, **kw), ref(x, *args, **kw))
    assert fn.launches == before
    with pytest.raises(ValueError):
        fn(x.to("meta"), *(a.to("meta") for a in args), **kw)


def test_conv_glu_kernel_widths():
    """The model routes a GLU through the kernel at the widths the TPU
    package did: stage 3 (256/512, bf16) and the DCA GLU (640/1280, f32),
    and only at widths the CUDA kernel of that dtype takes."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert cg.supported(256, 512, bf16) and cg.supported(640, 1280, f32)
    assert not cg.supported(96, 192, bf16)
    assert not cg.supported(144, 288, bf16)
    assert not cg.supported(640, 1280, bf16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routed_wmsa_widths_are_widths_the_kernel_takes(dtype):
    """Every window-8 width DCAEConfig() sends wmsa_block / wmsa_attention
    (the Swin stacks of g_a and g_s) and the card tests' 128 / 4 are widths
    the kernel of this dtype takes; so are narrower and odd head counts of
    the same rule; an untaken width raises ValueError naming it, whatever
    the device."""
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.transforms import GAnalysis, GSynthesis
    from dcae_tpu_torch.ops.blocks import WMSA

    dt = getattr(torch, dtype)
    cfg = DCAEConfig()
    routed = {(m.heads * m.head_dim, m.heads)
              for net in (GAnalysis(cfg), GSynthesis(cfg))
              for m in net.modules()
              if isinstance(m, WMSA) and m.window_size == wm.WINDOW}
    assert routed == {(96, 12), (144, 9), (256, 8)}
    for C, heads in routed | {(128, 4), (16, 2), (80, 5), (240, 10)}:
        assert wm.kernel_takes(C, heads, dt), (C, heads)
    assert not wm.kernel_takes(24, 3, dt)                # C % 16
    assert not wm.kernel_takes(64, 16, dt)               # head_dim 4
    assert not wm.kernel_takes(64, 1, dt)                # head_dim 64
    assert not wm.kernel_takes(320, 10, dt)              # C > 256
    assert not wm.kernel_takes(256, 8, torch.float16)
    rng = np.random.default_rng(42)
    C, heads = 8, 2                                      # head_dim 4
    x = torch.from_numpy(rng.normal(size=(1, 8, 8, C)).astype(np.float32))
    args = tuple(a.to(dt) for a in _wmsa_torch_args(_wmsa_params(rng, C,
                                                                  heads)))
    with pytest.raises(ValueError, match=f"C={C} with {heads} heads"):
        wm.launch("wmsa_block", x.to(dt), args, heads=heads, shifted=False)
    with pytest.raises(ValueError, match=f"C={C} with {heads} heads"):
        wm.launch("wmsa_attention", x.to(dt), args[3:], heads=heads,
                  shifted=True)
