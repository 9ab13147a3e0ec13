"""The port's CUDA kernels against their plain PyTorch statements, on the
card. Marked `cuda`: they skip without an NVIDIA GPU. This file imports no
JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances (max |kernel - plain| / max |plain|): f32 1e-4 (summation order
only), bf16 3e-2 (operands rounded to bf16 at the same points on both
sides; an accumulated sum that lands near a rounding boundary can flip one
bf16 ulp of an intermediate).
"""

import numpy as np
import pytest
import torch

from dcae_tpu_torch.ops.kernels import conv_glu as cg
from dcae_tpu_torch.ops.kernels import wmsa_attention as wa
from dcae_tpu_torch.ops.kernels import wmsa_block as wm

TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def _uniform(rng, shape, bound):
    return rng.uniform(-bound, bound, shape)


def _args(rng, dtype, shapes_and_scales):
    return [torch.from_numpy(np.asarray(f(rng, s), np.float32)).cuda()
            .to(dtype).contiguous() for s, f in shapes_and_scales]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,heads", [(128, 4), (96, 12)])
def test_wmsa_block_kernel(card, C, heads, dtype, shifted):
    rng = np.random.default_rng(14)
    dt = getattr(torch, dtype)
    b = C ** -0.5
    x = torch.from_numpy(rng.normal(size=(2, 16, 24, C)).astype(
        np.float32)).cuda().to(dt)
    args = _args(rng, dt, [
        ((C,), lambda r, s: 1 + 0.1 * r.normal(size=s)),
        ((C,), lambda r, s: 0.1 * r.normal(size=s)),
        ((C,), lambda r, s: 1 + 0.1 * r.normal(size=s)),
        ((3 * C, C), lambda r, s: _uniform(r, s, b)),
        ((3 * C,), lambda r, s: _uniform(r, s, b)),
        ((C, C), lambda r, s: _uniform(r, s, b)),
        ((C,), lambda r, s: _uniform(r, s, b)),
        ((heads, 15, 15), lambda r, s: 0.02 * r.normal(size=s)),
    ])
    before = wm.wmsa_block.launches
    got = wm.wmsa_block(x, *args, heads=heads, shifted=shifted)
    want = wm.wmsa_block_ref(x, *args, heads=heads, shifted=shifted)
    assert wm.wmsa_block.launches == before + 1
    assert _rel_err(got, want) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,heads", [(128, 4), (96, 12)])
def test_wmsa_attention_kernel(card, C, heads, dtype, shifted):
    """C=96 with 12 heads is head_dim 8: half an mma k-step in bf16."""
    rng = np.random.default_rng(16)
    dt = getattr(torch, dtype)
    b = C ** -0.5
    x = torch.from_numpy(rng.normal(size=(2, 16, 24, C)).astype(
        np.float32)).cuda().to(dt)
    args = _args(rng, dt, [
        ((3 * C, C), lambda r, s: _uniform(r, s, b)),
        ((3 * C,), lambda r, s: _uniform(r, s, b)),
        ((C, C), lambda r, s: _uniform(r, s, b)),
        ((C,), lambda r, s: _uniform(r, s, b)),
        ((heads, 15, 15), lambda r, s: 0.02 * r.normal(size=s)),
    ])
    before = wa.wmsa_attention.launches
    got = wa.wmsa_attention(x, *args, heads=heads, shifted=shifted)
    want = wa.wmsa_attention_ref(x, *args, heads=heads, shifted=shifted)
    assert wa.wmsa_attention.launches == before + 1
    assert got.dtype == x.dtype
    assert _rel_err(got, want) <= TOL[dtype]
    assert torch.equal(got, wa.wmsa_attention(x, *args, heads=heads,
                                              shifted=shifted))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,C,h", [("float32", 640, 1280),
                                       ("float32", 128, 256),
                                       ("bfloat16", 256, 512)])
def test_conv_glu_kernel(card, dtype, C, h):
    """Includes the image border (zero padding in g-space) on every side:
    H and W are not multiples of the tile."""
    rng = np.random.default_rng(15)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(size=(2, 10, 21, C)).astype(
        np.float32)).cuda().to(dt)
    args = _args(rng, dt, [
        ((C,), lambda r, s: 1 + 0.1 * r.normal(size=s)),
        ((C,), lambda r, s: 0.1 * r.normal(size=s)),
        ((2 * h, C), lambda r, s: _uniform(r, s, C ** -0.5)),
        ((2 * h,), lambda r, s: _uniform(r, s, C ** -0.5)),
        ((h, 1, 3, 3), lambda r, s: _uniform(r, s, 1 / 3)),
        ((h,), lambda r, s: _uniform(r, s, 1 / 3)),
        ((C, h), lambda r, s: _uniform(r, s, h ** -0.5)),
        ((C,), lambda r, s: _uniform(r, s, h ** -0.5)),
    ])
    got = cg.conv_glu(x, *args)
    want = cg.conv_glu_ref(x, *args)
    assert _rel_err(got, want) <= TOL[dtype]
    assert torch.equal(got, cg.conv_glu(x, *args))   # deterministic
