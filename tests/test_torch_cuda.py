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


def _wmsa_call(entry, rng, dt, shape, C, heads, shifted):
    """(kernel out, plain out, kernel again) of one wmsa entry."""
    b = C ** -0.5
    x = torch.from_numpy(rng.normal(size=(*shape, C)).astype(
        np.float32)).cuda().to(dt)
    spec = [((3 * C, C), lambda r, s: _uniform(r, s, b)),
            ((3 * C,), lambda r, s: _uniform(r, s, b)),
            ((C, C), lambda r, s: _uniform(r, s, b)),
            ((C,), lambda r, s: _uniform(r, s, b)),
            ((heads, 15, 15), lambda r, s: 0.02 * r.normal(size=s))]
    if entry == "wmsa_block":
        spec = [((C,), lambda r, s: 1 + 0.1 * r.normal(size=s)),
                ((C,), lambda r, s: 0.1 * r.normal(size=s)),
                ((C,), lambda r, s: 1 + 0.1 * r.normal(size=s))] + spec
        fn, ref = wm.wmsa_block, wm.wmsa_block_ref
    else:
        fn, ref = wa.wmsa_attention, wa.wmsa_attention_ref
    args = _args(rng, dt, spec)
    kw = dict(heads=heads, shifted=shifted)
    return fn(x, *args, **kw), ref(x, *args, **kw), fn(x, *args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["wmsa_block", "wmsa_attention"])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("C,heads", [(96, 12), (144, 9), (256, 8)])
@pytest.mark.parametrize("shape", [(1, 8, 24), (2, 16, 24), (2, 96, 96)])
def test_wmsa_bf16_window_counts(card, entry, shifted, C, heads, shape):
    """3 and 12 windows: fewer than the persistent grid; 288: more than
    the grid (132 or 264 blocks on an H100) and not a multiple of it, so
    some blocks walk two windows and others one. At the three path widths
    (head_dim 8, 16, 32); W and SW; one window row (H = 8), where the
    bottom row is the only row."""
    rng = np.random.default_rng(17)
    got, want, again = _wmsa_call(entry, rng, torch.bfloat16, shape, C,
                                  heads, shifted)
    assert got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    assert _rel_err(got, want) <= TOL["bfloat16"]
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("apply_ln", [True, False])
@pytest.mark.parametrize("C,h", [(640, 1280), (128, 256)])
@pytest.mark.parametrize("shape", [(1, 7, 9), (2, 12, 23)])
def test_conv_glu_f32_tiles(card, shape, C, h, apply_ln):
    """The f32 GEMM phases at token counts below one tile (63) and not a
    multiple of either tile (552), with and without the LN; bitwise
    repeatable."""
    rng = np.random.default_rng(18)
    x = torch.from_numpy(rng.normal(size=(*shape, C)).astype(
        np.float32)).cuda()
    args = _args(rng, torch.float32, [
        ((C,), lambda r, s: 1 + 0.1 * r.normal(size=s)),
        ((C,), lambda r, s: 0.1 * r.normal(size=s)),
        ((2 * h, C), lambda r, s: _uniform(r, s, C ** -0.5)),
        ((2 * h,), lambda r, s: _uniform(r, s, C ** -0.5)),
        ((h, 1, 3, 3), lambda r, s: _uniform(r, s, 1 / 3)),
        ((h,), lambda r, s: _uniform(r, s, 1 / 3)),
        ((C, h), lambda r, s: _uniform(r, s, h ** -0.5)),
        ((C,), lambda r, s: _uniform(r, s, h ** -0.5)),
    ])
    before = cg.conv_glu.launches
    got = cg.conv_glu(x, *args, apply_ln=apply_ln)
    want = cg.conv_glu_ref(x, *args, apply_ln=apply_ln)
    assert cg.conv_glu.launches == before + 1
    assert _rel_err(got, want) <= TOL["float32"]
    for _ in range(3):
        assert torch.equal(got, cg.conv_glu(x, *args, apply_ln=apply_ln))


@pytest.mark.cuda
@pytest.mark.parametrize("apply_ln", [True, False])
@pytest.mark.parametrize("C,h", [(256, 512), (128, 256)])
@pytest.mark.parametrize("shape", [(1, 7, 9), (2, 12, 23), (2, 10, 21),
                                   (2, 64, 96)])
def test_conv_glu_bf16_phases(card, shape, C, h, apply_ln):
    """The bf16 wgmma phases at token counts below one 128-row tile (63),
    not a multiple of it (552, 420) and at the path's shape (12,288), with
    and without the LN; 1e-2 of max against the
    plain version (the largest error measured is 4.7e-3); bitwise
    repeatable; one launch counted a call."""
    rng = np.random.default_rng(19)
    dt = torch.bfloat16
    x = torch.from_numpy(rng.normal(size=(*shape, C)).astype(
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
    before = cg.conv_glu.launches
    got = cg.conv_glu(x, *args, apply_ln=apply_ln)
    want = cg.conv_glu_ref(x, *args, apply_ln=apply_ln)
    assert cg.conv_glu.launches == before + 1
    assert got.dtype == dt and bool(torch.isfinite(got.float()).all())
    assert _rel_err(got, want) <= 1e-2
    for _ in range(3):
        assert torch.equal(got, cg.conv_glu(x, *args, apply_ln=apply_ln))


@pytest.mark.cuda
@pytest.mark.parametrize("band_rows", [1, 5, 1000])
def test_conv_glu_bf16_bands(card, band_rows, monkeypatch):
    """Bands of one row, bands that cross the border between the images
    (H = 12, five rows a band) and one band for the whole call give the
    same bits: the walk changes where [g | v] waits, not what is summed."""
    rng = np.random.default_rng(20)
    C, h, shape = 128, 256, (2, 12, 23)
    dt = torch.bfloat16
    x = torch.from_numpy(rng.normal(size=(*shape, C)).astype(
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
    default = cg.conv_glu(x, *args)
    monkeypatch.setattr(cg, "BAND_BYTES", band_rows * shape[2] * 2 * h * 4)
    got = cg.conv_glu(x, *args)
    assert _rel_err(got, cg.conv_glu_ref(x, *args)) <= 1e-2
    assert torch.equal(got, default)
