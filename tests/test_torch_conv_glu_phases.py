"""The bf16 conv_glu's launch sequence, held on the CPU: the wrapper's band
plan, a plain PyTorch walk of the phases as the CUDA entry sequences them
(LN -> per band: fc1 on the band's rows and halo, gate with zero padding in
g-space -> fc2), and the width rules.

The walk must equal `conv_glu_ref` (and through it the JAX package's Pallas
kernel in interpret mode): f32 to 1e-6 of the output's max (summation order
only), bf16 to 1e-2 (the same rounding points; a sum near a rounding
boundary may flip one bf16 ulp of y).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings, strategies as st

from dcae_tpu.ops.pallas.conv_glu import fused_conv_glu
from dcae_tpu_torch.ops.kernels import conv_glu as cg


def _check_plan(plan, B, H):
    rows = B * H
    # every row once, in order
    assert [b[0] for b in plan] == [0] + [b[1] for b in plan[:-1]]
    assert plan[-1][1] == rows
    for r0, r1, lo, hi in plan:
        assert r0 < r1
        # the halo is one row of the same image, or nothing at its border
        assert lo == (r0 if r0 % H == 0 else r0 - 1)
        assert hi == (r1 if r1 % H == 0 else r1 + 1)
        assert 0 <= lo and hi <= rows
        # each band row's conv neighbours inside its image are in [lo, hi)
        for r in (r0, r1 - 1):
            for n in (r - 1, r + 1):
                if 0 <= n < rows and n // H == r // H:
                    assert lo <= n < hi


@pytest.mark.parametrize("B,H,W,hidden,band_rows", [
    (2, 64, 96, 512, None),     # the path's shape, the default band size
    (1, 1, 5, 64, 1),           # H = 1: every row is an image border
    (4, 1, 9, 64, 3),           # bands of several one-row images
    (2, 3, 7, 64, 8),           # H smaller than a band
    (3, 5, 7, 64, 3),           # H not a multiple of the band
    (1, 40, 8, 128, 7),         # one image, ragged last band
    (2, 10, 21, 512, None),     # fewer rows than one default band
])
def test_band_plan_covers_rows_and_clips_halo(B, H, W, hidden, band_rows):
    kw = {} if band_rows is None else dict(
        band_bytes=band_rows * W * 2 * hidden * 4)
    plan = cg.band_plan(B, H, W, hidden, **kw)
    _check_plan(plan, B, H)
    if band_rows is not None:
        assert max(r1 - r0 for r0, r1, _, _ in plan) <= band_rows
    else:
        assert max(r1 - r0 for r0, r1, _, _ in plan) * W * 2 * hidden * 4 \
            <= cg.BAND_BYTES


def test_band_plan_at_the_path_shape():
    """(2, 64, 96) at h = 512 is one band of 48 MiB of [g | v]; batch 8 of
    it is four, with no halo across the border between two images; at a
    quarter of the band size the halo rows inside an image appear."""
    assert cg.band_plan(2, 64, 96, 512) == [(0, 128, 0, 128)]
    assert cg.band_plan(8, 64, 96, 512) == [
        (0, 128, 0, 128), (128, 256, 128, 256), (256, 384, 256, 384),
        (384, 512, 384, 512)]
    assert cg.band_plan(2, 64, 96, 512, band_bytes=12 << 20) == [
        (0, 32, 0, 33), (32, 64, 31, 64), (64, 96, 64, 97),
        (96, 128, 95, 128)]


@settings(max_examples=60, deadline=None, database=None)
@given(B=st.integers(1, 4), H=st.integers(1, 20), W=st.integers(1, 12),
       band_rows=st.integers(1, 25))
def test_band_plan_any_shape(B, H, W, band_rows):
    plan = cg.band_plan(B, H, W, 64, band_bytes=band_rows * W * 2 * 64 * 4)
    _check_plan(plan, B, H)
    sizes = [r1 - r0 for r0, r1, _, _ in plan]
    assert max(sizes) <= band_rows and len(set(sizes[:-1])) <= 1


def _phase_walk(x, ln_w, ln_b, w1, b1, dw_w, dw_b, w2, b2, *, apply_ln,
                band_bytes):
    """The CUDA entry's sequence in plain PyTorch, on the (B * H, W) rows
    of the call: operands rounded where the kernels round them."""
    f = lambda t: t.to(torch.float32)  # noqa: E731
    rnd = ((lambda t: t.to(torch.bfloat16).to(torch.float32))
           if x.dtype == torch.bfloat16 else (lambda t: t))
    B, H, W, C = x.shape
    h = w1.shape[0] // 2
    rows = B * H
    xn = f(x).reshape(rows, W, C)
    if apply_ln:                                   # rows kernel
        xn = F.layer_norm(xn, (C,), f(ln_w), f(ln_b), 1e-5)
    xn = rnd(xn)
    y = torch.empty(rows, W, h)
    for r0, r1, lo, hi in cg.band_plan(B, H, W, h, band_bytes=band_bytes):
        gv = torch.matmul(xn[lo:hi], f(w1).t()) + f(b1)      # fc1, scratch
        g, v = gv[..., :h], gv[..., h:]
        zero = torch.zeros(W, h)
        stack = []                                 # gate: rows r-1, r, r+1
        for r in range(r0, r1):
            up = g[r - 1 - lo] if r % H else zero          # not read
            down = g[r + 1 - lo] if (r + 1) % H else zero  # off the image
            stack.append(torch.stack([up, g[r - lo], down]))
        g3 = torch.stack(stack).permute(0, 3, 1, 2)          # (n, h, 3, W)
        d = F.conv2d(g3, f(dw_w), f(dw_b), padding=(0, 1), groups=h)
        y[r0:r1] = rnd(F.gelu(d[:, :, 0].permute(0, 2, 1))
                       * v[r0 - lo:r1 - lo])
    out = torch.matmul(y, f(w2).t()) + f(b2)                 # fc2, once
    return out.reshape(B, H, W, C).to(x.dtype)


def _inputs(rng, shape, C, h):
    b1, b2 = C ** -0.5, h ** -0.5
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x = t(rng.normal(size=(*shape, C)))
    args = (t(1 + 0.1 * rng.normal(size=C)), t(0.1 * rng.normal(size=C)),
            t(rng.uniform(-b1, b1, (2 * h, C))), t(rng.uniform(-b1, b1, 2 * h)),
            t(rng.uniform(-1 / 3, 1 / 3, (h, 1, 3, 3))),
            t(rng.uniform(-1 / 3, 1 / 3, h)),
            t(rng.uniform(-b2, b2, (C, h))), t(rng.uniform(-b2, b2, C)))
    return x, args


@pytest.mark.parametrize("apply_ln", [True, False])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("shape,band_rows", [
    ((2, 8, 12), 3),      # bands that cross the border between the images
    ((1, 7, 9), 2),       # ragged last band
    ((3, 1, 5), 2),       # H = 1
    ((2, 5, 6), 64),      # one band
])
def test_phase_walk_equals_conv_glu_ref(shape, band_rows, dtype, tol,
                                        apply_ln):
    rng = np.random.default_rng(40)
    C, h = 32, 64
    x, args = _inputs(rng, shape, C, h)
    dt = getattr(torch, dtype)
    x, args = x.to(dt), tuple(a.to(dt) for a in args)
    got = _phase_walk(x, *args, apply_ln=apply_ln,
                      band_bytes=band_rows * shape[2] * 2 * h * 4)
    want = cg.conv_glu_ref(x, *args, apply_ln=apply_ln)
    assert got.dtype == want.dtype == dt
    err = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    assert err <= tol, err


@pytest.mark.parametrize("apply_ln", [True, False])
def test_phase_walk_equals_pallas_kernel(apply_ln):
    """The same walk against the TPU kernel itself, in interpret mode with
    tile_h=2 (interior tiles and both border tiles), f32: 3e-5 on O(1)
    outputs, the JAX package's own bar for this kernel."""
    rng = np.random.default_rng(41)
    C, h = 32, 64
    x, args = _inputs(rng, (2, 8, 12), C, h)
    ln_w, ln_b, w1, b1, dw_w, dw_b, w2, b2 = (a.numpy() for a in args)
    j = lambda a: jnp.asarray(np.ascontiguousarray(a, np.float32))  # noqa
    want = fused_conv_glu(
        j(x.numpy()), j(ln_w), j(ln_b), j(w1.T), j(b1),
        j(dw_w.reshape(h, 3, 3).transpose(1, 2, 0)), j(dw_b), j(w2.T), j(b2),
        apply_ln=apply_ln, interpret=True, tile_h=2)
    got = _phase_walk(x, *args, apply_ln=apply_ln,
                      band_bytes=3 * 12 * 2 * h * 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routed_widths_are_widths_the_kernel_takes(dtype):
    """`supported` routes only what `kernel_takes`, for every width up to
    the model's widest; the model's own widths are taken; what the wgmma
    tiles cannot hold is not."""
    dt = getattr(torch, dtype)
    for C in range(16, 1281, 16):
        for h in (C, 2 * C):
            if cg.supported(C, h, dt):
                assert cg.kernel_takes(C, h, dt), (C, h)
    assert cg.kernel_takes(256, 512, dt) and cg.kernel_takes(128, 256, dt)
    assert cg.kernel_takes(640, 1280, dt)
    assert not cg.kernel_takes(96, 192, dt)
    assert not cg.kernel_takes(144, 288, dt)
    assert cg.kernel_takes(192, 192, torch.float32)       # 64-wide fc2 tiles
    assert not cg.kernel_takes(192, 192, torch.bfloat16)  # 128-wide tiles
    assert not cg.kernel_takes(256, 512, torch.float16)
