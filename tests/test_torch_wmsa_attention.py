"""The port's window-attention kernel (`wmsa_attention`, the counterpart of
`dcae_tpu/ops/pallas/wmsa_v3.py::fused_wmsa_v3`) against the TPU kernel in
interpret mode on the CPU, and the attention-only Swin block against the
Flax block that runs that kernel.

On the CPU the wrapper runs its plain PyTorch statement, so these tests
hold that statement to the TPU kernel's math; the CUDA kernel is held to
the same statement on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: f32 on both sides with different summation orders (and a
-inf mask where the TPU kernel adds -1e30, which gives the same softmax):
atol 3e-5 on O(1) outputs, the bar of tests/test_pallas.py. bf16: both
sides round q/k/v, the probabilities and the attention output to bf16 at
the same points, but their f32 sums run in other orders, so a value near a
rounding boundary can land one bf16 ulp apart: 2e-2 of max|out|.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcae_tpu.ops import blocks as jb
from dcae_tpu.ops.pallas.wmsa_v3 import fused_wmsa_v3
from dcae_tpu_torch.ops import blocks as tb
from dcae_tpu_torch.ops.kernels import wmsa_attention as wa
from dcae_tpu_torch.utils.convert import FlaxToTorch

ATOL = 3e-5
BF16_TOL = 2e-2


def _params(rng, C, heads):
    """Flax-layout weights of the attention (wqkv (C, 3C), wproj (C, C))."""
    b = C ** -0.5
    return dict(wqkv=rng.uniform(-b, b, (C, 3 * C)),
                bqkv=rng.uniform(-b, b, 3 * C),
                wproj=rng.uniform(-b, b, (C, C)),
                bproj=rng.uniform(-b, b, C),
                rel=0.02 * rng.normal(size=(heads, 15, 15)))


def _torch_args(p, dtype=torch.float32):
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.float32)).to(dtype)
    return (t(p["wqkv"].T), t(p["bqkv"]), t(p["wproj"].T), t(p["bproj"]),
            t(p["rel"]))


def _jax_args(p, dtype=jnp.float32):
    return tuple(jnp.asarray(np.asarray(p[k], np.float32), dtype)
                 for k in ("wqkv", "bqkv", "wproj", "bproj", "rel"))


# (2, 16, 24, 32): 12 windows a batch; (1, 16, 24, 48): 6 windows, not a
# multiple of the TPU kernel's tile of 8 windows (its padding path)
SHAPES = [((2, 16, 24, 32), 4), ((1, 16, 24, 48), 3)]


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("shape,heads", SHAPES)
def test_wmsa_attention_ref_matches_wmsa_v3_f32(shape, heads, shifted):
    rng = np.random.default_rng(20)
    x = rng.normal(size=shape).astype(np.float32)
    p = _params(rng, shape[-1], heads)
    want = fused_wmsa_v3(jnp.asarray(x), *_jax_args(p), window=8,
                         heads=heads, shifted=shifted, interpret=True)
    got = wa.wmsa_attention(torch.from_numpy(x), *_torch_args(p),
                            heads=heads, shifted=shifted)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("shape,heads", SHAPES)
def test_wmsa_attention_ref_matches_wmsa_v3_bf16(shape, heads, shifted):
    """bf16 in and out on both sides, with the TPU kernel's rounding
    points."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=shape).astype(np.float32)
    p = _params(rng, shape[-1], heads)
    want = np.asarray(fused_wmsa_v3(
        jnp.asarray(x, jnp.bfloat16), *_jax_args(p, jnp.bfloat16), window=8,
        heads=heads, shifted=shifted, interpret=True).astype(jnp.float32))
    got = wa.wmsa_attention(torch.from_numpy(x).bfloat16(),
                            *_torch_args(p, torch.bfloat16), heads=heads,
                            shifted=shifted)
    assert got.dtype == torch.bfloat16
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= BF16_TOL * float(np.abs(want).max()), err


@pytest.mark.parametrize("C,head_dim,hw", [
    (32, 8, (16, 24)),     # the GLU on the plain path
    (128, 32, (8, 16)),    # the GLU through conv_glu (C % 128 == 0)
])
@pytest.mark.parametrize("shifted", [False, True])
def test_attention_only_block_matches_flax_v3_block(monkeypatch, C, head_dim,
                                                    hw, shifted):
    """ResScaleConvolutionGateBlock with fused_attention_block=False (LN1 on
    its own, wmsa_attention, the residual outside the kernel) against the
    Flax block with pallas=True and DCAE_PALLAS_V4=0, which runs LN1 in XLA
    and fused_wmsa_v3 (in interpret mode here) for its attention."""
    monkeypatch.setenv("DCAE_PALLAS_V4", "0")
    monkeypatch.setenv("DCAE_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("DCAE_PALLAS", raising=False)
    x = np.random.default_rng(23).normal(size=(1, *hw, C)).astype(np.float32)
    fm = jb.ResScaleConvolutionGateBlock(head_dim, 8, shifted, pallas=True)
    variables = fm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    e = FlaxToTorch()
    e.swin_block("m", params)
    pm = tb.ResScaleConvolutionGateBlock(C, head_dim, 8, shifted,
                                         fused_attention_block=False)
    pm.load_state_dict({k[2:]: torch.from_numpy(v.copy())
                        for k, v in e.out.items()}, strict=True)
    want = np.asarray(fm.apply(variables, jnp.asarray(x)))
    calls = []
    monkeypatch.setattr(tb, "wmsa_attention", lambda *a, **k: (
        calls.append(k), wa.wmsa_attention(*a, **k))[1])
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x)).numpy()
    assert calls == [dict(heads=C // head_dim, shifted=shifted)]
    np.testing.assert_allclose(got, want, atol=ATOL)
