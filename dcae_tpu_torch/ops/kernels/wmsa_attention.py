"""Swin window attention on 8x8 windows of an input that is already
LayerNormed: out = proj(WMSA(x)), no LN and no residual.

Counterpart of the TPU kernel `dcae_tpu/ops/pallas/wmsa_v3.py::
fused_wmsa_v3`, which the attention-only configuration
(`DCAEConfig.fused_attention_block=False`) runs in every window-8 block.
`wmsa_attention` launches the CUDA kernel (the `dcae_wmsa_attention` entry
of csrc/wmsa_block.cu, whose device code it shares with `wmsa_block`) for
CUDA tensors and runs `wmsa_attention_ref`, the plain PyTorch statement of
the same math, for CPU tensors.

Rounding points (wmsa_v3.py): bf16 inputs get bf16 q/k/v (after the f32
bias add), bf16 probabilities (softmax in f32) and a bf16 attention output
before proj; proj accumulates in f32, adds its bias and rounds to bf16 on
output. f32 inputs keep f32 throughout.

Training: where grad mode is on and an operand requires grad, the CUDA call
goes through `WmsaAttentionFunction` (kernel forward, gradients by a
recompute through `wmsa_attention_ref` in f32: the counterpart of
`wmsa_v3_trainable`). Differentiable: x, Wqkv, bqkv, Wproj, bproj and the
relative-position table.

Weights are in torch layout, as for `wmsa_block`: wqkv (3C, C) packed
[q | k | v], each head-major; wproj (C, C); rel (heads, 15, 15).
"""

from __future__ import annotations

import torch

from dcae_tpu_torch.ops.kernels._grad import recompute_backward, wants_grad
from dcae_tpu_torch.ops.kernels.wmsa_block import (check_windows, launch,
                                                   operand_rounding,
                                                   roll_window,
                                                   window_attention)


def wmsa_attention_ref(x, wqkv, bqkv, wproj, bproj, rel, *, heads: int,
                       shifted: bool) -> torch.Tensor:
    """Plain PyTorch statement of the kernel. Returns x's dtype."""
    rnd = operand_rounding(x.dtype)
    xs = roll_window(x.to(torch.float32), shifted, -1)
    res = window_attention(xs, wqkv, bqkv, wproj, bproj, rel, heads=heads,
                            shifted=shifted, rnd=rnd)
    return roll_window(res, shifted, 1).to(x.dtype)


class WmsaAttentionFunction(torch.autograd.Function):
    """The wmsa_attention kernel with gradients. forward launches the
    kernel and saves the operands alone; backward differentiates
    wmsa_attention_ref on f32 copies and returns each gradient in its
    operand's dtype."""

    @staticmethod
    def forward(ctx, heads: int, shifted: bool, x, *params):
        ctx.heads, ctx.shifted = heads, shifted
        ctx.save_for_backward(x, *params)
        return _launch_counted(x, params, heads, shifted)

    @staticmethod
    def backward(ctx, grad_out):
        grads = recompute_backward(
            wmsa_attention_ref, ctx.saved_tensors, ctx.needs_input_grad[2:],
            grad_out, heads=ctx.heads, shifted=ctx.shifted)
        return (None, None, *grads)


def _launch_counted(x, params, heads: int, shifted: bool) -> torch.Tensor:
    out = launch("wmsa_attention", x, params, heads=heads, shifted=shifted)
    wmsa_attention.launches += 1
    return out


def wmsa_attention(x, wqkv, bqkv, wproj, bproj, rel, *, heads: int,
                   shifted: bool) -> torch.Tensor:
    """proj(WMSA(x)) on 8x8 windows (shifted SW windows when `shifted`).
    x: (B, H, W, C) with H, W multiples of 8. CPU tensors run
    wmsa_attention_ref; CUDA tensors launch the kernel or raise, through
    WmsaAttentionFunction where a gradient is wanted. `launches` counts
    forward launches."""
    params = (wqkv, bqkv, wproj, bproj, rel)
    check_windows("wmsa_attention", x, heads)
    if x.device.type == "cpu":
        return wmsa_attention_ref(x, *params, heads=heads, shifted=shifted)
    if wants_grad((x, *params)):
        return WmsaAttentionFunction.apply(heads, shifted, x, *params)
    return _launch_counted(x, params, heads, shifted)


wmsa_attention.launches = 0
