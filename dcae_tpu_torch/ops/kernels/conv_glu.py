"""Convolutional GLU MLP with its LayerNorm:
fc2(GELU(dwconv3x3(fc1_g(LN x)) + dwb) * fc1_v(LN x)).

Counterpart of the TPU kernel `dcae_tpu/ops/pallas/conv_glu.py::
fused_conv_glu`. `conv_glu` launches the CUDA kernels (csrc/conv_glu.cu: LN,
fc1, gate, fc2 as phases; bf16 calls band by band, see `band_plan`) for
CUDA tensors and runs `conv_glu_ref`, the plain PyTorch statement of the
same math, for CPU tensors.

Training: where grad mode is on and an operand requires grad, the CUDA call
goes through `ConvGluFunction` (kernel forward, gradients by a recompute
through `conv_glu_ref` in f32: the counterpart of `conv_glu_trainable`).
The kernels evaluate GELU with the Abramowitz-Stegun erf approximation and
the plain version with the exact erf; the backward differentiates the plain
one, as the JAX package's differentiates its exact-erf restatement.
Differentiable: x, the LN weight and bias (not when apply_ln is false), W1,
b1, the depthwise taps and bias, W2, b2.

Weights are in torch layout: w1 (2h, C) packed [gate | value] (fc1),
dw_w (h, 1, 3, 3), w2 (C, h) (fc2).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dcae_tpu_torch.ops.kernels import _build
from dcae_tpu_torch.ops.kernels._grad import recompute_backward, wants_grad


def supported(C: int, hidden: int, dtype: torch.dtype) -> bool:
    """Where the model routes a GLU through this function: the widths the
    TPU package gave its kernel (multiples of 128: the stage-3 GLUs at
    C=256 and the dictionary-attention GLU at C=640), in bf16 up to C=512,
    the range held against the plain version on the card. The stage-1/2
    GLUs (C=96/144) stay on the plain module, as they stay on XLA there.
    Every width routed here is one `kernel_takes`. The rule is the same on
    the CPU, so both devices run the same call graph."""
    limit = 512 if dtype == torch.bfloat16 else 1024
    return C % 128 == 0 and hidden % 128 == 0 and C <= limit


def kernel_takes(C: int, hidden: int, dtype: torch.dtype) -> bool:
    """The widths the CUDA kernels of this dtype take. bf16: wgmma GEMMs on
    128-wide column tiles (fc2's columns are C) and 64-deep K slices (C for
    fc1, h for fc2), the gate 64 channels a block, an LN row in a warp's
    registers; f32: fc1 columns in 128-wide tiles, fc2 columns in 64-wide
    ones, 32-deep K slices."""
    if dtype == torch.bfloat16:
        return C % 128 == 0 and C <= 1024 and hidden % 64 == 0
    return dtype == torch.float32 and C % 64 == 0 and hidden % 64 == 0


# [g | v] in f32 of one band of the bf16 call: no more than the H100's L2
# (50 MB) and the whole of a call at the path's shape, (2, 64, 96) at h = 512.
# Smaller bands keep more of the scratch in L2 but make every fc1 and gate
# launch a partial wave of short blocks: a quarter of this measured a
# quarter slower on the card.
BAND_BYTES = 48 << 20


def band_plan(B: int, H: int, W: int, hidden: int,
              band_bytes: int | None = None) -> list:
    """The bands a bf16 call is walked in: [(r0, r1, lo, hi), ...] over the
    B * H rows of the call (row b * H + r is row r of image b). Rows
    [r0, r1) are the band's own; [lo, hi) adds the row above and the row
    below whose g the 3x3 conv reads, where that row lies in the same
    image. The bands cover every row once, in order, with rows of equal
    count (the last may be shorter), each with at most `band_bytes` of
    [g | v] in f32 (BAND_BYTES by default), and at least one row."""
    rows = B * H
    band_bytes = BAND_BYTES if band_bytes is None else band_bytes
    per = max(1, band_bytes // (W * 2 * hidden * 4))
    per = -(-rows // -(-rows // per))        # equal bands, no more of them
    plan = []
    for r0 in range(0, rows, per):
        r1 = min(r0 + per, rows)
        plan.append((r0, r1, r0 - (1 if r0 % H else 0),
                     r1 + (1 if r1 % H else 0)))
    return plan


def conv_glu_ref(x, ln_w, ln_b, w1, b1, dw_w, dw_b, w2, b2, *,
                 apply_ln: bool = True) -> torch.Tensor:
    """Plain PyTorch statement of the kernel. LN, conv, GELU in f32; bf16
    inputs get bf16 operands at the two products' inputs, f32 inputs stay
    f32. Returns x's dtype."""
    f = lambda t: t.to(torch.float32)  # noqa: E731
    rnd = ((lambda t: t.to(torch.bfloat16).to(torch.float32))
           if x.dtype == torch.bfloat16 else (lambda t: t))
    C = x.shape[-1]
    h = w1.shape[0] // 2
    xf = f(x)
    if apply_ln:
        xf = F.layer_norm(xf, (C,), f(ln_w), f(ln_b), 1e-5)
    a = torch.matmul(rnd(xf), f(w1).t()) + f(b1)
    g, v = a[..., :h], a[..., h:]
    d = F.conv2d(g.permute(0, 3, 1, 2), f(dw_w), f(dw_b), padding=1,
                 groups=h).permute(0, 2, 3, 1)
    y = rnd(F.gelu(d) * v)
    return (torch.matmul(y, f(w2).t()) + f(b2)).to(x.dtype)


@functools.lru_cache(maxsize=64)
def _bands_arg(B: int, H: int, W: int, hidden: int, band_bytes: int):
    """The plan as the C entry takes it: (int array of 4 ints a band, number
    of bands, most rows any band's [lo, hi) holds)."""
    plan = band_plan(B, H, W, hidden, band_bytes)
    flat = [v for band in plan for v in band]
    return ((ctypes.c_int * len(flat))(*flat), len(plan),
            max(hi - lo for _, _, lo, hi in plan))


@functools.cache
def _entry():
    lib = _build.load_kernel("conv_glu")
    return (_build.bind(lib, "dcae_conv_glu", 12, 9),
            _build.bind_query(lib, "dcae_conv_glu_smem", 2),
            _build.bind_query(lib, "dcae_conv_glu_scratch", 7))


def launch(x, ln_w, ln_b, w1, b1, dw_w, dw_b, w2, b2, *,
           apply_ln: bool) -> torch.Tensor:
    """Launch the kernels of csrc/conv_glu.cu on CUDA tensors. Raises on
    any other device and on what the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"conv_glu: no kernel for {x.device}")
    B, H, W, C = x.shape
    h = w1.shape[0] // 2
    x = x.contiguous()
    if not apply_ln:
        ln_w = ln_b = b2   # never read; keeps every operand pointer valid
    params = (ln_w, ln_b, w1, b1, dw_w, dw_b, w2, b2)
    _build.kernel_operands("conv_glu", x, params)
    bf16 = x.dtype == torch.bfloat16
    if not kernel_takes(C, h, x.dtype) or tuple(w1.shape) != (2 * h, C) or \
            tuple(w2.shape) != (C, h) or tuple(dw_w.shape) != (h, 1, 3, 3):
        raise ValueError(f"conv_glu: unsupported widths C={C}, h={h} for "
                         f"{x.dtype}")
    if x.numel() == 0:
        raise ValueError("conv_glu: empty input")
    fn, smem, scratch_len = _entry()
    if smem(C, int(bf16)) > _build.SMEM_LIMIT:
        raise ValueError(f"conv_glu: C={C} needs more shared memory than a "
                         "block has")
    # bf16 walks the call in bands over one reused [g | v] scratch
    bands, n_bands, band_rows = (_bands_arg(B, H, W, h, BAND_BYTES) if bf16
                                 else (None, 0, 0))
    out = torch.empty_like(x)
    scratch = torch.empty(scratch_len(B, H, W, C, h, int(bf16), band_rows),
                          dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), *(p.data_ptr() for p in params),
                out.data_ptr(), scratch.data_ptr(), bands, B, H, W, C, h,
                int(apply_ln), int(bf16), n_bands, band_rows, stream)
    _build.check(rc, "conv_glu")
    return out


class ConvGluFunction(torch.autograd.Function):
    """The conv_glu kernels with gradients. forward launches the kernels
    and saves the operands alone (the [g | v] scratch dies with the call);
    backward differentiates conv_glu_ref on f32 copies and returns each
    gradient in its operand's dtype. When apply_ln is false the LN weight
    and bias are not operands: they are neither saved nor given a
    gradient."""

    @staticmethod
    def forward(ctx, apply_ln: bool, x, ln_w, ln_b, *rest):
        ctx.apply_ln = apply_ln
        if not apply_ln:
            ln_w = ln_b = None
        ctx.save_for_backward(x, ln_w, ln_b, *rest)
        return _launch_counted(x, ln_w, ln_b, *rest, apply_ln=apply_ln)

    @staticmethod
    def backward(ctx, grad_out):
        grads = recompute_backward(
            conv_glu_ref, ctx.saved_tensors, ctx.needs_input_grad[1:],
            grad_out, apply_ln=ctx.apply_ln)
        return (None, *grads)


def _launch_counted(*operands, apply_ln: bool) -> torch.Tensor:
    out = launch(*operands, apply_ln=apply_ln)
    conv_glu.launches += 1
    return out


def conv_glu(x, ln_w, ln_b, w1, b1, dw_w, dw_b, w2, b2, *,
             apply_ln: bool = True) -> torch.Tensor:
    """x: (B, H, W, C) -> (B, H, W, C) in x's dtype. CPU tensors run
    conv_glu_ref; CUDA tensors launch the kernels or raise, through
    ConvGluFunction where a gradient is wanted. ln_w/ln_b are read only
    when apply_ln. One call counts as one launch, whatever the number of
    phase kernels and bands; `launches` counts forward launches."""
    operands = (x, ln_w, ln_b, w1, b1, dw_w, dw_b, w2, b2)
    if x.device.type == "cpu":
        return conv_glu_ref(*operands, apply_ln=apply_ln)
    if wants_grad(operands if apply_ln else (x, *operands[3:])):
        return ConvGluFunction.apply(apply_ln, *operands)
    return _launch_counted(*operands, apply_ln=apply_ln)


conv_glu.launches = 0
