"""Convolutional GLU MLP with its LayerNorm:
fc2(GELU(dwconv3x3(fc1_g(LN x)) + dwb) * fc1_v(LN x)).

Counterpart of the TPU kernel `dcae_tpu/ops/pallas/conv_glu.py::
fused_conv_glu`. `conv_glu` launches the CUDA kernel (csrc/conv_glu.cu) for
CUDA tensors and runs `conv_glu_ref`, the plain PyTorch statement of the
same math, for CPU tensors.

Weights are in torch layout: w1 (2h, C) packed [gate | value] (fc1),
dw_w (h, 1, 3, 3), w2 (C, h) (fc2).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from dcae_tpu_torch.ops.kernels import _build

def supported(C: int, hidden: int, dtype: torch.dtype) -> bool:
    """Where the model routes a GLU through this function: the widths the
    TPU package gave its kernel (multiples of 128: the stage-3 GLUs at
    C=256 and the dictionary-attention GLU at C=640) that the CUDA kernel
    of this dtype takes (its register-held accumulator bounds C). The
    stage-1/2 GLUs (C=96/144) stay on the plain module, as they stay on
    XLA there. The rule is the same on the CPU, so both devices run the
    same call graph."""
    limit = 512 if dtype == torch.bfloat16 else 1024
    return C % 128 == 0 and hidden % 128 == 0 and C <= limit


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


@functools.cache
def _entry():
    lib = _build.load_kernel("conv_glu")
    return (_build.bind(lib, "dcae_conv_glu", 11, 7),
            _build.bind_query(lib, "dcae_conv_glu_smem", 2),
            _build.bind_query(lib, "dcae_conv_glu_scratch", 6))


def conv_glu(x, ln_w, ln_b, w1, b1, dw_w, dw_b, w2, b2, *,
             apply_ln: bool = True) -> torch.Tensor:
    """x: (B, H, W, C) -> (B, H, W, C) in x's dtype. CPU tensors run
    conv_glu_ref; CUDA tensors launch the kernel or raise. ln_w/ln_b are
    read only when apply_ln."""
    if x.device.type == "cpu":
        return conv_glu_ref(x, ln_w, ln_b, w1, b1, dw_w, dw_b, w2, b2,
                            apply_ln=apply_ln)
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
    # bf16 (a tile walk) takes h in chunks of 64 and C in 16-deep steps,
    # its fc2 accumulator in registers bounding C; f32 (GEMM phases) takes
    # fc1 columns in 128-wide tiles and fc2 columns in 64-wide ones
    widths_ok = h % 64 == 0 and ((C % 16 == 0 and C <= 512) if bf16 else
                                 C % 64 == 0)
    if not widths_ok or tuple(w1.shape) != (2 * h, C) or \
            tuple(w2.shape) != (C, h) or tuple(dw_w.shape) != (h, 1, 3, 3):
        raise ValueError(f"conv_glu: unsupported widths C={C}, h={h} for "
                         f"{x.dtype}")
    fn, smem, scratch_len = _entry()
    if smem(C, int(bf16)) > _build.SMEM_LIMIT:
        raise ValueError(f"conv_glu: C={C} needs more shared memory than a "
                         "block has")
    out = torch.empty_like(x)
    n_scratch = scratch_len(B, H, W, C, h, int(bf16))
    scratch = (torch.empty(n_scratch, dtype=torch.float32, device=x.device)
               if n_scratch else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), *(p.data_ptr() for p in params),
                out.data_ptr(), None if scratch is None else
                scratch.data_ptr(), B, H, W, C, h, int(apply_ln), int(bf16),
                stream)
    _build.check(rc, "conv_glu")
    conv_glu.launches += 1
    return out


conv_glu.launches = 0
