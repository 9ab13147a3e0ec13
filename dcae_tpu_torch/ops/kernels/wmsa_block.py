"""Swin attention half-block on 8x8 windows: out = rs * x + WMSA(LN x).

Counterpart of the TPU kernel `dcae_tpu/ops/pallas/wmsa_v4.py::
fused_wmsa_block_v4`. `wmsa_block` launches the CUDA kernel
(csrc/wmsa_block.cu) for CUDA tensors and runs `wmsa_block_ref`, the plain
PyTorch statement of the same math, for CPU tensors.

Training: where grad mode is on and an operand requires grad, the CUDA call
goes through `WmsaBlockFunction` (kernel forward, gradients by a recompute
through `wmsa_block_ref` in f32: the counterpart of
`wmsa_block_v4_trainable`). Differentiable: x, the LN weight and bias,
res_scale, Wqkv, bqkv, Wproj, bproj and the relative-position table.

Weights are in torch layout (the reference's state dict): wqkv (3C, C)
packed [q | k | v], each head-major (channel = head * head_dim + d);
wproj (C, C); rel (heads, 15, 15).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from dcae_tpu_torch.ops.kernels import _build, note_launch
from dcae_tpu_torch.ops.kernels._grad import recompute_backward, wants_grad

WINDOW = 8


def operand_rounding(dtype: torch.dtype):
    """Rounding to the products' operand precision: bf16 callers feed bf16
    operands (f32 accumulation), f32 callers keep f32."""
    if dtype == torch.bfloat16:
        return lambda t: t.to(torch.bfloat16).to(torch.float32)
    return lambda t: t


def relative_position_bias(rel: torch.Tensor, window: int = WINDOW
                           ) -> torch.Tensor:
    """(heads, P, P) bias: table[h, dy + w - 1, dx + w - 1] for query token
    (ri, ci) and key token (rj, cj), dy = ri - rj, dx = ci - cj."""
    iy, ix = _bias_index(window, rel.device)
    return rel[:, iy, ix]


@functools.lru_cache(maxsize=16)
def _bias_index(window: int, device: torch.device):
    """The (P, P) row and column indexes of relative_position_bias, kept on
    `device`: only a first call uploads them (and waits for the device)."""
    coords = np.array([[i, j] for i in range(window) for j in range(window)])
    idx = coords[:, None, :] - coords[None, :, :] + window - 1
    return (torch.as_tensor(idx[..., 0], device=device),
            torch.as_tensor(idx[..., 1], device=device))


def shifted_window_mask(nh: int, nw: int, window: int = WINDOW
                        ) -> np.ndarray:
    """(nh*nw, P, P) bool, True = forbidden: in the rolled frame a
    bottom-row window splits its rows at s = w - w//2 and a right-column
    window its columns; the two parts must not attend to each other."""
    s = window - window // 2
    r = np.arange(window * window) // window
    c = np.arange(window * window) % window
    rows = (r[:, None] < s) != (r[None, :] < s)
    cols = (c[:, None] < s) != (c[None, :] < s)
    mask = np.zeros((nh, nw, window * window, window * window), bool)
    mask[-1, :] |= rows
    mask[:, -1] |= cols
    return mask.reshape(nh * nw, window * window, window * window)


@functools.lru_cache(maxsize=64)
def shifted_window_mask_on(nh: int, nw: int, window: int,
                           device: torch.device) -> torch.Tensor:
    """shifted_window_mask as a tensor kept on `device` (uploaded once)."""
    return torch.as_tensor(shifted_window_mask(nh, nw, window),
                           device=device)


def window_attention(xs, wqkv, bqkv, wproj, bproj, rel, *, heads: int,
                      shifted: bool, rnd) -> torch.Tensor:
    """proj(WMSA(xs)) of an f32 input in the rolled frame whose values are
    already the qkv product's operands; f32, in the rolled frame, before
    the output's rounding. `rnd` rounds q/k/v, the probabilities and the
    attention output to the operand precision."""
    w = WINDOW
    B, H, W, C = xs.shape
    hd = C // heads
    f = lambda t: t.to(torch.float32)  # noqa: E731
    nh, nw = H // w, W // w
    xw = xs.reshape(B, nh, w, nw, w, C).permute(0, 1, 3, 2, 4, 5)
    xw = xw.reshape(B, nh * nw, w * w, C)
    qkv = rnd(torch.matmul(xw, f(wqkv).t()) + f(bqkv))
    q, k, v = (t.reshape(B, nh * nw, w * w, heads, hd).permute(0, 3, 1, 2, 4)
               for t in qkv.split(C, dim=-1))          # (B, heads, N, P, hd)
    sim = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
    sim = sim + relative_position_bias(f(rel))[None, :, None]
    if shifted:
        mask = shifted_window_mask_on(nh, nw, w, xs.device)
        sim = sim.masked_fill(mask[None, None], float("-inf"))
    probs = rnd(torch.softmax(sim, dim=-1))
    o = rnd(torch.matmul(probs, v).permute(0, 2, 3, 1, 4).reshape(
        B, nh * nw, w * w, C))
    res = torch.matmul(o, f(wproj).t()) + f(bproj)
    res = res.reshape(B, nh, nw, w, w, C).permute(0, 1, 3, 2, 4, 5)
    return res.reshape(B, H, W, C)


def roll_window(x: torch.Tensor, shifted: bool, sign: int) -> torch.Tensor:
    """The SW windows' cyclic shift: -w/2 before the windowing (sign -1),
    +w/2 after it (sign +1); identity for W windows."""
    if not shifted:
        return x
    s = sign * (WINDOW // 2)
    return torch.roll(x, shifts=(s, s), dims=(1, 2))


def wmsa_block_ref(x, ln_w, ln_b, rs, wqkv, bqkv, wproj, bproj, rel, *,
                   heads: int, shifted: bool) -> torch.Tensor:
    """Plain PyTorch statement of the kernel. LN and softmax in f32; bf16
    inputs get bf16 operands at each product input (the kernel's rounding
    points), f32 inputs stay f32. Returns x's dtype."""
    C = x.shape[-1]
    rnd = operand_rounding(x.dtype)
    f = lambda t: t.to(torch.float32)  # noqa: E731
    xs = roll_window(f(x), shifted, -1)
    xn = rnd(F.layer_norm(xs, (C,), f(ln_w), f(ln_b), 1e-5))
    res = window_attention(xn, wqkv, bqkv, wproj, bproj, rel, heads=heads,
                            shifted=shifted, rnd=rnd)
    return roll_window(xs * f(rs) + res, shifted, 1).to(x.dtype)


@functools.cache
def _entries():
    lib = _build.load_kernel("wmsa_block")
    return {"wmsa_block": _build.bind(lib, "dcae_wmsa_block", 11, 7),
            "wmsa_attention": _build.bind(lib, "dcae_wmsa_attention", 8, 7),
            "smem": _build.bind_query(lib, "dcae_wmsa_block_smem", 3)}


def check_windows(what: str, x, heads: int) -> None:
    """x: (B, H, W, C) with H, W multiples of the window, C of heads."""
    _, H, W, C = x.shape
    if H % WINDOW or W % WINDOW or C % heads:
        raise ValueError(f"{what}: shape {tuple(x.shape)} with {heads} "
                         f"heads needs H, W multiples of {WINDOW}")


def kernel_takes(C: int, heads: int, dtype: torch.dtype) -> bool:
    """The widths the CUDA kernels take, bf16 and f32 alike: 16-deep
    products over C (C <= 256, an LN row in a warp's registers) and 8-wide
    head tiles up to head_dim 32 (csrc/wmsa_block.cu `widths_taken`; the
    f32 kernel's head groups, `f32_plan`, exist at every such width)."""
    if dtype not in (torch.float32, torch.bfloat16) or heads <= 0 or \
            C % heads:
        return False
    hd = C // heads
    return C % 16 == 0 and hd % 8 == 0 and C <= 256 and hd <= 32


def launch(what: str, x, params, *, heads: int, shifted: bool
           ) -> torch.Tensor:
    """Launch entry `dcae_{what}` of csrc/wmsa_block.cu on CUDA tensors;
    params in the entry's order, ending in (wqkv, bqkv, wproj, bproj, rel).
    Raises ValueError on widths the kernel does not take (whatever the
    device), on any device but CUDA, and on other operands it does not
    take."""
    B, H, W, C = x.shape
    wqkv, rel = params[-5], params[-1]
    if not kernel_takes(C, heads, x.dtype):
        raise ValueError(f"{what}: no {x.dtype} kernel for C={C} with "
                         f"{heads} heads")
    if tuple(wqkv.shape) != (3 * C, C) or \
            tuple(rel.shape) != (heads, 2 * WINDOW - 1, 2 * WINDOW - 1):
        raise ValueError(f"{what}: unsupported weight shapes")
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {x.device}")
    x = x.contiguous()
    _build.kernel_operands(what, x, params)
    bf16 = x.dtype == torch.bfloat16
    entries = _entries()
    if entries["smem"](C, heads, int(bf16)) > _build.SMEM_LIMIT:
        raise ValueError(f"{what}: C={C} needs more shared memory than a "
                         "block has")
    out = torch.empty_like(x)
    # the kernel packs [Wqkv; Wproj] here for its bulk copies
    scratch = torch.empty(4 * C * C, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = entries[what](x.data_ptr(), *(p.data_ptr() for p in params),
                           out.data_ptr(), scratch.data_ptr(), B, H, W, C,
                           heads, int(shifted), int(bf16), stream)
    _build.check(rc, what)
    return out


class WmsaBlockFunction(torch.autograd.Function):
    """The wmsa_block kernel with gradients. forward launches the kernel
    and saves the operands alone; backward differentiates wmsa_block_ref
    on f32 copies and returns each gradient in its operand's dtype."""

    @staticmethod
    def forward(ctx, heads: int, shifted: bool, x, *params):
        ctx.heads, ctx.shifted = heads, shifted
        ctx.save_for_backward(x, *params)
        return _launch_counted(x, params, heads, shifted)

    @staticmethod
    def backward(ctx, grad_out):
        grads = recompute_backward(
            wmsa_block_ref, ctx.saved_tensors, ctx.needs_input_grad[2:],
            grad_out, heads=ctx.heads, shifted=ctx.shifted)
        return (None, None, *grads)


def _launch_counted(x, params, heads: int, shifted: bool) -> torch.Tensor:
    out = launch("wmsa_block", x, params, heads=heads, shifted=shifted)
    wmsa_block.launches += 1
    B, H, W, C = x.shape
    # qkv 6 C^2, proj 2 C^2, attention 4 * 64 * C a token
    note_launch("wmsa_block", B * H * W * (8 * C * C + 256 * C), x, out,
                *params)
    return out


def wmsa_block(x, ln_w, ln_b, rs, wqkv, bqkv, wproj, bproj, rel, *,
               heads: int, shifted: bool) -> torch.Tensor:
    """out = rs * x + WMSA(LN x) on 8x8 windows (shifted SW windows when
    `shifted`). x: (B, H, W, C) with H, W multiples of 8. CPU tensors run
    wmsa_block_ref; CUDA tensors launch the kernel or raise, through
    WmsaBlockFunction where a gradient is wanted. `launches` counts
    forward launches."""
    params = (ln_w, ln_b, rs, wqkv, bqkv, wproj, bproj, rel)
    check_windows("wmsa_block", x, heads)
    if x.device.type == "cpu":
        return wmsa_block_ref(x, *params, heads=heads, shifted=shifted)
    if wants_grad((x, *params)):
        return WmsaBlockFunction.apply(heads, shifted, x, *params)
    return _launch_counted(x, params, heads, shifted)


wmsa_block.launches = 0
