"""NN blocks on NHWC tensors: residual bottlenecks, window attention, gated
MLPs and the Swin stacks of the transforms.

Module and parameter names follow the reference's state dict. The fused
TPU kernels have hand-written CUDA counterparts: the attention half-block
of every window-8 Swin block goes through `wmsa_block` (LN1, attention and
residual in one kernel) or, in the attention-only configuration
(`fused_attention_block=False`), LN1 runs on its own and the window
attention goes through `wmsa_attention`; the GLU of blocks whose widths
are multiples of 128 (stage 3) goes through `conv_glu`. Each runs its
plain PyTorch statement on CPU tensors. The window-4 hyper stacks and the
stage-1/2 GLUs use the plain modules, as the JAX package's do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dcae_tpu_torch.ops.kernels.conv_glu import conv_glu, supported
from dcae_tpu_torch.ops.kernels.wmsa_attention import wmsa_attention
from dcae_tpu_torch.ops.kernels.wmsa_block import (WINDOW,
                                                   relative_position_bias,
                                                   shifted_window_mask_on,
                                                   wmsa_block)
from dcae_tpu_torch.ops.layers import Conv, Deconv, Dense, LayerNorm, gelu


class ResidualBottleneckBlock(nn.Module):
    """1x1 -> relu -> 3x3 -> relu -> 1x1 with skip; mid = min(in,out)//2."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        mid = min(in_ch, out_ch) // 2
        self.conv1 = Conv(in_ch, mid, 1)
        self.conv2 = Conv(mid, mid, 3)
        self.conv3 = Conv(mid, out_ch, 1)
        self.skip = Conv(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.skip is None else self.skip(x)
        h = self.conv2(self.conv1(x, act="relu"), act="relu")
        return self.conv3(h) + identity


class ResidualBottleneckBlockWithStride(nn.Module):
    """conv(k5, s2) then 3 bottlenecks: the downsample unit."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, 5, stride=2)
        self.res1 = ResidualBottleneckBlock(out_ch, out_ch)
        self.res2 = ResidualBottleneckBlock(out_ch, out_ch)
        self.res3 = ResidualBottleneckBlock(out_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.res3(self.res2(self.res1(self.conv(x))))


class ResidualBottleneckBlockWithUpsample(nn.Module):
    """3 bottlenecks then deconv(k5, s2): the upsample unit."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.res1 = ResidualBottleneckBlock(in_ch, in_ch)
        self.res2 = ResidualBottleneckBlock(in_ch, in_ch)
        self.res3 = ResidualBottleneckBlock(in_ch, in_ch)
        self.conv = Deconv(in_ch, out_ch, 5, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.res3(self.res2(self.res1(x))))


class WMSA(nn.Module):
    """Swin window multi-head self-attention ('W' or shifted 'SW') on a
    post-LN input. x: (B, H, W, C) with H, W divisible by the window.
    Window-8 calls go through `wmsa_attention`, others run plain
    PyTorch."""

    def __init__(self, dim: int, head_dim: int, window_size: int,
                 shifted: bool = False):
        super().__init__()
        self.head_dim = head_dim
        self.heads = dim // head_dim
        self.window_size = window_size
        self.shifted = shifted
        self.embedding_layer = Dense(dim, 3 * dim)
        self.linear = Dense(dim, dim)
        self.relative_position_params = nn.Parameter(torch.empty(
            self.heads, 2 * window_size - 1, 2 * window_size - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, heads, hd = self.window_size, self.heads, self.head_dim
        if w == WINDOW:
            return wmsa_attention(
                x, self.embedding_layer.weight, self.embedding_layer.bias,
                self.linear.weight, self.linear.bias,
                self.relative_position_params, heads=heads,
                shifted=self.shifted)
        B, H, W, C = x.shape
        if self.shifted:
            x = torch.roll(x, shifts=(-(w // 2), -(w // 2)), dims=(1, 2))
        nh, nw = H // w, W // w
        xw = x.reshape(B, nh, w, nw, w, C).permute(0, 1, 3, 2, 4, 5)
        qkv = self.embedding_layer(xw.reshape(B, nh * nw, w * w, C))
        q, k, v = (t.reshape(B, nh * nw, w * w, heads, hd)
                   .permute(0, 3, 1, 2, 4) for t in qkv.split(C, dim=-1))
        # scores and softmax in f32 whatever the compute dtype
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            * hd ** -0.5
        sim = sim + relative_position_bias(
            self.relative_position_params.float(), w)[None, :, None]
        if self.shifted:
            mask = shifted_window_mask_on(nh, nw, w, x.device)
            sim = sim.masked_fill(mask[None, None], float("-inf"))
        out = torch.matmul(torch.softmax(sim, dim=-1).to(v.dtype), v)
        out = self.linear(out.permute(0, 2, 3, 1, 4).reshape(
            B, nh * nw, w * w, C))
        out = out.reshape(B, nh, nw, w, w, C).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(B, H, W, C)
        if self.shifted:
            out = torch.roll(out, shifts=(w // 2, w // 2), dims=(1, 2))
        return out


class DWConv(nn.Module):
    """3x3 depthwise conv in NHWC."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv(dim, dim, 3, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dwconv(x)


class ConvolutionalGLU(nn.Module):
    """Gated MLP: fc1 -> split(g, v) -> gelu(DWConv(g)) * v -> fc2, with
    hidden = hidden_features // 2."""

    def __init__(self, dim: int, hidden_features: int):
        super().__init__()
        self.hidden = hidden_features // 2
        self.fc1 = Dense(dim, 2 * self.hidden)
        self.dwconv = DWConv(self.hidden)
        self.fc2 = Dense(self.hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g, v = self.fc1(x).split(self.hidden, dim=-1)
        return self.fc2(gelu(self.dwconv(g)) * v)

    def fused(self, x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
        """self(ln(x)) through the conv_glu kernel (its plain statement on
        the CPU)."""
        return conv_glu(x, ln.weight, ln.bias, self.fc1.weight,
                        self.fc1.bias, self.dwconv.dwconv.weight,
                        self.dwconv.dwconv.bias, self.fc2.weight,
                        self.fc2.bias, apply_ln=True)


class Scale(nn.Module):
    """Learnable per-channel residual scale, init 1."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


class ResScaleConvolutionGateBlock(nn.Module):
    """Transformer block: x = rs1 * x + WMSA(LN x); x = rs2 * x + GLU(LN x).

    fused_attention_block: window-8 blocks run the first half as one
    `wmsa_block` kernel (True) or as LN1, `wmsa_attention` and the residual
    (False: the JAX package's DCAE_PALLAS_V4=0 path).
    """

    def __init__(self, dim: int, head_dim: int, window_size: int,
                 shifted: bool = False, fused_attention_block: bool = True):
        super().__init__()
        self.window_size = window_size
        self.shifted = shifted
        self.fused_attention_block = fused_attention_block
        self.ln1 = LayerNorm(dim)
        self.msa = WMSA(dim, head_dim, window_size, shifted)
        self.res_scale_1 = Scale(dim)
        self.ln2 = LayerNorm(dim)
        self.mlp = ConvolutionalGLU(dim, dim * 4)
        self.res_scale_2 = Scale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.window_size == WINDOW and self.fused_attention_block:
            m = self.msa
            x = wmsa_block(
                x, self.ln1.weight, self.ln1.bias, self.res_scale_1.scale,
                m.embedding_layer.weight, m.embedding_layer.bias,
                m.linear.weight, m.linear.bias, m.relative_position_params,
                heads=m.heads, shifted=self.shifted)
        else:
            x = self.res_scale_1(x) + self.msa(self.ln1(x))
        if supported(x.shape[-1], self.mlp.hidden, x.dtype):
            h = self.mlp.fused(x, self.ln2)
        else:
            h = self.mlp(self.ln2(x))
        return self.res_scale_2(x) + h


class SwinStack(nn.Module):
    """block_num alternating W/SW blocks + trailing 3x3 conv, residual
    (the reference's SwinBlockWithConvMulti).

    Inputs smaller than the window are center-padded up to a window
    multiple and cropped back, so shapes stay invariant.
    """

    def __init__(self, dim: int, head_dim: int, window_size: int,
                 block_num: int, fused_attention_block: bool = True):
        super().__init__()
        self.window_size = window_size
        self.layers = nn.ModuleList(
            ResScaleConvolutionGateBlock(dim, head_dim, window_size,
                                         shifted=(i % 2 == 1),
                                         fused_attention_block=(
                                             fused_attention_block))
            for i in range(block_num))
        self.conv = Conv(dim, dim, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        w = self.window_size
        pad_h, pad_w = (-H) % w, (-W) % w
        t = x
        if pad_h or pad_w:
            t = F.pad(t, (0, 0, pad_w // 2, pad_w - pad_w // 2,
                          pad_h // 2, pad_h - pad_h // 2))
        for layer in self.layers:
            t = layer(t)
        if pad_h or pad_w:
            t = t[:, pad_h // 2: pad_h // 2 + H, pad_w // 2: pad_w // 2 + W]
        return self.conv(t) + x
