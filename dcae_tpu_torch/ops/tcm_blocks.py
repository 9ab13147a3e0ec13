"""The TCM codec's layers and blocks on NHWC tensors (Liu et al., CVPR
2023, the published LIC_TCM code).

Module and parameter names follow the published state dict: GDN keeps
its reparametrised `beta` and `gamma`, sub-pixel convolutions are
`Sequential(conv, shuffle)` (`.0.weight`), a Swin block's MLP is
`mlp.0` / `mlp.2`, a residual unit's convolutions `conv.0/2/4`. The
published GDN also stores its bounds as buffers; they are the same
constants in every checkpoint and are not kept here.

Window-8 Swin blocks run their attention half through `wmsa_block` (LN1,
attention and the residual in one kernel on the card, its plain
statement on the CPU) with a constant unit residual scale, a
non-persistent buffer; window-4 blocks run plain. ConvTransBlock and
SWAtten calls are the `tcm.mix` and `tcm.swatten` spans
(utils/profiling.py).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from dcae_tpu_torch.entropy.ops import lower_bound
from dcae_tpu_torch.ops.blocks import WMSA
from dcae_tpu_torch.ops.kernels.wmsa_block import WINDOW, wmsa_block
from dcae_tpu_torch.ops.layers import Conv, Dense, LayerNorm, gelu
from dcae_tpu_torch.utils.profiling import span

LRELU_SLOPE = 0.01
# GDN's published reparametrisation: stored values are sqrt(value +
# PEDESTAL), effective values lower_bound(p)^2 - PEDESTAL, beta at least
# BETA_MIN; initial effective beta 1 and gamma GAMMA_INIT * I
PEDESTAL = 2.0 ** -36
BETA_MIN = 1e-6
GAMMA_INIT = 0.1


def lrelu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU with the published (torch default) slope."""
    return F.leaky_relu(x, LRELU_SLOPE)


class GDN(nn.Module):
    """Generalized divisive normalization over the channels of NHWC x:
    y = x / sqrt(beta + gamma . x^2), or x * sqrt(...) when `inverse`
    (IGDN)."""

    def __init__(self, channels: int, inverse: bool = False):
        super().__init__()
        self.inverse = inverse
        self.beta_bound = math.sqrt(BETA_MIN + PEDESTAL)
        self.gamma_bound = math.sqrt(PEDESTAL)
        self.beta = nn.Parameter(torch.empty(channels))
        self.gamma = nn.Parameter(torch.empty(channels, channels))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """Effective beta 1 and gamma GAMMA_INIT * I, stored
        reparametrised."""
        C = self.beta.shape[0]
        self.beta.copy_(torch.sqrt(torch.ones(C) + PEDESTAL))
        self.gamma.copy_(torch.sqrt(GAMMA_INIT * torch.eye(C) + PEDESTAL))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        beta = lower_bound(self.beta, self.beta_bound) ** 2 - PEDESTAL
        gamma = lower_bound(self.gamma, self.gamma_bound) ** 2 - PEDESTAL
        norm = F.linear(x * x, gamma, beta)
        return x * (torch.sqrt(norm) if self.inverse else torch.rsqrt(norm))


class PixelShuffle(nn.Module):
    """nn.PixelShuffle(r) on NHWC: output channel c, row h r + i, column
    w r + j reads input channel c r^2 + i r + j at (h, w)."""

    def __init__(self, r: int):
        super().__init__()
        self.r = r

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        r = self.r
        x = x.reshape(B, H, W, C // (r * r), r, r).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(B, H * r, W * r, C // (r * r))


def subpel_conv3x3(cin: int, cout: int, r: int) -> nn.Sequential:
    """A 3x3 conv to cout r^2 channels, then PixelShuffle(r)."""
    return nn.Sequential(Conv(cin, cout * r * r, 3), PixelShuffle(r))


class ResidualBlock(nn.Module):
    """x + lrelu(conv3x3(lrelu(conv3x3(x))))."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = Conv(ch, ch, 3)
        self.conv2 = Conv(ch, ch, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + lrelu(self.conv2(lrelu(self.conv1(x))))


class ResidualBlockWithStride(nn.Module):
    """GDN(conv3x3(lrelu(conv3x3_s2(x)))) + conv1x1_s2(x). The 1x1
    stride-2 skip runs as a stride-1 1x1 conv on every other row and
    column, the same sum on a quarter of the pixels (torch's CPU backward
    of a 1x1 stride-2 conv on a channels-last 3-channel input aborts)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, stride=2)
        self.conv2 = Conv(cout, cout, 3)
        self.gdn = GDN(cout)
        self.skip = Conv(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.gdn(self.conv2(lrelu(self.conv1(x))))
        return out + self.skip(x[:, ::2, ::2])


class ResidualBlockUpsample(nn.Module):
    """IGDN(conv3x3(lrelu(subpel(x)))) + subpel'(x), two sub-pixel
    convolutions with weights of their own."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.subpel_conv = subpel_conv3x3(cin, cout, 2)
        self.conv = Conv(cout, cout, 3)
        self.igdn = GDN(cout, inverse=True)
        self.upsample = subpel_conv3x3(cin, cout, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.igdn(self.conv(lrelu(self.subpel_conv(x))))
        return out + self.upsample(x)


class Block(nn.Module):
    """Swin block: x += WMSA(LN1 x); x += MLP(LN2 x), the MLP two Linear
    layers around an exact GELU (4x wide). x: (B, H, W, C) with H, W
    multiples of the window."""

    def __init__(self, dim: int, head_dim: int, window_size: int,
                 shifted: bool = False):
        super().__init__()
        self.window_size = window_size
        self.shifted = shifted
        self.ln1 = LayerNorm(dim)
        self.msa = WMSA(dim, head_dim, window_size, shifted)
        self.ln2 = LayerNorm(dim)
        self.mlp = nn.Sequential(Dense(dim, 4 * dim), nn.GELU(),
                                 Dense(4 * dim, dim))
        # the unit residual scale of the window kernel (not a parameter)
        self.register_buffer("unit_scale", torch.ones(dim), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.window_size == WINDOW:
            m = self.msa
            x = wmsa_block(
                x, self.ln1.weight, self.ln1.bias,
                self.unit_scale.to(x.dtype), m.embedding_layer.weight,
                m.embedding_layer.bias, m.linear.weight, m.linear.bias,
                m.relative_position_params, heads=m.heads,
                shifted=self.shifted)
        else:
            x = x + self.msa(self.ln1(x))
        return x + self.mlp[2](gelu(self.mlp[0](self.ln2(x))))


class ConvTransBlock(nn.Module):
    """The mixed block: a 1x1 conv, then a residual convolution branch on
    the first `conv_dim` channels and a Swin block on the other
    `trans_dim`, joined by a 1x1 conv into a residual."""

    def __init__(self, conv_dim: int, trans_dim: int, head_dim: int,
                 window_size: int, shifted: bool = False):
        super().__init__()
        self.conv_dim = conv_dim
        self.trans_block = Block(trans_dim, head_dim, window_size, shifted)
        self.conv1_1 = Conv(conv_dim + trans_dim, conv_dim + trans_dim, 1)
        self.conv1_2 = Conv(conv_dim + trans_dim, conv_dim + trans_dim, 1)
        self.conv_block = ResidualBlock(conv_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("tcm.mix"):
            c, t = self.conv1_1(x).split(
                [self.conv_dim, x.shape[-1] - self.conv_dim], dim=-1)
            c = self.conv_block(c) + c
            t = self.trans_block(t)
            return x + self.conv1_2(torch.cat([c, t], dim=-1))


def mixed_stage(dim: int, head_dim: int, window_size: int, blocks: int):
    """`blocks` ConvTransBlocks on 2 dim channels, W and SW in turn."""
    return [ConvTransBlock(dim, dim, head_dim, window_size,
                           shifted=(i % 2 == 1)) for i in range(blocks)]


class ResidualUnit(nn.Module):
    """relu(x + conv1x1(relu(conv3x3(relu(conv1x1(x)))))), N -> N/2 ->
    N/2 -> N."""

    def __init__(self, N: int):
        super().__init__()
        self.conv = nn.Sequential(Conv(N, N // 2, 1), nn.ReLU(),
                                  Conv(N // 2, N // 2, 3), nn.ReLU(),
                                  Conv(N // 2, N, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv[2](self.conv[0](x, act="relu"), act="relu")
        return F.relu(x + self.conv[4](h))


class SwinBlock(nn.Module):
    """A W block then an SW block. Unlike the published SwinBlock, which
    pads an input no larger than the window, H and W must exceed the
    window (and be multiples of it)."""

    def __init__(self, dim: int, head_dim: int, window_size: int):
        super().__init__()
        self.window_size = window_size
        self.block_1 = Block(dim, head_dim, window_size, shifted=False)
        self.block_2 = Block(dim, head_dim, window_size, shifted=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.window_size
        if x.shape[1] <= w or x.shape[2] <= w:
            raise ValueError(f"SwinBlock: {x.shape[1]}x{x.shape[2]} input "
                             f"no larger than the window {w}: the latent "
                             "needs images of 256 px a side or more")
        return self.block_2(self.block_1(x))


class SWAtten(nn.Module):
    """The entropy model's gated window attention: u = in_conv(x); out =
    out_conv(RU^3(u) * sigmoid(conv1x1(RU^3(SwinBlock(u)))) + u)."""

    def __init__(self, dim: int, head_dim: int, window_size: int,
                 inter_dim: int):
        super().__init__()
        self.conv_a = nn.Sequential(*(ResidualUnit(inter_dim)
                                      for _ in range(3)))
        self.conv_b = nn.Sequential(*(ResidualUnit(inter_dim)
                                      for _ in range(3)),
                                    Conv(inter_dim, inter_dim, 1))
        self.non_local_block = SwinBlock(inter_dim, head_dim, window_size)
        self.in_conv = Conv(dim, inter_dim, 1)
        self.out_conv = Conv(inter_dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("tcm.swatten"):
            u = self.in_conv(x)
            z = self.non_local_block(u)
            gate = torch.sigmoid(self.conv_b(z))
            return self.out_conv(self.conv_a(u) * gate + u)
