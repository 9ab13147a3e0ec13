"""The ELIC codec's layers and blocks on NHWC tensors (He et al., CVPR
2022; CompressAI's Elic2022Official).

Module and parameter names follow the published state dict: a residual
unit's convolutions are `conv.0/2/4`, an attention block's branches
`conv_a` and `conv_b` (the last of `conv_b` its 1x1), a channel ramp a
Sequential of convolutions at `0/2/4` with ReLUs between them. The
residual bottleneck block is the port's (ops/blocks.py), whose names are
the published ones.

The entropy side runs in f32 at inference through conv2d_nhwc: its 5x5
channel contexts and 1x1 parameter aggregation as ContextConv, its
checkerboard-masked spatial context as CheckerboardConv, whose mask is
applied where the weight is packed (ops/kernels/conv2d_nhwc.py). The
published masked convolution also keeps its mask as a buffer; it is the
same constant in every checkpoint and is not kept here.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from dcae_tpu_torch.ops.kernels.conv2d_nhwc import (ACTS, conv2d_nhwc,
                                                    routes, tap_mask)
from dcae_tpu_torch.ops.layers import Conv


class ContextConv(Conv):
    """A Conv of ELIC's entropy side: a 5x5 too goes through conv2d_nhwc
    (the plain layers send it only their 1x1 and 3x3)."""

    taps = "all"

    def forward(self, x: torch.Tensor, act: str = "none") -> torch.Tensor:
        if routes(self, x, sizes=(1, 3, 5)):
            return conv2d_nhwc(x, self.weight, self.bias, act=act,
                               taps=self.taps)
        weight = self.weight
        if self.taps != "all":
            k = self.kernel_size[0]
            weight = weight * tap_mask(k, self.taps).to(weight)
        y = F.conv2d(x.permute(0, 3, 1, 2), weight, self.bias,
                     padding=self.padding)
        return ACTS[act](y.permute(0, 2, 3, 1))


class CheckerboardConv(ContextConv):
    """5x5 convolution masked to the 12 taps whose row + column is odd
    (CompressAI's CheckerboardMaskedConv2d, mask type A): at a position of
    one parity it reads the other parity's neighbours only. Under autograd
    the mask multiplies the weight; at inference the kernel runs those 12
    taps, and the plain statement a masked copy kept beside the weight."""

    taps = "odd"

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 5)


class ResidualUnit(nn.Module):
    """relu(x + conv1x1(C/2 -> C)(relu(conv3x3(relu(conv1x1(C -> C/2)
    (x))))): the attention block's unit."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Sequential(Conv(ch, ch // 2, 1), nn.ReLU(),
                                  Conv(ch // 2, ch // 2, 3), nn.ReLU(),
                                  Conv(ch // 2, ch, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv[2](self.conv[0](x, act="relu"), act="relu")
        return F.relu(x + self.conv[4](h))


class AttentionBlock(nn.Module):
    """Cheng et al. 2020's simplified attention: x + a(x) * sigmoid(b(x)),
    a three residual units, b three more and a 1x1."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv_a = nn.Sequential(*(ResidualUnit(ch) for _ in range(3)))
        self.conv_b = nn.Sequential(*(ResidualUnit(ch) for _ in range(3)),
                                    Conv(ch, ch, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_a(x) * torch.sigmoid(self.conv_b(x))


def ramp_widths(in_ch: int, out_ch: int, min_ch: int) -> List[int]:
    """CompressAI's sequential_channel_ramp widths for three layers:
    floor(linspace(in, out, 4)) in f32, the inner two at least min_ch."""
    w = torch.linspace(in_ch, out_ch, 4, device="cpu").floor().int().tolist()
    return [w[0], max(w[1], min_ch), max(w[2], min_ch), w[3]]


class Ramp(nn.Sequential):
    """Three ContextConvs of kernel k along ramp_widths, ReLU between them
    and none after the last (the ReLUs run inside the convolutions before
    them); modules 1 and 3 keep the published indices."""

    def __init__(self, in_ch: int, out_ch: int, min_ch: int, k: int):
        w = ramp_widths(in_ch, out_ch, min_ch)
        super().__init__(ContextConv(w[0], w[1], k), nn.ReLU(),
                         ContextConv(w[1], w[2], k), nn.ReLU(),
                         ContextConv(w[2], w[3], k))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self[0](x, act="relu")
        return self[4](self[2](x, act="relu"))
