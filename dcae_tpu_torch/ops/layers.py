"""Primitive layers on NHWC tensors with the reference's geometry.

Public tensors are NHWC, as in the JAX package. A convolution views its
NHWC input as NCHW with channels_last strides (a permute, no copy), which
is the layout cuDNN's NHWC kernels take, and permutes the result back.
An f32 stride-1 1x1 or 3x3 convolution that needs no gradient goes
through the conv2d_nhwc kernel instead, with the activation after it
(ops/kernels/conv2d_nhwc.py: `routes`); on the CPU that wrapper runs the
same F.conv2d and activation.

Conv pads k//2 on both sides (torch Conv2d(padding=k//2)); Deconv is
ConvTranspose2d(k, s, padding=k//2, output_padding=s-1), so it upsamples
exactly by s. Parameters keep torch's native layouts, so reference state
dicts load unchanged.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dcae_tpu_torch.ops.kernels.conv2d_nhwc import ACTS, conv2d_nhwc, routes


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch nn.GELU's default."""
    return F.gelu(x)


class Conv(nn.Conv2d):
    """NHWC conv, torch geometry: padding k//2 on both sides. forward's
    `act` ("none", "gelu", "relu") is the activation that follows the conv
    in its module, applied here so that the kernel path fuses it."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5,
                 stride: int = 1, groups: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=kernel_size // 2, groups=groups, bias=bias)

    def forward(self, x: torch.Tensor, act: str = "none") -> torch.Tensor:
        if routes(self, x):
            return conv2d_nhwc(x, self.weight, self.bias, act=act)
        return ACTS[act](super().forward(x.permute(0, 3, 1, 2))
                         .permute(0, 2, 3, 1))


class Deconv(nn.ConvTranspose2d):
    """NHWC ConvTranspose2d(k, s, padding=k//2, output_padding=s-1)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5,
                 stride: int = 2):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=kernel_size // 2, output_padding=stride - 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def Dense(in_features: int, out_features: int, bias: bool = True
          ) -> nn.Linear:
    return nn.Linear(in_features, out_features, bias=bias)


def LayerNorm(dim: int) -> nn.LayerNorm:
    """LayerNorm over the trailing axis, torch eps (1e-5)."""
    return nn.LayerNorm(dim, eps=1e-5)


def pad_spatial(x: torch.Tensor, multiple: int
                ) -> Tuple[torch.Tensor, Tuple[int, int, int, int]]:
    """Center-pad NHWC H, W with zeros up to a multiple; returns (padded,
    (left, right, top, bottom)): the eval protocol's padding."""
    h, w = x.shape[1], x.shape[2]
    new_h = -(-h // multiple) * multiple
    new_w = -(-w // multiple) * multiple
    t = (new_h - h) // 2
    b = new_h - h - t
    l = (new_w - w) // 2
    r = new_w - w - l
    return F.pad(x, (0, 0, l, r, t, b)), (l, r, t, b)


def crop_spatial(x: torch.Tensor, padding: Sequence[int]) -> torch.Tensor:
    l, r, t, b = padding
    return x[:, t: x.shape[1] - b, l: x.shape[2] - r, :]


@torch.no_grad()
def fan_in_uniform_(t: torch.Tensor, fan_in: int,
                    generator: torch.Generator) -> None:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)): torch's conv/linear default."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    t.copy_(torch.rand(t.shape, generator=generator) * (2 * bound) - bound)


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float,
                  generator: torch.Generator) -> None:
    """Normal(0, std) truncated at two standard deviations."""
    t.copy_(torch.nn.init.trunc_normal_(
        torch.empty(t.shape), std=1.0, a=-2.0, b=2.0, generator=generator)
        * std)


@torch.no_grad()
def reset_layer(m: nn.Module, generator: torch.Generator) -> None:
    """Torch-default init of one primitive layer, from `generator`."""
    if isinstance(m, nn.ConvTranspose2d):
        # torch counts ConvTranspose fan_in over the output-channel axis of
        # its (in, out, k, k) weight
        fan_in = m.weight.shape[1] * m.weight[0, 0].numel()
    elif isinstance(m, (nn.Conv2d, nn.Linear)):
        fan_in = m.weight[0].numel()
    elif isinstance(m, nn.LayerNorm):
        m.weight.fill_(1.0)
        m.bias.zero_()
        return
    else:
        return
    fan_in_uniform_(m.weight, fan_in, generator)
    if m.bias is not None:
        fan_in_uniform_(m.bias, fan_in, generator)
