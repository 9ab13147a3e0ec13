"""ELIC model: the learned image codec with unevenly grouped space-channel
context (He, Yang, Peng, Ma, Qin, Wang, CVPR 2022; CompressAI's
Elic2022Official).

Its transforms are plain convolutions: residual bottleneck blocks and
Cheng et al.'s attention blocks between 5x5 stride-2 convolutions, their
mirror with transposed convolutions, a three-layer hyper analysis and
synthesis (ops/elic_blocks.py). Its entropy model, SCCTX, splits the
latent's M channels into uneven groups (16, 16, 32, 64, 192 at M = 320)
and codes each group in two checkerboard passes, so that a request is 10
coding steps of uneven size:

  anchors      the positions with row + column even; their context is the
               hyper parameters and the channel context of the groups
               decoded before (`channel_context.y{k}`, three 5x5
               convolutions), with a zero spatial context
  non-anchors  the other positions; the same two, and the spatial context
               of the group's decoded anchors (`context_prediction.{k}`, a
               5x5 convolution masked to the other parity's taps)

`entropy_parameters.{k}` (three 1x1 convolutions) maps cat(spatial,
channel, hyper) to (scales, means). A step's symbols, indexes and means
are the step's positions only: (B, yh, yw / 2, group) by `take`, each row
keeping the columns of its parity. 1x1 convolutions act on each position
alone, so the parameters are computed at the step's positions only; the
5x5 contexts run on the whole map. ELIC has no LRP. Everything else, the
step loop, the entropy bottleneck and the real-codec pieces, is
ChannelARModel's (models/base.py). g_a, h_a and g_s calls are the
`elic.transform` span (utils/profiling.py). Tensors are NHWC; module
names are the published state dict's, with CompressAI's latent-codec
nesting flattened (g_a, g_s, h_a, h_s, entropy_bottleneck,
channel_context.y{k}, context_prediction.{k}, entropy_parameters.{k}).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from dcae_tpu_torch.config import ELICConfig
from dcae_tpu_torch.models.base import ChannelARModel
from dcae_tpu_torch.ops.blocks import ResidualBottleneckBlock
from dcae_tpu_torch.ops.elic_blocks import (AttentionBlock, CheckerboardConv,
                                            Ramp)
from dcae_tpu_torch.ops.layers import Conv, Deconv
from dcae_tpu_torch.utils.profiling import span


def take(t: torch.Tensor, parity: int) -> torch.Tensor:
    """The positions of one checkerboard parity of NHWC t (W even): row r
    keeps the columns c with (r + c) % 2 == parity, in order. (B, H, W, C)
    -> (B, H, W / 2, C)."""
    B, H, W, C = t.shape
    pairs = t.reshape(B, H, W // 2, 2, C)
    even = (torch.arange(H, device=t.device) % 2 == 0).reshape(1, H, 1, 1)
    return torch.where(even, pairs[..., parity, :], pairs[..., 1 - parity, :])


def merge(anchors: torch.Tensor, others: torch.Tensor) -> torch.Tensor:
    """The whole map from take(., 0) and take(., 1): the inverse of take.
    (B, H, W / 2, C) twice -> (B, H, W, C)."""
    B, H, W2, C = anchors.shape
    even = (torch.arange(H, device=anchors.device) % 2 == 0).reshape(
        1, H, 1, 1, 1)
    pairs = torch.where(even, torch.stack([anchors, others], 3),
                        torch.stack([others, anchors], 3))
    return pairs.reshape(B, H, 2 * W2, C)


def rbb(ch: int) -> List[nn.Module]:
    return [ResidualBottleneckBlock(ch, ch) for _ in range(3)]


def analysis(cfg: ELICConfig) -> nn.Sequential:
    """g_a: image -> y, x16 down."""
    N, M = cfg.N, cfg.M
    return nn.Sequential(
        Conv(cfg.in_channels, N, 5, stride=2), *rbb(N),
        Conv(N, N, 5, stride=2), *rbb(N), AttentionBlock(N),
        Conv(N, N, 5, stride=2), *rbb(N),
        Conv(N, M, 5, stride=2), AttentionBlock(M))


def synthesis(cfg: ELICConfig) -> nn.Sequential:
    """g_s: y_hat -> image, x16 up, the mirror of g_a."""
    N, M = cfg.N, cfg.M
    return nn.Sequential(
        AttentionBlock(M), Deconv(M, N, 5, 2), *rbb(N),
        Deconv(N, N, 5, 2), AttentionBlock(N), *rbb(N),
        Deconv(N, N, 5, 2), *rbb(N),
        Deconv(N, cfg.out_channels, 5, 2))


def hyper_analysis(cfg: ELICConfig) -> nn.Sequential:
    """h_a: y -> z, x4 down."""
    N = cfg.N
    return nn.Sequential(Conv(cfg.M, N, 3), nn.ReLU(),
                         Conv(N, N, 5, stride=2), nn.ReLU(),
                         Conv(N, cfg.eb_channels, 5, stride=2))


def hyper_synthesis(cfg: ELICConfig) -> nn.Sequential:
    """h_s: z_hat -> the hyper parameters (2M channels), x4 up."""
    N = cfg.N
    return nn.Sequential(Deconv(cfg.eb_channels, N, 5, 2), nn.ReLU(),
                         Deconv(N, N * 3 // 2, 5, 2), nn.ReLU(),
                         Conv(N * 3 // 2, 2 * cfg.M, 3))


class ELIC(ChannelARModel):
    def __init__(self, cfg: ELICConfig, omit: Sequence[str] = ()):
        """omit: as DCAE's (a split deployment's half)."""
        super().__init__(cfg, omit)
        self._build_halves({"g_a": analysis, "h_a": hyper_analysis,
                            "g_s": synthesis})
        self.h_s = hyper_synthesis(cfg)
        G, N, M = cfg.groups, cfg.N, cfg.M
        self.channel_context = nn.ModuleDict({
            f"y{k}": Ramp(sum(G[:k]), 2 * G[k], N, 5)
            for k in range(1, len(G))})
        self.context_prediction = nn.ModuleList(
            CheckerboardConv(g, 2 * g) for g in G)
        self.entropy_parameters = nn.ModuleList(
            Ramp(2 * g + (k > 0) * 2 * g + 2 * M, 2 * g, 2 * N, 1)
            for k, g in enumerate(G))
        self._build_bottleneck()
        ends = [sum(G[:k + 1]) for k in range(len(G))]
        self.bounds = [(e - g, e) for e, g in zip(ends, G)]

    def _run(self, module: nn.Module, x: torch.Tensor) -> torch.Tensor:
        with span("elic.transform"):
            return ChannelARModel._run(module, x)

    def hyper_synthesis(self, z_hat: torch.Tensor):
        """(the hyper parameters, None): one map feeds every step."""
        return self.h_s(z_hat), None

    # ------------------------------------------------------ coding steps --

    @property
    def num_steps(self) -> int:
        return 2 * len(self.cfg.groups)

    def step_part(self, i: int, t: torch.Tensor) -> torch.Tensor:
        c0, c1 = self.bounds[i // 2]
        return take(t[..., c0:c1], i % 2)

    def step_map(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat([merge(parts[2 * k], parts[2 * k + 1])
                          for k in range(len(self.bounds))], dim=-1)

    def _merge(self, i: int, y_hat: torch.Tensor, piece: torch.Tensor
               ) -> torch.Tensor:
        """The anchors join y_hat as a new group with zeros at the other
        positions; the non-anchors fill those in."""
        if i % 2 == 0:
            return torch.cat([y_hat, merge(piece, torch.zeros_like(piece))],
                             dim=-1)
        c0 = self.bounds[i // 2][0]
        group = merge(take(y_hat[..., c0:], 0), piece)
        return torch.cat([y_hat[..., :c0], group], dim=-1)

    def _refine(self, i: int, support, y_hat_step: torch.Tensor
                ) -> torch.Tensor:
        return y_hat_step

    def _step_context(self, i: int, latent_scales, latent_means,
                      y_hat: torch.Tensor, carry, y_h: int, y_w: int,
                      drift: Optional[torch.Generator] = None):
        """(support, mu, sigma) of step i: group i // 2's anchors (i even)
        or non-anchors. The support is the whole map of cat(channel
        context, hyper parameters), computed at the anchor step and
        carried to the non-anchor step. `drift`: as DCAE's, on mu and
        sigma."""
        k, parity = divmod(i, 2)
        c0, c1 = self.bounds[k]
        if parity == 0:
            side = latent_scales[:, :y_h, :y_w]
            support = side if k == 0 else torch.cat(
                [self.channel_context[f"y{k}"](y_hat[..., :c0]), side],
                dim=-1)
            B = support.shape[0]
            spatial = support.new_zeros((B, y_h, y_w // 2, 2 * (c1 - c0)))
        else:
            support = carry
            spatial = take(self.context_prediction[k](y_hat[..., c0:c1]), 1)
        params = self.entropy_parameters[k](
            torch.cat([spatial, take(support, parity)], dim=-1))
        sigma, mu = params.chunk(2, dim=-1)
        return support, self._drift(mu, drift), self._drift(sigma, drift)
