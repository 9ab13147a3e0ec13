"""TCM model: the mixed Transformer-CNN learned image codec (Liu, Sun,
Katto, CVPR 2023; the published LIC_TCM code).

Its transforms are stacks of mixed blocks (ops/tcm_blocks.py: a
convolution branch and a Swin branch side by side on a channel split,
GDN stride units, sub-pixel IGDN upsampling units) at 2N channels from
H/2 on. Its entropy model has two hyper synthesis nets (h_mean_s,
h_scale_s) and, for each slice, two SWAtten blocks: the means' attends
to the latent means and the earlier slices, the scales' to the latent
scales and the same slices; the slice's mean net and its LRP read the
attended mean support. Everything else, the slice loop, the entropy
bottleneck and the real-codec pieces, is ChannelARModel's
(models/base.py), so the codec driver runs TCM on every path it runs
DCAE. Tensors are NHWC; module names are the published state dict's
(g_a.0.conv1, atten_mean.{i}.0.in_conv, cc_mean_transforms.{i}.0, ...).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from dcae_tpu_torch.config import TCMConfig
from dcae_tpu_torch.models.base import ChannelARModel
from dcae_tpu_torch.models.transforms import SliceNet
from dcae_tpu_torch.ops.layers import Conv
from dcae_tpu_torch.ops.tcm_blocks import (ResidualBlockUpsample,
                                           ResidualBlockWithStride, SWAtten,
                                           mixed_stage, subpel_conv3x3)


def analysis(cfg: TCMConfig) -> nn.Sequential:
    """g_a: image -> y, x16 down: a stride unit, then per stage two mixed
    blocks and the next stride unit (the last a plain stride-2 conv)."""
    N, n, hd, w = cfg.N, cfg.config, cfg.head_dim, cfg.window_size
    return nn.Sequential(
        ResidualBlockWithStride(cfg.in_channels, 2 * N),
        *mixed_stage(N, hd[0], w, n[0]),
        ResidualBlockWithStride(2 * N, 2 * N),
        *mixed_stage(N, hd[1], w, n[1]),
        ResidualBlockWithStride(2 * N, 2 * N),
        *mixed_stage(N, hd[2], w, n[2]),
        Conv(2 * N, cfg.M, 3, stride=2))


def synthesis(cfg: TCMConfig) -> nn.Sequential:
    """g_s: y_hat -> image, x16 up, the mirror of g_a."""
    N, n, hd, w = cfg.N, cfg.config, cfg.head_dim, cfg.window_size
    return nn.Sequential(
        ResidualBlockUpsample(cfg.M, 2 * N),
        *mixed_stage(N, hd[3], w, n[3]),
        ResidualBlockUpsample(2 * N, 2 * N),
        *mixed_stage(N, hd[4], w, n[4]),
        ResidualBlockUpsample(2 * N, 2 * N),
        *mixed_stage(N, hd[5], w, n[5]),
        subpel_conv3x3(2 * N, cfg.out_channels, 2))


def hyper_analysis(cfg: TCMConfig) -> nn.Sequential:
    """h_a: y -> z, x4 down."""
    N = cfg.N
    return nn.Sequential(
        ResidualBlockWithStride(cfg.M, 2 * N),
        *mixed_stage(N, cfg.hyper_head_dim, cfg.hyper_window_size,
                     cfg.config[0]),
        Conv(2 * N, cfg.eb_channels, 3, stride=2))


def hyper_synthesis(cfg: TCMConfig) -> nn.Sequential:
    """h_mean_s / h_scale_s: z_hat -> a latent prior map, x4 up."""
    N = cfg.N
    return nn.Sequential(
        ResidualBlockUpsample(cfg.eb_channels, 2 * N),
        *mixed_stage(N, cfg.hyper_head_dim, cfg.hyper_window_size,
                     cfg.config[3]),
        subpel_conv3x3(2 * N, cfg.M, 2))


class TCM(ChannelARModel):
    def __init__(self, cfg: TCMConfig, omit: Sequence[str] = ()):
        """omit: as DCAE's (a split deployment's half)."""
        super().__init__(cfg, omit)
        self._build_halves({"g_a": analysis, "h_a": hyper_analysis,
                            "g_s": synthesis})
        self.h_mean_s = hyper_synthesis(cfg)
        self.h_scale_s = hyper_synthesis(cfg)
        S = cfg.num_slices

        def atten(i):
            return nn.Sequential(SWAtten(
                cfg.support_dim(i), cfg.atten_head_dim, cfg.window_size,
                cfg.atten_inter_dim))

        self.atten_mean = nn.ModuleList(atten(i) for i in range(S))
        self.atten_scale = nn.ModuleList(atten(i) for i in range(S))
        self.cc_mean_transforms = nn.ModuleList(
            SliceNet(cfg, cfg.support_dim(i)) for i in range(S))
        self.cc_scale_transforms = nn.ModuleList(
            SliceNet(cfg, cfg.support_dim(i)) for i in range(S))
        self.lrp_transforms = nn.ModuleList(
            SliceNet(cfg, cfg.support_dim(i) + cfg.slice_dim)
            for i in range(S))
        self._build_bottleneck()

    def hyper_synthesis(self, z_hat: torch.Tensor):
        return self.h_scale_s(z_hat), self.h_mean_s(z_hat)

    def _slice_context(self, i: int, latent_scales, latent_means,
                       y_hat_slices: List[torch.Tensor], y_h: int, y_w: int,
                       drift: Optional[torch.Generator] = None):
        """Context of slice i: the means' and the scales' SWAtten on their
        prior map and the earlier slices, then the mean and scale nets.
        The support is the attended mean support, which the LRP reads.
        `drift`: as DCAE's, on support, mu and sigma."""
        prev = y_hat_slices[: self.cfg.max_support_slices]
        mean_support = self._drift(self.atten_mean[i](
            torch.cat([latent_means, *prev], dim=-1)), drift)
        mu = self.cc_mean_transforms[i](mean_support)[:, :y_h, :y_w]
        scale_support = self.atten_scale[i](
            torch.cat([latent_scales, *prev], dim=-1))
        sigma = self.cc_scale_transforms[i](scale_support)[:, :y_h, :y_w]
        return mean_support, self._drift(mu, drift), self._drift(sigma,
                                                                 drift)
