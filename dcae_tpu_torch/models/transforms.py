"""Analysis, synthesis and hyper transforms of the DCAE codec, and the
per-slice context nets, as nn.Sequential stacks whose indices are the
reference's state-dict names (g_a.0..6, g_s.0..6, h_a.0..2, h_z_s.0..2,
cc_*_transforms.{i}.{0,2,4})."""

from __future__ import annotations

import torch
from torch import nn

from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.ops.blocks import (ResidualBottleneckBlockWithStride,
                                       ResidualBottleneckBlockWithUpsample,
                                       SwinStack)
from dcae_tpu_torch.ops.layers import Conv, Deconv


class GAnalysis(nn.Sequential):
    """g_a: image -> latent y (x16 downsample)."""

    def __init__(self, cfg: DCAEConfig):
        f, hd, n, w = cfg.feature_dim, cfg.head_dim, cfg.block_num, \
            cfg.window_size
        fab = cfg.fused_attention_block
        super().__init__(
            ResidualBottleneckBlockWithStride(cfg.in_channels, f[0]),
            SwinStack(f[0], hd[0], w, n[0], fab),
            ResidualBottleneckBlockWithStride(f[0], f[1]),
            SwinStack(f[1], hd[1], w, n[1], fab),
            ResidualBottleneckBlockWithStride(f[1], f[2]),
            SwinStack(f[2], hd[2], w, n[2], fab),
            Conv(f[2], cfg.M, 5, stride=2),
        )


class GSynthesis(nn.Sequential):
    """g_s: latent y_hat -> image (x16 upsample), mirror of g_a."""

    def __init__(self, cfg: DCAEConfig):
        f, hd, n, w = cfg.feature_dim, cfg.head_dim, cfg.block_num, \
            cfg.window_size
        fab = cfg.fused_attention_block
        super().__init__(
            Deconv(cfg.M, f[2], 5, 2),
            SwinStack(f[2], hd[3], w, n[2], fab),
            ResidualBottleneckBlockWithUpsample(f[2], f[1]),
            SwinStack(f[1], hd[4], w, n[1], fab),
            ResidualBottleneckBlockWithUpsample(f[1], f[0]),
            SwinStack(f[0], hd[5], w, n[0], fab),
            ResidualBottleneckBlockWithUpsample(f[0], cfg.out_channels),
        )


class HyperAnalysis(nn.Sequential):
    """h_a: y -> z (x4 further downsample)."""

    def __init__(self, cfg: DCAEConfig):
        super().__init__(
            ResidualBottleneckBlockWithStride(cfg.M, cfg.N),
            SwinStack(cfg.N, cfg.hyper_head_dim, cfg.hyper_window_size, 1),
            Conv(cfg.N, cfg.eb_channels, 3, stride=2),
        )


class HyperSynthesis(nn.Sequential):
    """h_z_s1 / h_z_s2: z_hat -> latent prior map (x4 upsample)."""

    def __init__(self, cfg: DCAEConfig):
        super().__init__(
            Deconv(cfg.eb_channels, cfg.N, 3, 2),
            SwinStack(cfg.N, cfg.hyper_head_dim, cfg.hyper_window_size, 1),
            ResidualBottleneckBlockWithUpsample(cfg.N, cfg.M),
        )


class SliceNet(nn.Sequential):
    """3-conv GELU context net (cc_mean / cc_scale / lrp). Each GELU runs
    inside the conv before it (Conv's `act`); modules 1 and 3 keep the
    reference's indices."""

    def __init__(self, cfg: DCAEConfig, in_ch: int):
        h1, h2 = cfg.cc_hidden
        super().__init__(
            Conv(in_ch, h1, 3), nn.GELU(),
            Conv(h1, h2, 3), nn.GELU(),
            Conv(h2, cfg.slice_dim, 3),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self[0](x, act="gelu")
        return self[4](self[2](x, act="gelu"))
