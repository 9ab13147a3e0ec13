"""DCAE model: dictionary-based channel-autoregressive learned image codec
(Lu et al., CVPR 2025).

Its transforms (models/transforms.py), the two hyper synthesis nets and,
for each slice, the dictionary cross-attention that builds the support of
the slice's mean, scale and LRP nets. Everything else, the slice loop,
the entropy bottleneck and the real-codec pieces, is ChannelARModel's
(models/base.py). Tensors are NHWC, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from dcae_tpu_torch.config import DCAEConfig
# HALF_TRANSFORMS and reset_modules are imported from here too
from dcae_tpu_torch.models.base import (HALF_TRANSFORMS,  # noqa: F401
                                        ChannelARModel, reset_modules)
from dcae_tpu_torch.models.transforms import (GAnalysis, GSynthesis,
                                              HyperAnalysis, HyperSynthesis,
                                              SliceNet)
from dcae_tpu_torch.ops.dictionary import DictionaryCrossAttention


class DCAE(ChannelARModel):
    def __init__(self, cfg: DCAEConfig, omit: Sequence[str] = ()):
        """omit: transforms among g_a, h_a, g_s that this model does not
        build (a split deployment's half): they hold no parameters, are
        not in the state dict, and raise when called."""
        super().__init__(cfg, omit)
        self._build_halves({"g_a": GAnalysis, "h_a": HyperAnalysis,
                            "g_s": GSynthesis})
        self.h_z_s1 = HyperSynthesis(cfg)   # latent scales
        self.h_z_s2 = HyperSynthesis(cfg)   # latent means
        self.dt = nn.Parameter(torch.empty(cfg.dict_num, cfg.dict_dim))
        S = cfg.num_slices
        self.dt_cross_attention = nn.ModuleList(
            DictionaryCrossAttention(
                cfg.query_dim(i), cfg.M, head_num=cfg.dict_head_num,
                head_dim=cfg.dict_head_dim, mlp_rate=cfg.mlp_rate,
                qkv_bias=cfg.qkv_bias) for i in range(S))
        self.cc_mean_transforms = nn.ModuleList(
            SliceNet(cfg, cfg.support_dim(i)) for i in range(S))
        self.cc_scale_transforms = nn.ModuleList(
            SliceNet(cfg, cfg.support_dim(i)) for i in range(S))
        self.lrp_transforms = nn.ModuleList(
            SliceNet(cfg, cfg.support_dim(i) + cfg.slice_dim)
            for i in range(S))
        self._build_bottleneck()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's initializers: torch's layer
        defaults, trunc-normal(0.02) relative-position tables, unit scales,
        a N(0, 1) dictionary, the bottleneck's own init."""
        reset_modules(self, generator)
        self.dt.copy_(torch.randn(self.dt.shape, generator=generator))

    def hyper_synthesis(self, z_hat: torch.Tensor):
        return self.h_z_s1(z_hat), self.h_z_s2(z_hat)

    def _slice_context(self, i: int, latent_scales, latent_means,
                       y_hat_slices: List[torch.Tensor], y_h: int, y_w: int,
                       drift: Optional[torch.Generator] = None):
        """Context of slice i: query -> dictionary cross-attention ->
        support -> (support, mu, sigma). `drift`: the generator of the
        drift injection on support, mu and sigma (training only)."""
        support_slices = y_hat_slices[: self.cfg.max_support_slices]
        query = torch.cat([latent_scales, latent_means, *support_slices],
                          dim=-1)
        dict_info = self.dt_cross_attention[i](query, self.dt)
        support = self._drift(torch.cat([query, dict_info], dim=-1), drift)
        mu = self.cc_mean_transforms[i](support)[:, :y_h, :y_w]
        sigma = self.cc_scale_transforms[i](support)[:, :y_h, :y_w]
        return support, self._drift(mu, drift), self._drift(sigma, drift)
