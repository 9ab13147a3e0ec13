"""Transforms-only autoencoder: g_a and g_s with no entropy model.

For transform pretraining and the split edge / accelerator deployment
experiments: compress() returns the raw latent y, decompress() the
reconstruction clipped to [0, 1]. params_from_dcae takes the transforms'
weights out of a full DCAE state dict. Both transforms are the DCAE's own
modules (models/transforms.py), so on the card their window attention and
GLU run the same kernels.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.models.dcae import reset_modules
from dcae_tpu_torch.models.transforms import GAnalysis, GSynthesis


class SimpleAutoencoder(nn.Module):
    """NHWC images in [0, 1] -> latent (B, H/16, W/16, M) -> images."""

    def __init__(self, cfg: DCAEConfig):
        super().__init__()
        self.cfg = cfg
        self.g_a = GAnalysis(cfg)
        self.g_s = GSynthesis(cfg)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the DCAE's initializers."""
        reset_modules(self, generator)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = self.g_a(x)
        return {"x_hat": self.g_s(y), "y": y}

    def compress(self, x: torch.Tensor) -> torch.Tensor:
        """Image -> the raw latent (a split deployment ships it, possibly
        cast to a narrower dtype)."""
        return self.g_a(x)

    def decompress(self, y: torch.Tensor) -> torch.Tensor:
        return torch.clamp(self.g_s(y), 0.0, 1.0)


def params_from_dcae(dcae_params: Dict, strict: bool = False) -> Dict:
    """The g_a.* / g_s.* entries of a full DCAE state dict; strict raises
    KeyError when either transform is absent."""
    out = {k: v for k, v in dcae_params.items()
           if k.split(".", 1)[0] in ("g_a", "g_s")}
    if strict:
        for top in ("g_a", "g_s"):
            if not any(k.startswith(top + ".") for k in out):
                raise KeyError(top)
    return out


def compression_ratio(cfg: DCAEConfig) -> float:
    """Raw float32 latent against uint8 pixels: 16 x 16 pixels of
    in_channels bytes become M values of 4 bytes."""
    return (16 * 16 * cfg.in_channels) / (cfg.M * 4.0)
