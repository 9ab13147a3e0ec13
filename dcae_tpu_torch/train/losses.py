"""Training losses.

The rate-distortion objective: lambda * 255^2 * MSE + bpp for MSE models,
lambda * (1 - MS-SSIM) + bpp for MS-SSIM models, lambda * 255 * L1 + bpp
for l1; plus the transforms-only reconstruction losses (mse / l1 / ms-ssim
/ mixed).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from dcae_tpu_torch.utils.metrics import ms_ssim


def rate_distortion_loss(output: Dict, target: torch.Tensor, lmbda: float,
                         metric: str = "mse") -> Dict[str, torch.Tensor]:
    """output: the model's forward dict; target: NHWC image in [0, 1]."""
    B, H, W, _ = target.shape
    num_pixels = B * H * W
    bpp = sum(torch.sum(torch.log(l))
              for l in output["likelihoods"].values())
    bpp = bpp / (-math.log(2) * num_pixels)

    x_hat = output["x_hat"]
    if metric == "mse":
        mse = torch.mean((x_hat - target) ** 2)
        distortion = 255 ** 2 * mse
        out = {"mse_loss": mse}
    elif metric == "ms-ssim":
        ms = ms_ssim(torch.clamp(x_hat, 0, 1), target, data_range=1.0)
        distortion = 1.0 - ms
        out = {"ms_ssim_loss": distortion}
    elif metric == "l1":
        l1 = torch.mean(torch.abs(x_hat - target))
        distortion = 255 * l1
        out = {"l1_loss": l1}
    else:
        raise ValueError(f"unknown metric {metric!r}")

    out["bpp_loss"] = bpp
    out["loss"] = lmbda * distortion + bpp
    return out


def reconstruction_loss(x_hat: torch.Tensor, target: torch.Tensor,
                        loss_type: str = "mse") -> torch.Tensor:
    """Transforms-only pretraining loss, incl. 'mixed' =
    0.84 * (1 - msssim) + 0.16 * mse."""
    if loss_type == "mse":
        return torch.mean((x_hat - target) ** 2)
    if loss_type == "l1":
        return torch.mean(torch.abs(x_hat - target))
    if loss_type == "ms-ssim":
        return 1.0 - ms_ssim(torch.clamp(x_hat, 0, 1), target)
    if loss_type == "mixed":
        ms = 1.0 - ms_ssim(torch.clamp(x_hat, 0, 1), target)
        return 0.84 * ms + 0.16 * torch.mean((x_hat - target) ** 2)
    raise ValueError(f"unknown loss type {loss_type!r}")
