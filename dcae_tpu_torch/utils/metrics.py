"""Image-quality metrics (PSNR, MS-SSIM) and rate accounting in PyTorch.

Measurement protocol: PSNR = -10 log10(MSE); MS-SSIM is reported as
-10 log10(1 - msssim); bpp from likelihoods is sum(-log2 p) / num_pixels;
real bpp is 8 * len(strings) / num_pixels of the unpadded image. Images are
NHWC. `ssim` and `ms_ssim` are differentiable (the ms-ssim loss trains
through them).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0
         ) -> torch.Tensor:
    mse = torch.mean((a.to(torch.float32) - b.to(torch.float32)) ** 2)
    return -10.0 * torch.log10(mse / (data_range ** 2))


def msssim_db(value) -> float:
    """-10 log10(1 - ms_ssim), the reporting transform."""
    return -10.0 * math.log10(max(1.0 - float(value), 1e-12))


def likelihood_bpp(likelihoods: dict, num_pixels: int) -> torch.Tensor:
    """Sum over all likelihood tensors of -log2 p / num_pixels."""
    total = sum(torch.sum(torch.log(l)) for l in likelihoods.values())
    return total / (-math.log(2) * num_pixels)


def real_bpp(strings, num_pixels: int) -> float:
    return sum(len(s) * 8 for grp in strings for s in grp) / num_pixels


# ---------------------------------------------------------------- MS-SSIM --

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _fspecial_gauss_1d(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _gaussian_blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable valid-padding Gaussian filter, NCHW, per channel."""
    C = x.shape[1]
    size = win.shape[0]
    x = F.conv2d(x, win.reshape(1, 1, size, 1).expand(C, 1, size, 1),
                 groups=C)
    return F.conv2d(x, win.reshape(1, 1, 1, size).expand(C, 1, 1, size),
                    groups=C)


def _ssim_cs(x: torch.Tensor, y: torch.Tensor, win: torch.Tensor,
             data_range: float = 1.0):
    """Per-image (ssim, cs) means of NCHW images."""
    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_x = _gaussian_blur(x, win)
    mu_y = _gaussian_blur(y, win)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_xx = _gaussian_blur(x * x, win) - mu_xx
    sigma_yy = _gaussian_blur(y * y, win) - mu_yy
    sigma_xy = _gaussian_blur(x * y, win) - mu_xy

    cs = (2 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ssim_map = ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    return ssim_map.mean(dim=(1, 2, 3)), cs.mean(dim=(1, 2, 3))


def _window(x: torch.Tensor, win_size: int, win_sigma: float
            ) -> torch.Tensor:
    return torch.as_tensor(_fspecial_gauss_1d(win_size, win_sigma),
                           device=x.device)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).permute(0, 3, 1, 2)


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
         win_size: int = 11, win_sigma: float = 1.5) -> torch.Tensor:
    s, _ = _ssim_cs(_nchw(x), _nchw(y), _window(x, win_size, win_sigma),
                    data_range)
    return s.mean()


def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
            win_size: int = 11, win_sigma: float = 1.5,
            weights=_MSSSIM_WEIGHTS) -> torch.Tensor:
    """Multi-scale SSIM (5 scales, standard weights), NHWC in [0, range].

    Requires min(H, W) > (win_size - 1) * 2 ** (levels - 1), i.e. > 160 for
    the defaults; a smaller image raises (the valid-padding filter finds
    no window at the coarsest scale).
    """
    win = _window(x, win_size, win_sigma)
    weights = torch.as_tensor(weights, dtype=torch.float32, device=x.device)
    levels = weights.shape[0]
    x, y = _nchw(x), _nchw(y)

    mcs = []
    s = None
    for i in range(levels):
        s, cs = _ssim_cs(x, y, win, data_range)
        if i < levels - 1:
            mcs.append(torch.clamp_min(cs, 0.0))
            # 2x2 mean pooling drops an odd last row / column
            x = F.avg_pool2d(x, 2)
            y = F.avg_pool2d(y, 2)

    stack = torch.stack(mcs + [torch.clamp_min(s, 0.0)])   # (levels, B)
    return torch.prod(stack ** weights[:, None], dim=0).mean()


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)
