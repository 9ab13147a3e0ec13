"""Quantization and bounding primitives of the entropy models."""

from __future__ import annotations

import torch


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Straight-through round: forward round(x), identity gradient."""
    return x + (torch.round(x) - x).detach()


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """max(x, bound) whose gradient passes through whenever x >= bound OR
    the gradient pushes x upward (the entropy models' LowerBound)."""
    return _LowerBound.apply(x, bound)


def quantize_symbols(x: torch.Tensor, means: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Integer symbols for entropy coding: round(x - means)."""
    if means is not None:
        x = x - means
    return torch.round(x).to(torch.int32)


def dequantize(symbols: torch.Tensor, means: torch.Tensor | None = None
               ) -> torch.Tensor:
    out = symbols.to(torch.float32)
    if means is not None:
        out = out + means.to(torch.float32)
    return out


def standardized_cumulative(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF via erfc, precise in the tails."""
    return 0.5 * torch.special.erfc(-(2 ** -0.5) * x)
