"""Gaussian conditional entropy model (scale-indexed): the likelihood of
the quantized latent under N(mu, sigma^2) with unit-bin integration, sigma
lower-bounded at 0.11, and a 64-entry log-spaced scale table that picks
each symbol's CDF row."""

from __future__ import annotations

import math

import numpy as np
import torch

from dcae_tpu_torch.entropy import ops

SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64


def get_scale_table(minimum: float = SCALES_MIN, maximum: float = SCALES_MAX,
                    levels: int = SCALES_LEVELS) -> np.ndarray:
    """64 log-spaced scales in [0.11, 256]."""
    return np.exp(np.linspace(math.log(minimum), math.log(maximum), levels,
                              dtype=np.float64)).astype(np.float32)


def likelihood(inputs: torch.Tensor, scales: torch.Tensor,
               means: torch.Tensor | None = None,
               scale_bound: float = SCALES_MIN,
               likelihood_bound: float = 1e-9) -> torch.Tensor:
    """P(round(y) == v) under N(means, scales^2) with unit-bin
    integration."""
    values = inputs if means is None else inputs - means
    scales = ops.lower_bound(scales, scale_bound)
    values = torch.abs(values)
    upper = ops.standardized_cumulative((0.5 - values) / scales)
    lower = ops.standardized_cumulative((-0.5 - values) / scales)
    like = upper - lower
    if likelihood_bound > 0:
        like = ops.lower_bound(like, likelihood_bound)
    return like


def apply(inputs: torch.Tensor, scales: torch.Tensor,
          means: torch.Tensor | None = None,
          scale_bound: float = SCALES_MIN, *, training: bool = False,
          generator: torch.Generator | None = None):
    """(values, likelihoods): noise quantization during training (the
    noise from `generator`), values rounded around the means otherwise."""
    if training:
        if generator is None:
            raise ValueError("training=True requires a generator")
        values = ops.noise_quantize(inputs, generator)
    else:
        values = ops.dequantize(ops.quantize_symbols(inputs, means), means)
    return values, likelihood(values, scales, means, scale_bound)


def build_indexes(scales: torch.Tensor, scale_table: torch.Tensor,
                  scale_bound: float = SCALES_MIN) -> torch.Tensor:
    """Index of the smallest table scale >= each sigma: the count of the
    table's first levels-1 entries strictly below max(sigma, bound)."""
    scales = torch.clamp_min(scales, scale_bound)
    table = scale_table.to(device=scales.device, dtype=scales.dtype)[:-1]
    return (table < scales[..., None]).sum(dim=-1, dtype=torch.int32)
