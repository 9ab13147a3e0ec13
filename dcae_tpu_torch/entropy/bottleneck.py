"""Factorized-prior entropy bottleneck (the learned prior over z).

A per-channel monotone CDF, parameterized as a chain of 1-wide MLP filters
(softplus-positive matrices, tanh gating), with `quantiles` that track the
distribution's medians and tails. Parameter names follow the reference
(`_matrix{i}`, `_bias{i}`, `_factor{i}`, `quantiles`).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dcae_tpu_torch.entropy import ops


class EntropyBottleneck(nn.Module):
    def __init__(self, channels: int, filters: Tuple[int, ...] = (3, 3, 3, 3),
                 init_scale: float = 10.0, tail_mass: float = 1e-9,
                 likelihood_bound: float = 1e-9):
        super().__init__()
        self.channels = channels
        self.filters = tuple(filters)
        self.init_scale = init_scale
        self.tail_mass = tail_mass
        self.likelihood_bound = likelihood_bound
        dims = (1,) + self.filters + (1,)
        for i in range(len(self.filters) + 1):
            self.register_parameter(f"_matrix{i}", nn.Parameter(
                torch.empty(channels, dims[i + 1], dims[i])))
            self.register_parameter(f"_bias{i}", nn.Parameter(
                torch.empty(channels, dims[i + 1], 1)))
            if i < len(self.filters):
                self.register_parameter(f"_factor{i}", nn.Parameter(
                    torch.empty(channels, dims[i + 1], 1)))
        self.quantiles = nn.Parameter(torch.empty(channels, 1, 3))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        dims = (1,) + self.filters + (1,)
        scale = self.init_scale ** (1.0 / (len(self.filters) + 1))
        for i in range(len(self.filters) + 1):
            init = math.log(math.expm1(1.0 / scale / dims[i + 1]))
            getattr(self, f"_matrix{i}").fill_(init)
            bias = getattr(self, f"_bias{i}")
            bias.copy_(torch.rand(bias.shape, generator=generator) - 0.5)
            if i < len(self.filters):
                getattr(self, f"_factor{i}").zero_()
        self.quantiles.copy_(torch.tensor(
            [-self.init_scale, 0.0, self.init_scale]).repeat(
                self.channels, 1, 1))

    def _logits_cumulative(self, inputs: torch.Tensor,
                           stop_gradient: bool = False) -> torch.Tensor:
        """inputs: (C, 1, N) -> logits of the cumulative at those points.
        stop_gradient: no gradient reaches the matrices, biases and
        factors (the quantile loss trains the quantiles alone)."""
        stop = (lambda t: t.detach()) if stop_gradient else (lambda t: t)
        logits = inputs
        for i in range(len(self.filters) + 1):
            matrix = F.softplus(stop(getattr(self, f"_matrix{i}")))
            logits = torch.matmul(matrix, logits) \
                + stop(getattr(self, f"_bias{i}"))
            if i < len(self.filters):
                factor = stop(getattr(self, f"_factor{i}"))
                logits = logits + torch.tanh(factor) * torch.tanh(logits)
        return logits

    def medians(self) -> torch.Tensor:
        """Per-channel median of the learned prior, shape (C,)."""
        return self.quantiles[:, 0, 1]

    def _likelihood(self, values_c1n: torch.Tensor) -> torch.Tensor:
        lower = self._logits_cumulative(values_c1n - 0.5)
        upper = self._logits_cumulative(values_c1n + 0.5)
        sign = -torch.sign(lower + upper).detach()
        return torch.abs(torch.sigmoid(sign * upper)
                         - torch.sigmoid(sign * lower))

    def forward(self, z: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None):
        """z: NHWC. Returns (values, likelihoods), both NHWC. Training adds
        U(-0.5, 0.5) noise from `generator` for the likelihood; eval rounds
        around the channel medians."""
        B, H, W, C = z.shape
        if C != self.channels:
            raise ValueError(f"expected {self.channels} channels, got {C}")
        if training:
            if generator is None:
                raise ValueError("training=True requires a generator")
            values = ops.noise_quantize(z, generator)
        else:
            medians = self.medians().reshape(1, 1, 1, C)
            values = ops.dequantize(ops.quantize_symbols(z, medians), medians)
        v = values.permute(3, 0, 1, 2).reshape(C, 1, B * H * W)
        like = self._likelihood(v)
        if self.likelihood_bound > 0:
            like = ops.lower_bound(like, self.likelihood_bound)
        like = like.reshape(C, B, H, W).permute(1, 2, 3, 0)
        return values, like

    def aux_loss(self) -> torch.Tensor:
        """Quantile-tracking loss; gradients reach `quantiles` alone."""
        logits = self._logits_cumulative(self.quantiles, stop_gradient=True)
        t = math.log(2.0 / self.tail_mass - 1.0)
        target = logits.new_tensor([-t, 0.0, t]).reshape(1, 1, 3)
        return torch.abs(logits - target).sum()
