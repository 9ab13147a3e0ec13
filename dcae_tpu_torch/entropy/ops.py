"""Quantization and bounding primitives of the entropy models, and the
training noise's draw."""

from __future__ import annotations

import contextlib
import threading

import torch

# on this thread: .shard, (dp index, dp) of a data-parallel step, else
# None; .banned, why no draw may be made here (a row band of a spatial
# step), else None
_dp = threading.local()


@contextlib.contextmanager
def dp_noise(dp_rank: int, dp: int):
    """Inside: every training-noise draw (draw_noise) is made for the
    global batch, dp x the local rows, and this rank keeps the rows of its
    dp index (block dp_rank), as a partitioned program on the whole batch
    draws it. With the same generator state on every rank, a data-parallel
    step then sees the noise of the one-device step on the global batch;
    the sp ranks of one dp index draw alike."""
    before = getattr(_dp, "shard", None)
    _dp.shard = (int(dp_rank), int(dp))
    try:
        yield
    finally:
        _dp.shard = before


def noise_shard():
    """(dp index, dp) of the enclosing dp_noise, else None."""
    return getattr(_dp, "shard", None)


@contextlib.contextmanager
def no_draws(why: str):
    """Inside: draw_noise raises. A noise draw on a row band would be a
    band's share of the image's draw, which the band cannot know, so the
    sharded region of a spatial step (parallel/spatial.py) forbids it."""
    before = getattr(_dp, "banned", None)
    _dp.banned = why
    try:
        yield
    finally:
        _dp.banned = before


def draw_noise(shape, generator: torch.Generator, dtype, device,
               normal: bool = False) -> torch.Tensor:
    """U[0, 1) (normal: N(0, 1)) of `shape` (batch first) from
    `generator`; inside dp_noise, this rank's rows of the global batch's
    draw. Raises inside no_draws."""
    banned = getattr(_dp, "banned", None)
    if banned is not None:
        raise RuntimeError(f"a training-noise draw inside {banned}")
    shard = noise_shard()
    rows = shape[0]
    if shard is not None:
        shape = (rows * shard[1], *shape[1:])
    draw = torch.randn if normal else torch.rand
    noise = draw(shape, generator=generator, dtype=dtype, device=device)
    if shard is not None:
        noise = noise[shard[0] * rows:(shard[0] + 1) * rows]
    return noise


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


def noise_quantize(x: torch.Tensor, generator: torch.Generator
                   ) -> torch.Tensor:
    """Additive U(-0.5, 0.5) noise, the training-time surrogate of
    rounding. The noise is drawn from `generator`, which must live on x's
    device (draw_noise)."""
    noise = draw_noise(x.shape, generator, x.dtype, x.device)
    return x + (noise - 0.5)


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
