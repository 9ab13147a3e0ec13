"""The spatial (sp) mesh axis: g_a and g_s split over image rows.

The JAX package shards an NHWC batch as P('dp', 'sp', None, None) and
XLA's SPMD partitioner inserts the halo exchanges. Here they are written
out. Inside `bands(mesh)` (shard_train_step / shard_eval_step enter it),
DCAE._run runs g_a and g_s on this sp rank's band of image rows
(run_split):

    y     = gather(run_bands(g_a, cut(x)))        x whole on every sp rank
    x_hat = gather(run_bands(g_s, cut(y_hat)))    (bands of band_rows)

The bands may differ in height, as XLA's partitioner lets an sp axis
split any height: each band is a whole number of row_multiple rows, and
the first (H / row_multiple) mod sp bands hold one multiple more
(band_rows).

Everything between them (h_a, the hyper synthesis, the bottleneck, the
slices, the loss) runs alike on every sp rank on the whole y: at 256x256
y is 16x16 and z 4x4, and a window-4 hyper block has no band to split.

Three autograd Functions move the rows over the sp group:
- cut: the band; its gradient is zero-padded back to every row, with no
  communication;
- gather: the bands all-gathered into every row (each padded to the
  tallest, since all_gather takes one shape, then cropped); its gradient
  is the sum over the sp group of the whole gradient, of which each rank
  keeps its band (a reduce-scatter);
- halo: rows from each neighbour; the halo rows' gradients go back to
  their owners, which add them to their boundary rows.
Every sp rank back-propagates the whole, replicated loss, so the
gradients summed over an sp group are sp times the one-device gradient
(parallel/mesh.py takes the mean over the world).

run_bands runs each part of a transform unchanged on its band extended by
the rows its own output band needs, derived from the layers' kernel_size,
stride, padding and window, then crops. The image's top and bottom get no
halo, so each layer's own zero padding applies there exactly as on one
device. A Swin block (W or SW) takes one window of rows from each side
that has a neighbour: rolled by w/2, an interior band [r0-w, r1+w) puts
every own row in a correctly aligned, unmasked window, and the masked
bottom window holds halo rows only, which are cropped; the first band
[0, r1+w) and the last [r0-w, H) put the image's wrap window at the
masked bottom row, where the own half attends to itself alone, as on one
device. So the kernels run unchanged on the extended bands.

Shape rules, raised and never padded around: a band holds whole windows
at every Swin stage of the transform (row_multiple: for g_a, image heights
a multiple of 8 * window, at least one multiple a band), and the halo a
layer needs fits in the neighbour's band it comes from: a halo from two
ranks away is refused.
"""

from __future__ import annotations

import contextlib
import math
import threading
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from dcae_tpu_torch.entropy.ops import no_draws
from dcae_tpu_torch.ops.blocks import (ResidualBottleneckBlock,
                                       ResidualBottleneckBlockWithStride,
                                       ResidualBottleneckBlockWithUpsample,
                                       SwinStack)

# .mesh: the Mesh whose sp ranks split g_a / g_s on this thread, else None
_state = threading.local()


@contextlib.contextmanager
def bands(mesh):
    """Inside: DCAE._run runs g_a and g_s on this rank's row band (needs
    mesh.sp > 1 and the mesh's sp group)."""
    if mesh.sp_group is None:
        raise ValueError("bands: the mesh has no sp axis (sp = 1)")
    before = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = before


def active():
    """The mesh of the enclosing `bands`, else None."""
    return getattr(_state, "mesh", None)


# ------------------------------------------------------------- the rows --

def _neighbours(mesh) -> Tuple[Optional[int], Optional[int]]:
    """Global ranks of the bands above and below (None at the image's
    edge): rank = dp_rank * sp + sp_rank."""
    up = mesh.rank - 1 if mesh.sp_rank > 0 else None
    down = mesh.rank + 1 if mesh.sp_rank < mesh.sp - 1 else None
    return up, down


def _swap(mesh, to_up, to_down, up_rows: int, down_rows: int, like):
    """Send to_up to the band above and to_down to the one below; receive
    up_rows rows from above and down_rows from below. Returns (from_up,
    from_down), None where there is no neighbour or no row."""
    up, down = _neighbours(mesh)
    sends, recvs = [], []
    got = []
    for peer, send, rows in ((up, to_up, up_rows),
                             (down, to_down, down_rows)):
        recv = None
        if peer is not None:
            if send.shape[1]:
                sends.append((peer, send.contiguous()))
            if rows:
                recv = like.new_empty((like.shape[0], rows,
                                       *like.shape[2:]))
                recvs.append((peer, recv))
        got.append(recv)
    mesh.transport.exchange(sends, recvs, mesh.sp_group)
    return got[0], got[1]


class _Cut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r0: int, r1: int):
        ctx.rows, ctx.r0 = x.shape[1], r0
        return x[:, r0:r1].clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros((g.shape[0], ctx.rows, *g.shape[2:]))
        out[:, ctx.r0:ctx.r0 + g.shape[1]] = g
        return out, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, rows: Tuple[int, ...]):
        ctx.mesh, ctx.rows = mesh, rows
        tallest = max(rows)
        if x.shape[1] < tallest:
            x = torch.cat([x, x.new_zeros((x.shape[0], tallest - x.shape[1],
                                           *x.shape[2:]))], dim=1)
        parts = mesh.transport.all_gather(x.contiguous(), mesh.sp_group)
        return torch.cat([p[:, :n] for p, n in zip(parts, rows)], dim=1)

    @staticmethod
    def backward(ctx, g):
        mesh, rows = ctx.mesh, ctx.rows
        total = g.contiguous().clone()
        mesh.transport.all_reduce_(total, mesh.sp_group)
        r0 = sum(rows[:mesh.sp_rank])
        return total[:, r0:r0 + rows[mesh.sp_rank]], None, None


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top: int, bottom: int, mesh):
        H = x.shape[1]
        from_up, from_down = _swap(mesh, x[:, :bottom], x[:, H - top:],
                                   top, bottom, x)
        ctx.mesh, ctx.top, ctx.bottom, ctx.H = mesh, top, bottom, H
        ctx.got_up = 0 if from_up is None else top
        parts = [p for p in (from_up, x, from_down) if p is not None]
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        top, bottom, H, u = ctx.top, ctx.bottom, ctx.H, ctx.got_up
        # the halo rows' gradients go back to the bands that own them
        back_up, back_down = _swap(ctx.mesh, g[:, :u], g[:, u + H:],
                                   bottom, top, g)
        gx = g[:, u:u + H].clone(memory_format=torch.contiguous_format)
        if back_up is not None:
            gx[:, :bottom] += back_up
        if back_down is not None:
            gx[:, H - top:] += back_down
        return gx, None, None, None


def band_rows(H: int, multiple: int, sp: int) -> List[int]:
    """The heights of the sp bands of H rows, top to bottom: each a whole
    number of `multiple` rows, the first (H / multiple) mod sp one
    multiple taller than the rest. Raises when H is not a multiple of
    `multiple` or holds fewer multiples than bands."""
    if H % multiple or H // multiple < sp:
        raise ValueError(
            f"sp band rule: bands of a multiple of {multiple} rows, so "
            f"heights of a multiple of {multiple} rows, at least {multiple} "
            f"* sp = {multiple * sp}; got {H}")
    q, r = divmod(H // multiple, sp)
    return [(q + (i < r)) * multiple for i in range(sp)]


def cut(x: torch.Tensor, mesh, rows: Sequence[int]) -> torch.Tensor:
    """This sp rank's band of x's rows (NHWC), the bands of heights `rows`
    top to bottom."""
    r0 = sum(rows[:mesh.sp_rank])
    return _Cut.apply(x, r0, r0 + rows[mesh.sp_rank])


def gather(band: torch.Tensor, mesh, rows: Sequence[int]) -> torch.Tensor:
    """Every sp rank's band, in row order: the whole tensor on each. rows:
    every band's height."""
    return _Gather.apply(band, mesh, tuple(rows))


def halo(band: torch.Tensor, top: int, bottom: int, mesh,
         rows: Sequence[int]) -> torch.Tensor:
    """The band extended by `top` rows of the band above and `bottom` of
    the band below; none at the image's top or bottom edge. rows: every
    band's height. Raises, on every rank alike, where a halo is taller
    than the band it comes from: its rows would come from two ranks
    away."""
    for i in range(1, len(rows)):
        for need, src in ((top, i - 1), (bottom, i)):
            if need > rows[src]:
                raise ValueError(
                    f"sp band rule: a halo of {need} rows exceeds a "
                    f"neighbour's band of {rows[src]} rows (band {src} of "
                    f"{list(rows)}), so it would come from two ranks away; "
                    "take a taller image or a smaller sp")
    return _Halo.apply(band, top, bottom, mesh)


# ---------------------------------------------- halos by module type --

def _conv_geometry(m: nn.Module) -> Tuple[int, int, int]:
    return m.kernel_size[0], m.stride[0], m.padding[0]


def reach(m: nn.Module, top: int = 0, bottom: int = 0) -> Tuple[int, int]:
    """(top, bottom): the input rows beyond a band that m needs for its
    output band extended by (top, bottom) rows, from the layers' own
    geometry. A strided convolution's top reach is a multiple of its
    stride, so that its windows keep their alignment."""
    if isinstance(m, nn.ConvTranspose2d):
        k, s, p = _conv_geometry(m)
        return (top + k - 1 - p) // s, (bottom + p - 1) // s + 1
    if isinstance(m, nn.Conv2d):
        k, s, p = _conv_geometry(m)
        return -(-(top * s + p) // s) * s, max(0, (bottom - 1) * s + k - p)
    if isinstance(m, ResidualBottleneckBlock):
        t, b = top, bottom
        for conv in (m.conv3, m.conv2, m.conv1):
            t, b = reach(conv, t, b)
        if m.skip is not None:
            st, sb = reach(m.skip, top, bottom)
            t, b = max(t, st), max(b, sb)
        return t, b
    if isinstance(m, (ResidualBottleneckBlockWithStride,
                      ResidualBottleneckBlockWithUpsample)):
        for child in reversed(list(m.children())):
            top, bottom = reach(child, top, bottom)
        return top, bottom
    raise TypeError(f"no sp halo rule for {type(m).__name__}")


def scale(m: nn.Module) -> Fraction:
    """Output rows a row of m's input."""
    if isinstance(m, nn.ConvTranspose2d):
        return Fraction(m.stride[0])
    if isinstance(m, nn.Conv2d):
        return Fraction(1, m.stride[0])
    if isinstance(m, (ResidualBottleneckBlock, SwinStack)):
        return Fraction(1)
    return math.prod((scale(c) for c in m.children()), start=Fraction(1))


def row_multiple(transform: nn.Sequential) -> int:
    """The band heights a transform takes: every part's band a whole
    number of rows and every Swin stage's a whole number of windows."""
    need, f = 1, Fraction(1)
    for part in transform:
        if isinstance(part, SwinStack):
            need = math.lcm(need, (f / part.window_size).denominator)
        f *= scale(part)
        need = math.lcm(need, f.denominator)
    return need


def _extended(m: nn.Module, band: torch.Tensor, mesh, rows: List[int]
              ) -> torch.Tensor:
    """m on the band, through its receptive field's halo, cropped to the
    band's output rows (whole numbers under row_multiple's rule). rows:
    every band's height at m's input."""
    top, bottom = reach(m)
    up, _ = _neighbours(mesh)
    f = scale(m)
    first = int((top if up is not None else 0) * f)
    return m(halo(band, top, bottom, mesh, rows))[
        :, first:first + int(band.shape[1] * f)]


def _swin_stack(stack: SwinStack, band: torch.Tensor, mesh,
                rows: List[int]) -> torch.Tensor:
    """SwinStack.forward on a band: each block on the band extended by one
    window of rows a side, cropped; the trailing conv through its halo."""
    w = stack.window_size
    _, H, W, _ = band.shape
    if H % w or W % w:
        raise ValueError(f"sp band rule: a band of {H} x {W} at a window-{w}"
                         " Swin stage is not whole windows")
    up, _ = _neighbours(mesh)
    first = w if up is not None else 0
    t = band
    for layer in stack.layers:
        t = layer(halo(t, w, w, mesh, rows))[:, first:first + H]
    return _extended(stack.conv, t, mesh, rows) + band


def run_bands(transform: nn.Sequential, band: torch.Tensor, mesh,
              rows: Sequence[int]) -> torch.Tensor:
    """transform (g_a or g_s) on this rank's row band, the halo rows from
    the neighbouring sp ranks; returns the output's band. rows: every
    band's height. Raises on band heights that break the shape rules, and
    on a noise draw inside."""
    m = row_multiple(transform)
    if any(n % m for n in rows):
        raise ValueError(
            f"sp band rule: {type(transform).__name__} takes bands of a "
            f"multiple of {m} rows; got {rows}")
    with no_draws("the row bands of an sp step"):
        for part in transform:
            band = (_swin_stack(part, band, mesh, rows)
                    if isinstance(part, SwinStack)
                    else _extended(part, band, mesh, rows))
            rows = [int(n * scale(part)) for n in rows]
    return band


def run_split(transform: nn.Sequential, x: torch.Tensor, mesh,
              out_dtype: torch.dtype) -> torch.Tensor:
    """transform (g_a or g_s) on x, whole on every sp rank: this rank's
    band of band_rows through run_bands, the output bands gathered whole
    in out_dtype. Raises where x's height breaks the band rule."""
    rows = band_rows(x.shape[1], row_multiple(transform), mesh.sp)
    band = run_bands(transform, cut(x, mesh, rows), mesh, rows)
    f = math.prod((scale(p) for p in transform), start=Fraction(1))
    return gather(band.to(out_dtype), mesh, [int(n * f) for n in rows])
