"""The plain reference of the ELIC codec: f32 PyTorch in NCHW, no kernels.

A statement of the model of He, Yang, Peng, Ma, Qin and Wang, "ELIC:
Efficient Learned Image Compression with Unevenly Grouped Space-Channel
Contextual Adaptive Coding" (CVPR 2022), as CompressAI's Elic2022Official
writes it: residual bottleneck blocks and Cheng et al.'s attention blocks
between 5x5 stride-2 convolutions (transposed in g_s), the hyper
analysis and synthesis, and SCCTX: the latent's channels in uneven
groups, each coded in two checkerboard passes. For group k:

  channel context      sequential_channel_ramp(sum(g_<k), 2 g_k, min N)
                       of 5x5 convolutions over the decoded earlier
                       groups (k >= 1)
  spatial context      a 5x5 convolution g_k -> 2 g_k, its weight masked
                       to the taps with row + column odd
  parameter aggregation
                       sequential_channel_ramp(2 g_k + [k > 0] 2 g_k + 2M,
                       2 g_k, min 2N) of 1x1 convolutions on cat(spatial,
                       channel, hyper); the output splits as (scales,
                       means)

The anchors (row + column even, CompressAI's anchor parity "even") take a
zero spatial context; the non-anchors the spatial context of the group's
decoded anchors, with the non-anchors zeroed. The parameters are computed
on the whole map in both passes and each pass keeps its own positions,
as the published two-pass forward does. Module and parameter names are
the published state dict's with CompressAI's latent-codec nesting
flattened (latent_codec.hyper.h_a -> h_a, latent_codec.y.channel_context
-> channel_context, latent_codec.y.latent_codec.y{k}.context_prediction
-> context_prediction.{k}, its entropy_parameters -> entropy_parameters.
{k}), so one state dict loads into this and into the program. It
imports neither JAX nor the program, and turns TF32 off for the matrix
products and cuDNN.

The model's face takes and gives NHWC tensors, as the DCAE reference's
does (benchmark/reference/model.py): g_a, h_a and g_s are Sequentials
that permute in and out; hyper_prior, group_context and group_params
permute their arguments. forward_train is the training forward under
given noise.

Departures from the published code: none in the mathematics. The
published masked convolution stores its mask as a buffer (the same
constant in every checkpoint); here it is a non-persistent buffer.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from reference.model import (EntropyBottleneck, gaussian_likelihood,
                             ste_round)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def nchw(t):
    return t.permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1)


# --------------------------------------------------------------- layers --

def conv(cin, cout, k=5, stride=2):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2)


def deconv(cin, cout, k=5, stride=2):
    return nn.ConvTranspose2d(cin, cout, k, stride=stride, padding=k // 2,
                              output_padding=stride - 1)


def conv1x1(cin, cout):
    return nn.Conv2d(cin, cout, 1)


def conv3x3(cin, cout):
    return nn.Conv2d(cin, cout, 3, padding=1)


class ResidualBottleneckBlock(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv1 = conv1x1(ch, ch // 2)
        self.conv2 = conv3x3(ch // 2, ch // 2)
        self.conv3 = conv1x1(ch // 2, ch)

    def forward(self, x):
        out = F.relu(self.conv2(F.relu(self.conv1(x))))
        return x + self.conv3(out)


class ResidualUnit(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = nn.Sequential(conv1x1(ch, ch // 2), nn.ReLU(),
                                  conv3x3(ch // 2, ch // 2), nn.ReLU(),
                                  conv1x1(ch // 2, ch))

    def forward(self, x):
        return F.relu(self.conv(x) + x)


class AttentionBlock(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv_a = nn.Sequential(*(ResidualUnit(ch) for _ in range(3)))
        self.conv_b = nn.Sequential(*(ResidualUnit(ch) for _ in range(3)),
                                    conv1x1(ch, ch))

    def forward(self, x):
        return x + self.conv_a(x) * torch.sigmoid(self.conv_b(x))


class CheckerboardMaskedConv2d(nn.Conv2d):
    """5x5, padding 2, the weight masked to the taps with row + column odd
    (mask type A: the centre is out)."""

    def __init__(self, cin, cout):
        super().__init__(cin, cout, 5, padding=2)
        r = torch.arange(5)
        self.register_buffer(
            "mask", ((r[:, None] + r[None, :]) % 2 == 1).to(torch.float32),
            persistent=False)

    def forward(self, x):
        return F.conv2d(x, self.weight * self.mask, self.bias, padding=2)


def ramp_widths(cin, cout, min_ch) -> List[int]:
    """The widths of CompressAI's sequential_channel_ramp with three
    layers: floor(linspace(cin, cout, 4)) in f32, the inner two raised to
    min_ch."""
    w = torch.linspace(cin, cout, 4, device="cpu").floor().int().tolist()
    return [w[0], max(w[1], min_ch), max(w[2], min_ch), w[3]]


def ramp(cin, cout, min_ch, k):
    """sequential_channel_ramp of kernel k along ramp_widths, ReLU between
    the layers."""
    w = ramp_widths(cin, cout, min_ch)
    return nn.Sequential(
        nn.Conv2d(w[0], w[1], k, padding=k // 2), nn.ReLU(),
        nn.Conv2d(w[1], w[2], k, padding=k // 2), nn.ReLU(),
        nn.Conv2d(w[2], w[3], k, padding=k // 2))


class _NHWC(nn.Sequential):
    """An NCHW stack behind an NHWC face."""

    def forward(self, x):
        return nhwc(super().forward(nchw(x)))


def anchor_mask(h, w, device) -> torch.Tensor:
    """(h, w) bool: True at the anchors, row + column even."""
    r = torch.arange(h, device=device)[:, None]
    c = torch.arange(w, device=device)[None, :]
    return (r + c) % 2 == 0


# ---------------------------------------------------------------- model --

class ELIC(nn.Module):
    """The whole codec. c: the configuration's "model" dict (ELICConfig's
    fields: N, M, groups, in_channels, out_channels and the entropy
    models')."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        N, M, G = c["N"], c["M"], list(c["groups"])
        self.groups = G

        def rbb():
            return [ResidualBottleneckBlock(N) for _ in range(3)]

        self.g_a = _NHWC(
            conv(c["in_channels"], N), *rbb(), conv(N, N), *rbb(),
            AttentionBlock(N), conv(N, N), *rbb(), conv(N, M),
            AttentionBlock(M))
        self.g_s = _NHWC(
            AttentionBlock(M), deconv(M, N), *rbb(), deconv(N, N),
            AttentionBlock(N), *rbb(), deconv(N, N), *rbb(),
            deconv(N, c["out_channels"]))
        self.h_a = _NHWC(
            conv(M, N, 3, 1), nn.ReLU(), conv(N, N), nn.ReLU(),
            conv(N, c["eb_channels"]))
        self.h_s = nn.Sequential(
            deconv(c["eb_channels"], N), nn.ReLU(),
            deconv(N, N * 3 // 2), nn.ReLU(), conv(N * 3 // 2, 2 * M, 3, 1))
        self.channel_context = nn.ModuleDict({
            f"y{k}": ramp(sum(G[:k]), 2 * G[k], N, 5)
            for k in range(1, len(G))})
        self.context_prediction = nn.ModuleList(
            CheckerboardMaskedConv2d(g, 2 * g) for g in G)
        self.entropy_parameters = nn.ModuleList(
            ramp(2 * g + (k > 0) * 2 * g + 2 * M, 2 * g, 2 * N, 1)
            for k, g in enumerate(G))
        self.entropy_bottleneck = EntropyBottleneck(
            c["eb_channels"], c["eb_filters"], c["eb_init_scale"],
            c["eb_tail_mass"])

    def hyper_prior(self, z_hat):
        """The hyper parameters (2M channels), NHWC."""
        return nhwc(self.h_s(nchw(z_hat)))

    def group_context(self, k: int, side, prev: List[torch.Tensor]):
        """The side parameters of group k, NHWC: cat(channel context of the
        decoded earlier groups `prev`, hyper parameters `side`); the hyper
        parameters alone for group 0. Both passes of the group read it."""
        if not k:
            return side
        ch = self.channel_context[f"y{k}"](
            torch.cat([nchw(t) for t in prev], dim=1))
        return torch.cat([nhwc(ch), side], dim=-1)

    def group_params(self, k: int, ctx, anchors: Optional[torch.Tensor]):
        """(scales, means) of group k on the whole map, NHWC: ctx its side
        parameters (group_context), anchors the group's decoded anchors
        with the other positions zero (None: the anchor pass, a zero
        spatial context)."""
        params = nchw(ctx)
        g = self.groups[k]
        B, _, H, W = params.shape
        if anchors is None:
            sp = params.new_zeros((B, 2 * g, H, W))
        else:
            sp = self.context_prediction[k](nchw(anchors))
        scales, means = self.entropy_parameters[k](
            torch.cat([sp, params], dim=1)).chunk(2, dim=1)
        return nhwc(scales), nhwc(means)

    def forward_train(self, x, noise: List[torch.Tensor]):
        """The training forward on NHWC x: noise[0] U[0,1) of z's shape,
        noise[1] of y's. Returns (x_hat, y likelihoods, z likelihoods)."""
        y = self.g_a(x)
        z = self.h_a(y)
        eb = self.entropy_bottleneck
        z_like = eb.likelihood(z + (noise[0] - 0.5))
        med = eb.medians().reshape(1, 1, 1, -1)
        z_hat = ste_round(z - med) + med
        side = self.hyper_prior(z_hat)
        a = anchor_mask(y.shape[1], y.shape[2], y.device)[None, :, :, None]
        prev, likes, c0 = [], [], 0
        for k, g in enumerate(self.groups):
            yk = y[..., c0:c0 + g]
            ctx = self.group_context(k, side, prev)
            s0, m0 = self.group_params(k, ctx, None)
            anchors = torch.where(a, ste_round(yk - m0) + m0, 0.0)
            s1, m1 = self.group_params(k, ctx, anchors)
            scales, means = torch.where(a, s0, s1), torch.where(a, m0, m1)
            likes.append(gaussian_likelihood(
                yk + (noise[1][..., c0:c0 + g] - 0.5), scales, means))
            prev.append(torch.where(a, anchors, ste_round(yk - m1) + m1))
            c0 += g
        x_hat = self.g_s(torch.cat(prev, dim=-1))
        return x_hat, torch.cat(likes, dim=-1), z_like
