"""The plain reference of the TCM codec: f32 PyTorch in NCHW, no kernels.

A statement of the model of Liu, Sun and Katto, "Learned Image
Compression with Mixed Transformer-CNN Architectures" (CVPR 2023), as the
published LIC_TCM code writes it: GDN as a 1x1 convolution of x^2 over
the reparametrised beta and gamma, sub-pixel convolutions through
nn.PixelShuffle, ResidualBlock / ResidualBlockWithStride /
ResidualBlockUpsample, the Swin Block with its einsum window attention,
relative-position table and shift mask, ConvTransBlock, SWAtten with
CompressAI's residual units, the slice nets and the LRP. Module and
parameter names are the published state dict's, so one state dict loads
into this and into the program. It imports neither JAX nor the program,
and turns TF32 off for the matrix products and cuDNN.

The model's face takes and gives NHWC tensors, as the DCAE reference's
does (benchmark/reference/model.py): g_a, h_a and g_s are Sequentials
that permute in and out, and hyper_prior, slice_context and lrp permute
their arguments. forward_train is the training forward under given noise.

Departures from the published code: none in the mathematics. The
published GDN's bounds, stored as buffers, are constants here. The
published SwinBlock pads an input no larger than its window and does not
crop it back; here such an input raises, so the latent needs images of
256 px a side or more (y larger than the window, a multiple of it).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PEDESTAL = 2.0 ** -36         # GDN's reparametrisation offset
BETA_MIN = 1e-6
GAMMA_INIT = 0.1


def nchw(t):
    return t.permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1)


# --------------------------------------------------------------- layers --

def conv3x3(cin, cout, stride=1):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1)


def conv1x1(cin, cout, stride=1):
    return nn.Conv2d(cin, cout, 1, stride=stride)


def subpel_conv3x3(cin, cout, r=1):
    return nn.Sequential(nn.Conv2d(cin, cout * r ** 2, 3, padding=1),
                         nn.PixelShuffle(r))


class LowerBound(torch.autograd.Function):
    """max(x, bound); the gradient passes where x >= bound or where it
    pushes x up (the published LowerBound)."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        keep = (x >= ctx.bound) | (g < 0)
        return torch.where(keep, g, torch.zeros_like(g)), None


class GDN(nn.Module):
    """y = x * rsqrt(beta + conv1x1(x^2, gamma)), IGDN with sqrt."""

    def __init__(self, ch, inverse=False):
        super().__init__()
        self.inverse = inverse
        self.beta_bound = (BETA_MIN + PEDESTAL) ** 0.5
        self.gamma_bound = PEDESTAL ** 0.5
        self.beta = nn.Parameter(torch.sqrt(torch.ones(ch) + PEDESTAL))
        self.gamma = nn.Parameter(torch.sqrt(
            torch.max(GAMMA_INIT * torch.eye(ch) + PEDESTAL,
                      torch.tensor(PEDESTAL))))

    def forward(self, x):
        C = x.shape[1]
        beta = LowerBound.apply(self.beta, self.beta_bound) ** 2 - PEDESTAL
        gamma = LowerBound.apply(self.gamma, self.gamma_bound) ** 2 \
            - PEDESTAL
        norm = F.conv2d(x ** 2, gamma.reshape(C, C, 1, 1), beta)
        return x * (torch.sqrt(norm) if self.inverse else torch.rsqrt(norm))


class ResidualBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = conv3x3(cin, cout)
        self.leaky_relu = nn.LeakyReLU()
        self.conv2 = conv3x3(cout, cout)

    def forward(self, x):
        out = self.leaky_relu(self.conv2(self.leaky_relu(self.conv1(x))))
        return out + x


class ResidualBlockWithStride(nn.Module):
    def __init__(self, cin, cout, stride=2):
        super().__init__()
        self.conv1 = conv3x3(cin, cout, stride=stride)
        self.leaky_relu = nn.LeakyReLU()
        self.conv2 = conv3x3(cout, cout)
        self.gdn = GDN(cout)
        self.skip = conv1x1(cin, cout, stride=stride)

    def forward(self, x):
        out = self.gdn(self.conv2(self.leaky_relu(self.conv1(x))))
        return out + self.skip(x)


class ResidualBlockUpsample(nn.Module):
    def __init__(self, cin, cout, upsample=2):
        super().__init__()
        self.subpel_conv = subpel_conv3x3(cin, cout, upsample)
        self.leaky_relu = nn.LeakyReLU()
        self.conv = conv3x3(cout, cout)
        self.igdn = GDN(cout, inverse=True)
        self.upsample = subpel_conv3x3(cin, cout, upsample)

    def forward(self, x):
        out = self.igdn(self.conv(self.leaky_relu(self.subpel_conv(x))))
        return out + self.upsample(x)


class WMSA(nn.Module):
    """Window multi-head self-attention on (B, H, W, C), 'W' or 'SW'."""

    def __init__(self, dim, head_dim, window, kind):
        super().__init__()
        self.head_dim = head_dim
        self.scale = head_dim ** -0.5
        self.n_heads = dim // head_dim
        self.window = window
        self.kind = kind
        self.embedding_layer = nn.Linear(dim, 3 * dim)
        self.relative_position_params = nn.Parameter(torch.zeros(
            self.n_heads, 2 * window - 1, 2 * window - 1))
        self.linear = nn.Linear(dim, dim)

    def generate_mask(self, h, w, p, shift):
        mask = torch.zeros(h, w, p, p, p, p, dtype=torch.bool,
                           device=self.relative_position_params.device)
        if self.kind == "W":
            return mask
        s = p - shift
        mask[-1, :, :s, :, s:, :] = True
        mask[-1, :, s:, :, :s, :] = True
        mask[:, -1, :, :s, :, s:] = True
        mask[:, -1, :, s:, :, :s] = True
        return mask.reshape(1, 1, h * w, p * p, p * p)

    def relative_embedding(self):
        w = self.window
        cord = torch.tensor(np.array([[i, j] for i in range(w)
                                      for j in range(w)]))
        rel = cord[:, None, :] - cord[None, :, :] + w - 1
        return self.relative_position_params[:, rel[:, :, 0].long(),
                                             rel[:, :, 1].long()]

    def forward(self, x):
        p = self.window
        if self.kind != "W":
            x = torch.roll(x, shifts=(-(p // 2), -(p // 2)), dims=(1, 2))
        B, H, W, C = x.shape
        hw, ww = H // p, W // p
        x = x.reshape(B, hw, p, ww, p, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, hw * ww, p * p, C)
        qkv = self.embedding_layer(x)            # b nw np (3 h c)
        qkv = qkv.reshape(B, hw * ww, p * p, 3 * self.n_heads,
                          self.head_dim).permute(3, 0, 1, 2, 4)
        q, k, v = qkv.chunk(3, dim=0)            # h b nw np c each
        sim = torch.einsum("hbwpc,hbwqc->hbwpq", q, k) * self.scale
        sim = sim + self.relative_embedding()[:, None, None]
        if self.kind != "W":
            sim = sim.masked_fill(
                self.generate_mask(hw, ww, p, p // 2), float("-inf"))
        probs = torch.softmax(sim, dim=-1)
        out = torch.einsum("hbwij,hbwjc->hbwic", probs, v)
        out = out.permute(1, 2, 3, 0, 4).reshape(B, hw * ww, p * p, C)
        out = self.linear(out)
        out = out.reshape(B, hw, ww, p, p, C).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(B, H, W, C)
        if self.kind != "W":
            out = torch.roll(out, shifts=(p // 2, p // 2), dims=(1, 2))
        return out


class Block(nn.Module):
    """On (B, H, W, C): x + WMSA(LN x), then x + MLP(LN x)."""

    def __init__(self, dim, head_dim, window, kind="W"):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim)
        self.msa = WMSA(dim, head_dim, window, kind)
        self.ln2 = nn.LayerNorm(dim)
        self.mlp = nn.Sequential(nn.Linear(dim, 4 * dim), nn.GELU(),
                                 nn.Linear(4 * dim, dim))

    def forward(self, x):
        x = x + self.msa(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class ConvTransBlock(nn.Module):
    def __init__(self, conv_dim, trans_dim, head_dim, window, kind="W"):
        super().__init__()
        self.conv_dim, self.trans_dim = conv_dim, trans_dim
        self.trans_block = Block(trans_dim, head_dim, window, kind)
        self.conv1_1 = conv1x1(conv_dim + trans_dim, conv_dim + trans_dim)
        self.conv1_2 = conv1x1(conv_dim + trans_dim, conv_dim + trans_dim)
        self.conv_block = ResidualBlock(conv_dim, conv_dim)

    def forward(self, x):
        conv_x, trans_x = torch.split(self.conv1_1(x),
                                      (self.conv_dim, self.trans_dim), dim=1)
        conv_x = self.conv_block(conv_x) + conv_x
        trans_x = nchw(self.trans_block(nhwc(trans_x)))
        return x + self.conv1_2(torch.cat((conv_x, trans_x), dim=1))


class ResidualUnit(nn.Module):
    def __init__(self, N):
        super().__init__()
        self.conv = nn.Sequential(conv1x1(N, N // 2), nn.ReLU(),
                                  conv3x3(N // 2, N // 2), nn.ReLU(),
                                  conv1x1(N // 2, N))
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.conv(x) + x)


class SwinBlock(nn.Module):
    def __init__(self, dim, head_dim, window):
        super().__init__()
        self.window = window
        self.block_1 = Block(dim, head_dim, window, "W")
        self.block_2 = Block(dim, head_dim, window, "SW")

    def forward(self, x):
        if x.shape[-1] <= self.window or x.shape[-2] <= self.window:
            raise ValueError("an input no larger than the window")
        return nchw(self.block_2(self.block_1(nhwc(x))))


class SWAtten(nn.Module):
    def __init__(self, dim, head_dim, window, inter_dim):
        super().__init__()
        self.conv_a = nn.Sequential(ResidualUnit(inter_dim),
                                    ResidualUnit(inter_dim),
                                    ResidualUnit(inter_dim))
        self.conv_b = nn.Sequential(ResidualUnit(inter_dim),
                                    ResidualUnit(inter_dim),
                                    ResidualUnit(inter_dim),
                                    conv1x1(inter_dim, inter_dim))
        self.non_local_block = SwinBlock(inter_dim, head_dim, window)
        self.in_conv = conv1x1(dim, inter_dim)
        self.out_conv = conv1x1(inter_dim, dim)

    def forward(self, x):
        x = self.in_conv(x)
        identity = x
        z = self.non_local_block(x)
        out = self.conv_a(x) * torch.sigmoid(self.conv_b(z))
        return self.out_conv(out + identity)


class _NHWC(nn.Sequential):
    """An NCHW stack behind an NHWC face."""

    def forward(self, x):
        return nhwc(super().forward(nchw(x)))


def _mixed(N, head_dim, window, n):
    return [ConvTransBlock(N, N, head_dim, window, "W" if not i % 2 else "SW")
            for i in range(n)]


def slice_net(c, cin):
    h1, h2 = c["cc_hidden"]
    return nn.Sequential(
        nn.Conv2d(cin, h1, 3, padding=1), nn.GELU(),
        nn.Conv2d(h1, h2, 3, padding=1), nn.GELU(),
        nn.Conv2d(h2, c["M"] // c["num_slices"], 3, padding=1))


# --------------------------------------------------- entropy bottleneck --

def ste_round(x):
    return x + (torch.round(x) - x).detach()


class EntropyBottleneck(nn.Module):
    def __init__(self, channels, filters, init_scale, tail_mass):
        super().__init__()
        self.filters = tuple(filters)
        self.tail_mass = tail_mass
        dims = (1,) + self.filters + (1,)
        s = init_scale ** (1.0 / (len(self.filters) + 1))
        for i in range(len(self.filters) + 1):
            init = math.log(math.expm1(1.0 / s / dims[i + 1]))
            self.register_parameter(f"_matrix{i}", nn.Parameter(
                torch.full((channels, dims[i + 1], dims[i]), init)))
            self.register_parameter(f"_bias{i}", nn.Parameter(
                torch.rand(channels, dims[i + 1], 1) - 0.5))
            if i < len(self.filters):
                self.register_parameter(f"_factor{i}", nn.Parameter(
                    torch.zeros(channels, dims[i + 1], 1)))
        self.quantiles = nn.Parameter(torch.tensor(
            [-init_scale, 0.0, init_scale]).repeat(channels, 1, 1))

    def logits_cumulative(self, x, stop_gradient=False):
        stop = (lambda t: t.detach()) if stop_gradient else (lambda t: t)
        for i in range(len(self.filters) + 1):
            x = torch.matmul(F.softplus(stop(getattr(self, f"_matrix{i}"))),
                             x) + stop(getattr(self, f"_bias{i}"))
            if i < len(self.filters):
                x = x + torch.tanh(stop(getattr(self, f"_factor{i}"))) \
                    * torch.tanh(x)
        return x

    def medians(self):
        return self.quantiles[:, 0, 1]

    def likelihood(self, values):
        """values NHWC (already quantized or noised) -> likelihoods NHWC."""
        B, H, W, C = values.shape
        v = values.permute(3, 0, 1, 2).reshape(C, 1, -1)
        lower = self.logits_cumulative(v - 0.5)
        upper = self.logits_cumulative(v + 0.5)
        sign = -torch.sign(lower + upper).detach()
        like = torch.abs(torch.sigmoid(sign * upper)
                         - torch.sigmoid(sign * lower))
        like = LowerBound.apply(like, 1e-9)
        return like.reshape(C, B, H, W).permute(1, 2, 3, 0)

    def aux_loss(self):
        logits = self.logits_cumulative(self.quantiles, stop_gradient=True)
        t = math.log(2.0 / self.tail_mass - 1.0)
        target = logits.new_tensor([-t, 0.0, t]).reshape(1, 1, 3)
        return torch.abs(logits - target).sum()


def gaussian_likelihood(values, scales, means, scale_bound=0.11):
    """P(round(y) == v) under N(means, scales^2), unit bins."""
    v = torch.abs(values - means)
    s = LowerBound.apply(scales, scale_bound)
    cdf = lambda t: 0.5 * torch.special.erfc(-(2 ** -0.5) * t)  # noqa
    like = cdf((0.5 - v) / s) - cdf((-0.5 - v) / s)
    return LowerBound.apply(like, 1e-9)


# ---------------------------------------------------------------- model --

class TCM(nn.Module):
    """The whole codec. c: the configuration's "model" dict (TCMConfig's
    fields: N, M, num_slices, max_support_slices, config, head_dim,
    window_size, hyper_window_size, hyper_head_dim, atten_head_dim,
    atten_inter_dim, cc_hidden and the entropy models')."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        N, M, S = c["N"], c["M"], c["num_slices"]
        n, hd, w = c["config"], c["head_dim"], c["window_size"]
        self.g_a = _NHWC(
            ResidualBlockWithStride(c["in_channels"], 2 * N, 2),
            *_mixed(N, hd[0], w, n[0]),
            ResidualBlockWithStride(2 * N, 2 * N, 2),
            *_mixed(N, hd[1], w, n[1]),
            ResidualBlockWithStride(2 * N, 2 * N, 2),
            *_mixed(N, hd[2], w, n[2]),
            conv3x3(2 * N, M, stride=2))
        self.g_s = _NHWC(
            ResidualBlockUpsample(M, 2 * N, 2),
            *_mixed(N, hd[3], w, n[3]),
            ResidualBlockUpsample(2 * N, 2 * N, 2),
            *_mixed(N, hd[4], w, n[4]),
            ResidualBlockUpsample(2 * N, 2 * N, 2),
            *_mixed(N, hd[5], w, n[5]),
            subpel_conv3x3(2 * N, c["out_channels"], 2))
        hw, hhd = c["hyper_window_size"], c["hyper_head_dim"]
        self.h_a = _NHWC(
            ResidualBlockWithStride(M, 2 * N, 2),
            *_mixed(N, hhd, hw, n[0]),
            conv3x3(2 * N, c["eb_channels"], stride=2))

        def h_s():
            return nn.Sequential(
                ResidualBlockUpsample(c["eb_channels"], 2 * N, 2),
                *_mixed(N, hhd, hw, n[3]),
                subpel_conv3x3(2 * N, M, 2))

        self.h_mean_s = h_s()
        self.h_scale_s = h_s()
        sd = M // S

        def dim(i):
            return M + sd * min(i, c["max_support_slices"])

        def atten(i):
            return nn.Sequential(SWAtten(dim(i), c["atten_head_dim"], w,
                                         c["atten_inter_dim"]))

        self.atten_mean = nn.ModuleList(atten(i) for i in range(S))
        self.atten_scale = nn.ModuleList(atten(i) for i in range(S))
        self.cc_mean_transforms = nn.ModuleList(
            slice_net(c, dim(i)) for i in range(S))
        self.cc_scale_transforms = nn.ModuleList(
            slice_net(c, dim(i)) for i in range(S))
        self.lrp_transforms = nn.ModuleList(
            slice_net(c, dim(i) + sd) for i in range(S))
        self.entropy_bottleneck = EntropyBottleneck(
            c["eb_channels"], c["eb_filters"], c["eb_init_scale"],
            c["eb_tail_mass"])

    @property
    def slice_dim(self) -> int:
        return self.c["M"] // self.c["num_slices"]

    def hyper_prior(self, z_hat):
        """(latent_scales, latent_means), NHWC."""
        z = nchw(z_hat)
        return nhwc(self.h_scale_s(z)), nhwc(self.h_mean_s(z))

    def slice_context(self, i, ls, lm, prev: List[torch.Tensor]):
        """(support, mu, sigma) of slice i, NHWC: the attended mean
        support and the slice's means and scales."""
        s = [nchw(t) for t in prev[: self.c["max_support_slices"]]]
        mean_support = self.atten_mean[i](torch.cat([nchw(lm), *s], dim=1))
        mu = self.cc_mean_transforms[i](mean_support)
        scale_support = self.atten_scale[i](torch.cat([nchw(ls), *s],
                                                      dim=1))
        sigma = self.cc_scale_transforms[i](scale_support)
        return nhwc(mean_support), nhwc(mu), nhwc(sigma)

    def lrp(self, i, support, y_hat_slice):
        lrp = self.lrp_transforms[i](torch.cat([nchw(support),
                                                nchw(y_hat_slice)], dim=1))
        return nhwc(0.5 * torch.tanh(lrp))

    def forward_train(self, x, noise: List[torch.Tensor]):
        """The training forward on NHWC x: noise[0] U[0,1) of z's shape,
        noise[1 + i] of slice i's. Returns (x_hat, y likelihoods, z
        likelihoods)."""
        y = self.g_a(x)
        z = self.h_a(y)
        eb = self.entropy_bottleneck
        z_like = eb.likelihood(z + (noise[0] - 0.5))
        med = eb.medians().reshape(1, 1, 1, -1)
        z_hat = ste_round(z - med) + med
        ls, lm = self.hyper_prior(z_hat)
        prev, likes = [], []
        for i, ys in enumerate(y.split(self.slice_dim, dim=-1)):
            support, mu, sigma = self.slice_context(i, ls, lm, prev)
            likes.append(gaussian_likelihood(ys + (noise[1 + i] - 0.5),
                                             sigma, mu))
            yh = ste_round(ys - mu) + mu
            prev.append(yh + self.lrp(i, support, yh))
        x_hat = self.g_s(torch.cat(prev, dim=-1))
        return x_hat, torch.cat(likes, dim=-1), z_like
