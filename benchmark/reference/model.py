"""The plain reference of the DCAE codec: f32 PyTorch, NHWC, no kernels.

A frozen statement of the model (Lu et al., "Learned Image Compression
with Dictionary-based Entropy Model", CVPR 2025) that the benchmark judges
the program against. Module and parameter names are the published state
dict's, so one state dict loads into both. Every window attention is the
textbook statement (qkv, scores plus the relative-position bias, the
shifted windows' mask, softmax, proj); every gated MLP is LN, fc1, a 3x3
depthwise conv, GELU gate, fc2. Nothing here imports the program.

Departures from the published code: none in the mathematics. Windows of
a stack smaller than the window are centre-padded and cropped back, as
the published SwinBlockWithConvMulti does.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# --------------------------------------------------------------- layers --

class Conv(nn.Conv2d):
    """NHWC convolution, padding k // 2."""

    def __init__(self, cin, cout, k=5, stride=1, groups=1, bias=True):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2,
                         groups=groups, bias=bias)

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Deconv(nn.ConvTranspose2d):
    """NHWC transposed convolution that upsamples exactly by `stride`."""

    def __init__(self, cin, cout, k=5, stride=2):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2,
                         output_padding=stride - 1)

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def LayerNorm(dim):
    return nn.LayerNorm(dim, eps=1e-5)


class Scale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.scale


class ResidualBottleneckBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        mid = min(cin, cout) // 2
        self.conv1 = Conv(cin, mid, 1)
        self.conv2 = Conv(mid, mid, 3)
        self.conv3 = Conv(mid, cout, 1)
        self.skip = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        identity = x if self.skip is None else self.skip(x)
        h = F.relu(self.conv2(F.relu(self.conv1(x))))
        return self.conv3(h) + identity


class ResidualBottleneckBlockWithStride(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv(cin, cout, 5, stride=2)
        self.res1 = ResidualBottleneckBlock(cout, cout)
        self.res2 = ResidualBottleneckBlock(cout, cout)
        self.res3 = ResidualBottleneckBlock(cout, cout)

    def forward(self, x):
        return self.res3(self.res2(self.res1(self.conv(x))))


class ResidualBottleneckBlockWithUpsample(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.res1 = ResidualBottleneckBlock(cin, cin)
        self.res2 = ResidualBottleneckBlock(cin, cin)
        self.res3 = ResidualBottleneckBlock(cin, cin)
        self.conv = Deconv(cin, cout, 5, 2)

    def forward(self, x):
        return self.conv(self.res3(self.res2(self.res1(x))))


def window_mask(nh: int, nw: int, w: int, device) -> torch.Tensor:
    """(nh*nw, P, P), True where a shifted window's two parts meet."""
    s = w - w // 2
    r = np.arange(w * w) // w
    c = np.arange(w * w) % w
    rows = (r[:, None] < s) != (r[None, :] < s)
    cols = (c[:, None] < s) != (c[None, :] < s)
    mask = np.zeros((nh, nw, w * w, w * w), bool)
    mask[-1, :] |= rows
    mask[:, -1] |= cols
    return torch.as_tensor(mask.reshape(nh * nw, w * w, w * w),
                           device=device)


def rel_bias(table: torch.Tensor, w: int) -> torch.Tensor:
    """(heads, P, P): table[h, dy + w - 1, dx + w - 1]."""
    coords = np.array([[i, j] for i in range(w) for j in range(w)])
    idx = coords[:, None, :] - coords[None, :, :] + w - 1
    iy = torch.as_tensor(idx[..., 0], device=table.device)
    ix = torch.as_tensor(idx[..., 1], device=table.device)
    return table[:, iy, ix]


class WMSA(nn.Module):
    """Window multi-head self-attention, plain ('W' or shifted 'SW')."""

    def __init__(self, dim, head_dim, window, shifted=False):
        super().__init__()
        self.head_dim = head_dim
        self.heads = dim // head_dim
        self.window = window
        self.shifted = shifted
        self.embedding_layer = nn.Linear(dim, 3 * dim)
        self.linear = nn.Linear(dim, dim)
        self.relative_position_params = nn.Parameter(torch.empty(
            self.heads, 2 * window - 1, 2 * window - 1))

    def forward(self, x):
        w, heads, hd = self.window, self.heads, self.head_dim
        B, H, W, C = x.shape
        if self.shifted:
            x = torch.roll(x, shifts=(-(w // 2), -(w // 2)), dims=(1, 2))
        nh, nw = H // w, W // w
        xw = x.reshape(B, nh, w, nw, w, C).permute(0, 1, 3, 2, 4, 5)
        qkv = self.embedding_layer(xw.reshape(B, nh * nw, w * w, C))
        q, k, v = (t.reshape(B, nh * nw, w * w, heads, hd)
                   .permute(0, 3, 1, 2, 4) for t in qkv.split(C, dim=-1))
        sim = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
        sim = sim + rel_bias(self.relative_position_params, w)[
            None, :, None]
        if self.shifted:
            sim = sim.masked_fill(window_mask(nh, nw, w, x.device)[
                None, None], float("-inf"))
        out = torch.matmul(torch.softmax(sim, dim=-1), v)
        out = self.linear(out.permute(0, 2, 3, 1, 4).reshape(
            B, nh * nw, w * w, C))
        out = out.reshape(B, nh, nw, w, w, C).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(B, H, W, C)
        if self.shifted:
            out = torch.roll(out, shifts=(w // 2, w // 2), dims=(1, 2))
        return out


class DWConv(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dwconv = Conv(dim, dim, 3, groups=dim)

    def forward(self, x):
        return self.dwconv(x)


class ConvolutionalGLU(nn.Module):
    def __init__(self, dim, hidden_features):
        super().__init__()
        self.hidden = hidden_features // 2
        self.fc1 = nn.Linear(dim, 2 * self.hidden)
        self.dwconv = DWConv(self.hidden)
        self.fc2 = nn.Linear(self.hidden, dim)

    def forward(self, x):
        g, v = self.fc1(x).split(self.hidden, dim=-1)
        return self.fc2(F.gelu(self.dwconv(g)) * v)


class ResScaleConvolutionGateBlock(nn.Module):
    def __init__(self, dim, head_dim, window, shifted=False):
        super().__init__()
        self.ln1 = LayerNorm(dim)
        self.msa = WMSA(dim, head_dim, window, shifted)
        self.res_scale_1 = Scale(dim)
        self.ln2 = LayerNorm(dim)
        self.mlp = ConvolutionalGLU(dim, dim * 4)
        self.res_scale_2 = Scale(dim)

    def forward(self, x):
        x = self.res_scale_1(x) + self.msa(self.ln1(x))
        return self.res_scale_2(x) + self.mlp(self.ln2(x))


class SwinStack(nn.Module):
    def __init__(self, dim, head_dim, window, block_num):
        super().__init__()
        self.window = window
        self.layers = nn.ModuleList(
            ResScaleConvolutionGateBlock(dim, head_dim, window,
                                         shifted=(i % 2 == 1))
            for i in range(block_num))
        self.conv = Conv(dim, dim, 3)

    def forward(self, x):
        B, H, W, C = x.shape
        w = self.window
        ph, pw = (-H) % w, (-W) % w
        t = x
        if ph or pw:
            t = F.pad(t, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        for layer in self.layers:
            t = layer(t)
        if ph or pw:
            t = t[:, ph // 2: ph // 2 + H, pw // 2: pw // 2 + W]
        return self.conv(t) + x


# ------------------------------------------------ dictionary attention --

class SpatialAttentionModule(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv(2, 1, 7, bias=False)

    def forward(self, x):
        avg = x.mean(dim=-1, keepdim=True)
        mx = x.amax(dim=-1, keepdim=True)
        return torch.sigmoid(self.conv1(torch.cat([avg, mx], dim=-1)))


class ConvWithDW(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.in_trans = Conv(dim, dim, 1)
        self.dw_conv = Conv(dim, dim, 3, groups=dim)
        self.out_trans = Conv(dim, dim, 1)

    def forward(self, x):
        return self.out_trans(F.gelu(self.dw_conv(F.gelu(self.in_trans(x)))))


class DenseBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv_layers = nn.ModuleList(
            nn.Sequential(nn.GELU(), ConvWithDW(dim)) for _ in range(3))
        self.proj = Conv(4 * dim, dim, 1)

    def forward(self, x):
        outs = [x]
        for layer in self.conv_layers:
            outs.append(layer(outs[-1]))
        return self.proj(torch.cat(outs, dim=-1))


class MultiScaleAggregation(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.s = Conv(dim, dim, 1)
        self.dense = DenseBlock(dim)
        self.spatial_atte = SpatialAttentionModule()

    def forward(self, x):
        s = self.dense(self.s(x))
        return s * self.spatial_atte(s)


class DictionaryCrossAttention(nn.Module):
    def __init__(self, input_dim, output_dim, head_num, head_dim, mlp_rate,
                 qkv_bias=True):
        super().__init__()
        d = head_num * head_dim
        self.head_num, self.head_dim = head_num, head_dim
        self.x_trans = nn.Linear(input_dim, d, bias=qkv_bias)
        self.ln_scale = LayerNorm(d)
        self.msa = MultiScaleAggregation(d)
        self.res_scale_1 = Scale(d)
        self.lnx = LayerNorm(d)
        self.q_trans = nn.Linear(d, d, bias=qkv_bias)
        self.dict_ln = LayerNorm(d)
        self.k = nn.Linear(d, d, bias=qkv_bias)
        self.scale = nn.Parameter(torch.ones(head_num, 1, 1))
        self.linear = nn.Linear(d, d, bias=qkv_bias)
        self.res_scale_2 = Scale(d)
        self.ln_mlp = LayerNorm(d)
        self.mlp = ConvolutionalGLU(d, mlp_rate * d)
        self.res_scale_3 = Scale(d)
        self.output_trans = nn.Sequential(nn.Linear(d, output_dim))

    def forward(self, query, dt):
        B, H, W, _ = query.shape
        E, c = self.head_num, self.head_dim
        x = self.x_trans(query)
        x = self.msa(self.ln_scale(x)) + self.res_scale_1(x)
        shortcut = x
        q = self.q_trans(self.lnx(x)).reshape(B, H * W, E, c)
        dt_n = self.dict_ln(dt)
        k = self.k(dt_n).reshape(-1, E, c)
        v = dt_n.reshape(-1, E, c)
        sim = torch.matmul(q.permute(0, 2, 1, 3), k.permute(1, 2, 0))
        probs = torch.softmax(sim * self.scale[None], dim=-1)
        out = torch.matmul(probs, v.permute(1, 0, 2))
        out = out.permute(0, 2, 1, 3).reshape(B, H, W, E * c)
        out = self.linear(out) + self.res_scale_2(shortcut)
        out = self.mlp(self.ln_mlp(out)) + self.res_scale_3(out)
        return self.output_trans(out)


# ----------------------------------------------------------- transforms --

def g_analysis(c):
    f, hd, n, w = c["feature_dim"], c["head_dim"], c["block_num"], \
        c["window_size"]
    return nn.Sequential(
        ResidualBottleneckBlockWithStride(c["in_channels"], f[0]),
        SwinStack(f[0], hd[0], w, n[0]),
        ResidualBottleneckBlockWithStride(f[0], f[1]),
        SwinStack(f[1], hd[1], w, n[1]),
        ResidualBottleneckBlockWithStride(f[1], f[2]),
        SwinStack(f[2], hd[2], w, n[2]),
        Conv(f[2], c["M"], 5, stride=2))


def g_synthesis(c):
    f, hd, n, w = c["feature_dim"], c["head_dim"], c["block_num"], \
        c["window_size"]
    return nn.Sequential(
        Deconv(c["M"], f[2], 5, 2),
        SwinStack(f[2], hd[3], w, n[2]),
        ResidualBottleneckBlockWithUpsample(f[2], f[1]),
        SwinStack(f[1], hd[4], w, n[1]),
        ResidualBottleneckBlockWithUpsample(f[1], f[0]),
        SwinStack(f[0], hd[5], w, n[0]),
        ResidualBottleneckBlockWithUpsample(f[0], c["out_channels"]))


def hyper_analysis(c):
    return nn.Sequential(
        ResidualBottleneckBlockWithStride(c["M"], c["N"]),
        SwinStack(c["N"], c["hyper_head_dim"], c["hyper_window_size"], 1),
        Conv(c["N"], c["eb_channels"], 3, stride=2))


def hyper_synthesis(c):
    return nn.Sequential(
        Deconv(c["eb_channels"], c["N"], 3, 2),
        SwinStack(c["N"], c["hyper_head_dim"], c["hyper_window_size"], 1),
        ResidualBottleneckBlockWithUpsample(c["N"], c["M"]))


def slice_net(c, cin):
    h1, h2 = c["cc_hidden"]
    return nn.Sequential(Conv(cin, h1, 3), nn.GELU(), Conv(h1, h2, 3),
                         nn.GELU(), Conv(h2, c["M"] // c["num_slices"], 3))


# --------------------------------------------------- entropy bottleneck --

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


def ste_round(x):
    return x + (torch.round(x) - x).detach()


class EntropyBottleneck(nn.Module):
    def __init__(self, channels, filters, init_scale, tail_mass):
        super().__init__()
        self.filters = tuple(filters)
        self.tail_mass = tail_mass
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


def scale_indexes(scales, scale_table, scale_bound=0.11):
    """Index of the smallest table scale >= max(sigma, bound)."""
    s = torch.clamp_min(scales, scale_bound)
    t = scale_table.to(device=s.device, dtype=s.dtype)[:-1]
    return (t < s[..., None]).sum(dim=-1, dtype=torch.int32)


def scale_table(c) -> np.ndarray:
    return np.exp(np.linspace(math.log(c["scales_min"]),
                              math.log(c["scales_max"]), c["scales_levels"],
                              dtype=np.float64)).astype(np.float32)


# ---------------------------------------------------------------- model --

class DCAE(nn.Module):
    """The whole codec: transforms, hyper prior, dictionary entropy model.

    c: the configuration's "model" dict (the published widths)."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        S, M = c["num_slices"], c["M"]
        sd = M // S
        self.g_a = g_analysis(c)
        self.g_s = g_synthesis(c)
        self.h_a = hyper_analysis(c)
        self.h_z_s1 = hyper_synthesis(c)
        self.h_z_s2 = hyper_synthesis(c)
        dict_dim = c["dict_head_num"] * c["dict_head_dim"]
        self.dt = nn.Parameter(torch.empty(c["dict_num"], dict_dim))

        def qdim(i):
            return 2 * M + sd * min(i, c["max_support_slices"])

        self.dt_cross_attention = nn.ModuleList(
            DictionaryCrossAttention(qdim(i), M, c["dict_head_num"],
                                     c["dict_head_dim"], c["mlp_rate"],
                                     c["qkv_bias"]) for i in range(S))
        self.cc_mean_transforms = nn.ModuleList(
            slice_net(c, qdim(i) + M) for i in range(S))
        self.cc_scale_transforms = nn.ModuleList(
            slice_net(c, qdim(i) + M) for i in range(S))
        self.lrp_transforms = nn.ModuleList(
            slice_net(c, qdim(i) + M + sd) for i in range(S))
        self.entropy_bottleneck = EntropyBottleneck(
            c["eb_channels"], c["eb_filters"], c["eb_init_scale"],
            c["eb_tail_mass"])

    @property
    def slice_dim(self) -> int:
        return self.c["M"] // self.c["num_slices"]

    def slice_context(self, i, ls, lm, prev: List[torch.Tensor]):
        """(support, mu, sigma) of slice i from the hyper prior and the
        slices before it."""
        query = torch.cat([ls, lm, *prev[: self.c["max_support_slices"]]],
                          dim=-1)
        support = torch.cat(
            [query, self.dt_cross_attention[i](query, self.dt)], dim=-1)
        return (support, self.cc_mean_transforms[i](support),
                self.cc_scale_transforms[i](support))

    def lrp(self, i, support, y_hat_slice):
        return 0.5 * torch.tanh(self.lrp_transforms[i](
            torch.cat([support, y_hat_slice], dim=-1)))

    def hyper_prior(self, z_hat):
        return self.h_z_s1(z_hat), self.h_z_s2(z_hat)

    def forward_train(self, x, noise: List[torch.Tensor]):
        """The training forward: noise[0] U[0,1) of z's shape, noise[1 + i]
        of slice i's. Returns (x_hat, y likelihoods, z likelihoods)."""
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


def rd_loss(x_hat, y_like, z_like, target, lmbda):
    """lambda * 255^2 * MSE + bpp, and its two terms."""
    B, H, W, _ = target.shape
    bpp = (torch.log(y_like).sum() + torch.log(z_like).sum()) \
        / (-math.log(2) * B * H * W)
    mse = torch.mean((x_hat - target) ** 2)
    return lmbda * 255 ** 2 * mse + bpp, mse, bpp
