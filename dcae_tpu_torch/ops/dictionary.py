"""Dictionary-based cross-attention entropy-model blocks (the paper's core).

A learnable dictionary (128 x 640) is queried per channel-AR slice by
multi-head cross-attention: Q comes from the slice's context feature map,
K from the LayerNormed dictionary, V is the normed dictionary itself, with
a learnable per-head temperature. Before it, a multi-scale aggregation
(dense depthwise convs + a spatial gate); after it, a gated conv MLP that
goes through the conv_glu kernel. NHWC; names follow the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from dcae_tpu_torch.ops.blocks import ConvolutionalGLU, Scale
from dcae_tpu_torch.ops.kernels.conv_glu import supported
from dcae_tpu_torch.ops.layers import Conv, Dense, LayerNorm, gelu


class SpatialAttentionModule(nn.Module):
    """sigmoid(conv7x7(cat(mean_c, max_c))) spatial gate."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv(2, 1, 7, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = x.mean(dim=-1, keepdim=True)
        mx = x.amax(dim=-1, keepdim=True)
        return torch.sigmoid(self.conv1(torch.cat([avg, mx], dim=-1)))


class ConvWithDW(nn.Module):
    """1x1 -> gelu -> dw3x3 -> gelu -> 1x1."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_trans = Conv(dim, dim, 1)
        self.dw_conv = Conv(dim, dim, 3, groups=dim)
        self.out_trans = Conv(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = gelu(self.dw_conv(self.in_trans(x, act="gelu")))
        return self.out_trans(h)


class DenseBlock(nn.Module):
    """3 gelu+ConvWithDW layers with dense concatenation, 1x1 projection."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_layers = nn.ModuleList(
            nn.Sequential(nn.GELU(), ConvWithDW(dim)) for _ in range(3))
        self.proj = Conv(4 * dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outputs = [x]
        for layer in self.conv_layers:
            outputs.append(layer(outputs[-1]))
        return self.proj(torch.cat(outputs, dim=-1))


class MultiScaleAggregation(nn.Module):
    """1x1 -> DenseBlock -> x spatial attention."""

    def __init__(self, dim: int):
        super().__init__()
        self.s = Conv(dim, dim, 1)
        self.dense = DenseBlock(dim)
        self.spatial_atte = SpatialAttentionModule()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s_out = self.dense(self.s(x))
        return s_out * self.spatial_atte(s_out)


class DictionaryCrossAttention(nn.Module):
    """MutiScaleDictionaryCrossAttentionGLU.

    query: (B, H, W, C_query) slice context; dt: (n, dict_dim) dictionary.
    Returns (B, H, W, output_dim).
    """

    def __init__(self, input_dim: int, output_dim: int, head_num: int = 20,
                 head_dim: int = 32, mlp_rate: int = 4,
                 qkv_bias: bool = True):
        super().__init__()
        d = head_num * head_dim
        self.head_num = head_num
        self.head_dim = head_dim
        self.x_trans = Dense(input_dim, d, bias=qkv_bias)
        self.ln_scale = LayerNorm(d)
        self.msa = MultiScaleAggregation(d)
        self.res_scale_1 = Scale(d)
        self.lnx = LayerNorm(d)
        self.q_trans = Dense(d, d, bias=qkv_bias)
        self.dict_ln = LayerNorm(d)
        self.k = Dense(d, d, bias=qkv_bias)
        self.scale = nn.Parameter(torch.ones(head_num, 1, 1))
        self.linear = Dense(d, d, bias=qkv_bias)
        self.res_scale_2 = Scale(d)
        self.ln_mlp = LayerNorm(d)
        self.mlp = ConvolutionalGLU(d, mlp_rate * d)
        self.res_scale_3 = Scale(d)
        self.output_trans = nn.Sequential(Dense(d, output_dim))

    def forward(self, query: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = query.shape
        E, c = self.head_num, self.head_dim
        x = self.x_trans(query)
        x = self.msa(self.ln_scale(x)) + self.res_scale_1(x)

        shortcut = x
        q = self.q_trans(self.lnx(x)).reshape(B, H * W, E, c)
        dt_n = self.dict_ln(dt)
        k = self.k(dt_n).reshape(-1, E, c)
        v = dt_n.reshape(-1, E, c)
        # dictionary attention: (B, E, HW, c) x (E, c, n) per head
        sim = torch.matmul(q.permute(0, 2, 1, 3), k.permute(1, 2, 0))
        probs = torch.softmax(sim * self.scale[None], dim=-1)
        out = torch.matmul(probs, v.permute(1, 0, 2))      # (B, E, HW, c)
        out = out.permute(0, 2, 1, 3).reshape(B, H, W, E * c)
        out = self.linear(out) + self.res_scale_2(shortcut)

        if supported(E * c, self.mlp.hidden, out.dtype):
            h = self.mlp.fused(out, self.ln_mlp)
        else:
            h = self.mlp(self.ln_mlp(out))
        out = h + self.res_scale_3(out)
        return self.output_trans(out)
