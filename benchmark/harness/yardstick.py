"""The yardstick: published peaks of the card, the work of each layer
counted from its shapes, and the kernel-name regions of a device trace.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): 989
TFLOP/s for bf16 inputs, 495 TFLOP/s for f32 inputs (TF32, the highest
rate the card has for f32 inputs, so no kernel reads over 100% whether
it runs 3xTF32 or CUDA cores), 3.35 TB/s of HBM. A layer's least time is
the larger of its operations over the peak of its input dtype and its
bytes over the bandwidth; bytes are the input, the output and the
weights, each counted once.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}

# first match wins: the hand kernels by their __global__ names, cuDNN's
# convolutions (and the layout transposes around them) before cuBLAS,
# whose names they share, then PyTorch's elementwise and copy kernels
REGIONS: Tuple[Tuple[str, "re.Pattern"], ...] = (
    ("wmsa_kernel", re.compile(r"wmsa_(mma|tf32|pack|tf32_pack)_kernel")),
    ("conv_glu_kernel", re.compile(r"conv_glu_\w*kernel")),
    ("rans_lanes_kernel", re.compile(r"rans_lanes_\w*kernel")),
    ("nccl", re.compile(r"nccl", re.I)),
    ("conv_cudnn", re.compile(
        r"fprop|dgrad|wgrad|convolve|cudnn|conv2d|convolution|depthwise|"
        r"nchwToNhwc|nhwcToNchw", re.I)),
    ("gemm_cublas", re.compile(r"gemm|gemv|cutlass|cublas|addmm|\bmm\b|"
                               r"bmm|matmul|linear", re.I)),
    ("elementwise_copy", re.compile(
        r"elementwise|reduce|norm|softmax|memcpy|memset|copy|cat|index|"
        r"gather|scatter|fill|where|clamp|round|arange|scan|sort|pad|roll",
        re.I)),
)


def region(kernel_name: str) -> str:
    for name, rx in REGIONS:
        if rx.search(kernel_name):
            return name
    return "other"


def least_time(flops: float, nbytes: float, dtype: str) -> float:
    """Seconds: the larger of the compute and the memory bound."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


# ------------------------------------------------- the hand kernels' work --

def window_block_work(tokens: int, C: int, heads: int, dtype: str
                      ) -> Tuple[float, float]:
    """(flops, bytes) of one window-8 attention half-block (LN, qkv,
    scores and values over 64 keys, proj, residual) on `tokens` tokens:
    8 C^2 + 256 C operations a token; x and out, the qkv and proj weights
    and biases, LN, the residual scale and the bias table."""
    flops = tokens * (8 * C * C + 256 * C)
    weights = 4 * C * C + 4 * C + 3 * C + heads * 15 * 15
    return flops, (2 * tokens * C + weights) * DTYPE_BYTES[dtype]


def glu_work(tokens: int, C: int, h: int, dtype: str
             ) -> Tuple[float, float]:
    """(flops, bytes) of one LN + gated MLP (fc1 C -> 2h, 3x3 depthwise on
    h, gate, fc2 h -> C): 6 C h + 18 h operations a token."""
    flops = tokens * (6 * C * h + 18 * h)
    weights = 2 * C + 2 * C * h + 2 * h + 10 * h + h * C + C
    return flops, (2 * tokens * C + weights) * DTYPE_BYTES[dtype]


def stack_launches(c: dict, B: int, H: int, W: int, transforms_dtype: str,
                   entropy_passes: int
                   ) -> Dict[str, List[Tuple[float, float, str]]]:
    """The launches of the two hand-kernel layers in one call of the model
    on B images of H x W: g_a, g_s and `entropy_passes` passes of the
    slice contexts. {"wmsa": [(flops, bytes, dtype)],
    "glu": [...]}. The window-8 blocks of g_a / g_s go through the
    window kernel; gated MLPs whose widths are multiples of 128 (g_a /
    g_s stage 3, the dictionary attention's) through the GLU kernel."""
    out = {"wmsa": [], "glu": []}
    f, hd, n = c["feature_dim"], c["head_dim"], c["block_num"]
    for heads_dims in (hd[:3], hd[3:][::-1]):
        for s in range(3):
            tokens = B * (H >> (s + 1)) * (W >> (s + 1))
            C = f[s]
            for _ in range(n[s]):
                if c["window_size"] == 8:
                    out["wmsa"].append(window_block_work(
                        tokens, C, C // heads_dims[s], transforms_dtype)
                        + (transforms_dtype,))
                h = 2 * C
                if C % 128 == 0 and h % 128 == 0:
                    out["glu"].append(glu_work(tokens, C, h,
                                               transforms_dtype)
                                      + (transforms_dtype,))
    d = c["dict_head_num"] * c["dict_head_dim"]
    ytok = B * (H // 16) * (W // 16)
    h = c["mlp_rate"] * d // 2
    if d % 128 == 0 and h % 128 == 0:
        for _ in range(entropy_passes * c["num_slices"]):
            out["glu"].append(glu_work(ytok, d, h, "float32")
                              + ("float32",))
    return out


# ------------------------------------------------------ the model's work --

def model_flops(c: dict, B: int, H: int, W: int) -> Dict[str, float]:
    """FLOPs of the plain reference's pieces on B images of H x W, counted
    by FlopCounterMode on the meta device: {"g_a", "h_a", "entropy" (the
    hyper synthesis and every slice's context and LRP: one pass), "g_s"}.
    """
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from reference import model as ref

    out = {}
    with torch.device("meta"), torch.no_grad():
        m = ref.DCAE(c)
        x = torch.empty(B, H, W, 3)

        def count(fn):
            with FlopCounterMode(display=False) as fc:
                r = fn()
            return fc.get_total_flops(), r

        out["g_a"], y = count(lambda: m.g_a(x))
        out["h_a"], z = count(lambda: m.h_a(y))

        def entropy():
            ls, lm = m.hyper_prior(z)
            prev = []
            for i, ys in enumerate(y.split(m.slice_dim, dim=-1)):
                support, mu, _ = m.slice_context(i, ls, lm, prev)
                prev.append(ys + m.lrp(i, support, ys))
            return torch.cat(prev, dim=-1)

        out["entropy"], y_hat = count(entropy)
        out["g_s"], _ = count(lambda: m.g_s(y_hat))
    return out
