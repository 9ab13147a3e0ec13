"""The ELIC codec's work, counted from its shapes: FlopCounterMode over
the plain reference (reference/elic_model.py) on the meta device, as
yardstick.model_flops counts the DCAE's, and the 5x5 launches of the
hand convolution kernel (conv2d_nhwc_k5_tf32x3_kernel) with their least
times."""

from __future__ import annotations

from typing import Dict, List, Tuple

from harness import yardstick

# the card's top rate for f32 inputs (TF32); the kernel runs 3xTF32, three
# TF32 products an f32 one
TF32_FLOPS = yardstick.PEAK_FLOPS["float32"]


def model_flops(c: dict, B: int, H: int, W: int) -> Dict[str, float]:
    """FLOPs of the reference's pieces on B images of H x W: {"g_a",
    "h_a", "entropy" (the hyper synthesis, every group's channel context
    once and both passes of its parameters, which the reference computes
    on the whole map: one pass of the codec), "g_s"}."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from reference import elic_model as ref

    out = {}
    with torch.device("meta"), torch.no_grad():
        m = ref.ELIC(c)
        x = torch.empty(B, H, W, 3)

        def count(fn):
            with FlopCounterMode(display=False) as fc:
                r = fn()
            return fc.get_total_flops(), r

        out["g_a"], y = count(lambda: m.g_a(x))
        out["h_a"], z = count(lambda: m.h_a(y))

        def entropy():
            side = m.hyper_prior(z)
            prev, c0 = [], 0
            for k, g in enumerate(m.groups):
                part = y[..., c0:c0 + g]
                ctx = m.group_context(k, side, prev)
                m.group_params(k, ctx, None)
                m.group_params(k, ctx, part)
                prev.append(part)
                c0 += g
            return torch.cat(prev, dim=-1)

        out["entropy"], y_hat = count(entropy)
        out["g_s"], _ = count(lambda: m.g_s(y_hat))
    return out


def conv5_work(pixels: int, c_in: int, c_out: int, taps: int
               ) -> Tuple[float, float]:
    """(flops, bytes) of one 5x5 launch over `pixels` output pixels that
    runs `taps` taps: 2 taps C_in C_out a pixel; x, out and the weights
    (taps C_in C_out and the bias), each once, in f32."""
    flops = 2 * pixels * taps * c_in * c_out
    nbytes = 4 * (pixels * (c_in + c_out) + taps * c_in * c_out + c_out)
    return float(flops), float(nbytes)


def conv5_launches(c: dict, B: int, H: int, W: int, entropy_passes: int
                   ) -> List[Tuple[float, float]]:
    """The 5x5 launches of `entropy_passes` passes of the entropy model on
    B images of H x W, [(flops, bytes)]: each pass runs the three layers
    of every channel context (all 25 taps) and every group's spatial
    context (the 12 checkerboard taps) over the latent's extent."""
    from reference import elic_model as ref

    G, N = list(c["groups"]), c["N"]
    pixels = B * (H // 16) * (W // 16)
    one = []
    for k in range(1, len(G)):
        w = ref.ramp_widths(sum(G[:k]), 2 * G[k], N)
        one += [conv5_work(pixels, a, b, 25) for a, b in zip(w, w[1:])]
    one += [conv5_work(pixels, g, 2 * g, 12) for g in G]
    return one * entropy_passes


def least_time(flops: float, nbytes: float) -> float:
    """Seconds: three TF32 products an operation at the card's TF32 peak,
    or the bytes at its bandwidth, whichever is longer."""
    return max(3 * flops / TF32_FLOPS, nbytes / yardstick.PEAK_BYTES)
