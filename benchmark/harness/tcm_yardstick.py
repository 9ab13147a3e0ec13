"""The TCM codec's work, counted from its shapes: the window kernel's
launches, as yardstick.stack_launches counts the DCAE's, and
FlopCounterMode over the plain reference (reference/tcm_model.py) on the
meta device, as yardstick.model_flops counts the DCAE's."""

from __future__ import annotations

from typing import Dict, List, Tuple

from harness import yardstick


def window_launches(c: dict, B: int, H: int, W: int, transforms_dtype: str,
                    entropy_passes: int) -> List[Tuple[float, float, str]]:
    """The window kernel's launches in one call of the TCM codec on B
    images of H x W, [(flops, bytes, dtype)]: the window-8 Swin blocks of
    g_a and g_s (N channels, one a mixed block) in the transforms' dtype,
    and the two blocks of each SWAtten (two a slice, at the latent's
    extent, atten_inter_dim channels) in f32, `entropy_passes` passes.
    The window-4 blocks of h_a and the hyper synthesis run plain."""
    out = []
    N, hd, n = c["N"], c["head_dim"], c["config"]
    if c["window_size"] == 8:
        for s, (heads_dim, blocks) in enumerate(zip(hd, n)):
            down = 1 + (s if s < 3 else 5 - s)      # H/2, /4, /8, /8, /4, /2
            tokens = B * (H >> down) * (W >> down)
            out += [yardstick.window_block_work(
                tokens, N, N // heads_dim, transforms_dtype)
                + (transforms_dtype,)] * blocks
        C = c["atten_inter_dim"]
        tokens = B * (H // 16) * (W // 16)
        out += [yardstick.window_block_work(
            tokens, C, C // c["atten_head_dim"], "float32") + ("float32",)] \
            * (2 * 2 * c["num_slices"] * entropy_passes)
    return out


def model_flops(c: dict, B: int, H: int, W: int) -> Dict[str, float]:
    """FLOPs of the reference's pieces on B images of H x W: {"g_a",
    "h_a", "entropy" (the hyper synthesis and every slice's context and
    LRP: one pass), "g_s"}."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from reference import tcm_model as ref

    out = {}
    with torch.device("meta"), torch.no_grad():
        m = ref.TCM(c)
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
