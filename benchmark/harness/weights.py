"""Seeded weights of the DCAE codec, made on the device in two draws.

The layout is the published state dict's (the plain reference's module
tree, built on the meta device, names every tensor). Each tensor takes
the published initial distribution: torch's fan-in uniform for
convolutions and linear layers, unit LayerNorm scales and residual
scales, N(0, 0.02) clipped at two deviations for the relative-position
tables, N(0, 1) for the dictionary, and the entropy bottleneck's own
init (constant matrices, U(-0.5, 0.5) biases, zero factors, quantiles at
-s, 0, s). One U[0, 1) draw and one N(0, 1) draw of the whole model, on
the device, from one generator seeded by the run's seed, feed them all.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from reference import model as ref


def _plan(c: dict):
    """[(name, shape, kind, arg)]: kind 'u' (U(-arg, arg)), 'n' (N(0,
    arg^2) clipped at 2 arg), 'c' (constant arg) or 'q' (quantiles)."""
    with torch.device("meta"):
        m = ref.DCAE(c)
    plan = []
    done = set()
    for mname, mod in m.named_modules():
        pre = mname + "." if mname else ""
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = mod.weight
            fan_in = (w.shape[1] * w[0, 0].numel()
                      if isinstance(mod, nn.ConvTranspose2d) else w[0].numel())
            bound = 1.0 / math.sqrt(fan_in)
            plan.append((pre + "weight", tuple(w.shape), "u", bound))
            if mod.bias is not None:
                plan.append((pre + "bias", tuple(mod.bias.shape), "u", bound))
            done.update({pre + "weight", pre + "bias"})
        elif isinstance(mod, nn.LayerNorm):
            plan.append((pre + "weight", tuple(mod.weight.shape), "c", 1.0))
            plan.append((pre + "bias", tuple(mod.bias.shape), "c", 0.0))
            done.update({pre + "weight", pre + "bias"})
        elif isinstance(mod, ref.EntropyBottleneck):
            dims = (1,) + mod.filters + (1,)
            s = c["eb_init_scale"] ** (1.0 / (len(mod.filters) + 1))
            for i in range(len(mod.filters) + 1):
                mat = getattr(mod, f"_matrix{i}")
                plan.append((f"{pre}_matrix{i}", tuple(mat.shape), "c",
                             math.log(math.expm1(1.0 / s / dims[i + 1]))))
                b = getattr(mod, f"_bias{i}")
                plan.append((f"{pre}_bias{i}", tuple(b.shape), "u", 0.5))
                done.update({f"{pre}_matrix{i}", f"{pre}_bias{i}"})
                if i < len(mod.filters):
                    f = getattr(mod, f"_factor{i}")
                    plan.append((f"{pre}_factor{i}", tuple(f.shape), "c", 0.0))
                    done.add(f"{pre}_factor{i}")
            plan.append((pre + "quantiles", tuple(mod.quantiles.shape), "q",
                         c["eb_init_scale"]))
            done.add(pre + "quantiles")
    for name, p in m.named_parameters():
        if name in done:
            continue
        if name.endswith("relative_position_params"):
            plan.append((name, tuple(p.shape), "n", 0.02))
        elif name == "dt":
            plan.append((name, tuple(p.shape), "n", 1.0))
        elif name.endswith("scale"):          # residual and head scales
            plan.append((name, tuple(p.shape), "c", 1.0))
        else:
            raise KeyError(f"no initial distribution for {name}")
    return plan


def make(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of seed `seed`, f32, on `device`."""
    plan = _plan(c)
    n_u = sum(math.prod(s) for _, s, k, _ in plan if k == "u")
    n_n = sum(math.prod(s) for _, s, k, _ in plan if k == "n")
    g = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(n_u, generator=g, device=device)
    z = torch.randn(n_n, generator=g, device=device)
    out, iu, iz = {}, 0, 0
    for name, shape, kind, arg in plan:
        k = math.prod(shape)
        if kind == "u":
            t = (u[iu:iu + k] * (2 * arg) - arg).view(shape)
            iu += k
        elif kind == "n":
            t = (z[iz:iz + k].clamp(-2.0, 2.0) * arg).view(shape)
            iz += k
        elif kind == "c":
            t = torch.full(shape, arg, device=device)
        else:
            t = torch.tensor([-arg, 0.0, arg], device=device).repeat(
                shape[0], 1, 1)
        out[name] = t
    return out
