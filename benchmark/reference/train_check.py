"""The judge of the training cells: the plain reference follows the
program's first three steps from the same weights, crops and noise seed,
in f32 with TF32 off, and compares

  loss_gap         the largest |loss - loss_ref| / |loss_ref| over the three
                   steps (the RD loss plus the quantiles' aux loss);
  first_loss_gap   the same of the first step alone, before any update:
                   steady where the later steps' losses carry the round-off
                   of the updates (Adam's first updates are sign-like, so a
                   gradient element whose sign differs by round-off, or by
                   a data-parallel all-reduce's other summation order,
                   moves its weight by twice the step and the third loss
                   with it);
  grad_norm_gap    the worst leaf's | |g| - |g_ref| | / max(|g_ref|, the
                   median leaf's |g_ref|), g the first step's gradient as
                   the optimizer got it (after clipping; the program's is
                   read from its Adam state after one step);
  change_norm_gap  the same of each leaf's change over the three steps,
                   over the leaves whose first gradient is not nought to
                   rounding (|g_ref| at least a thousandth of the median
                   leaf's): under Adam a leaf with no gradient moves by
                   round-off alone.

The recipe: rate-distortion loss (lambda * 255^2 * MSE + bpp) plus the
bottleneck's quantile loss, one backward; Adam (torch's formula) over
every parameter but the quantiles behind global-norm clipping; a second
Adam over the quantiles. The training noise (U[0, 1) for z, then for each
y slice) is drawn from a generator on the device seeded as the
program's, in the order the program draws it.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from reference import model as ref

BETAS = (0.9, 0.999)
EPS = 1e-8


class Adam:
    """torch.optim.Adam's update, stated plainly."""

    def __init__(self, params: List[torch.Tensor], lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(c2)).add_(EPS)
            p.addcdiv_(m, denom, value=-self.lr / c1)


def noise_shapes(c: dict, B: int, H: int, W: int):
    zd, yd = 2 ** (len(c["feature_dim"]) + 1) * 4, 2 ** (
        len(c["feature_dim"]) + 1)
    sd = c["M"] // c["num_slices"]
    return ([(B, H // zd, W // zd, c["eb_channels"])]
            + [(B, H // yd, W // yd, sd)] * c["num_slices"])


def steps(c: dict, recipe: dict, state: Dict[str, torch.Tensor],
          batches: List[np.ndarray], noise_seed: int, device,
          chunk: int = 0) -> dict:
    """The reference's steps on `batches`: {"loss": [...], "grad": {leaf:
    |g| of step 1}, "change": {leaf: |p_n - p_0|}}. chunk: rows a forward
    and backward at a time (the loss is a mean over equal chunks, so the
    gradient of their mean is the whole batch's); 0: the whole batch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = ref.DCAE(c)
    m.load_state_dict(state, strict=True)
    m = m.to(device)
    named = list(m.named_parameters())
    main = [p for n, p in named if "quantiles" not in n]
    aux = [p for n, p in named if "quantiles" in n]
    p0 = {n: p.detach().clone() for n, p in named}
    opt, aux_opt = Adam(main, recipe["learning_rate"]), \
        Adam(aux, recipe["aux_learning_rate"])
    gen = torch.Generator(device=device).manual_seed(int(noise_seed))
    out = {"loss": [], "grad": {}, "change": {}}
    for t, xb in enumerate(batches):
        x = torch.as_tensor(xb, device=device)
        noise = [torch.rand(s, generator=gen, dtype=torch.float32,
                            device=device)
                 for s in noise_shapes(c, *x.shape[:3])]
        for p in m.parameters():
            p.grad = None
        k = chunk or len(x)
        parts = range(0, len(x), k)
        rd = 0.0
        for a in parts:
            x_hat, y_like, z_like = m.forward_train(
                x[a:a + k], [n[a:a + k] for n in noise])
            loss, _, _ = ref.rd_loss(x_hat, y_like, z_like, x[a:a + k],
                                     recipe["lmbda"])
            (loss / len(parts)).backward()
            rd += float(loss.detach()) / len(parts)
        aux = m.entropy_bottleneck.aux_loss()
        aux.backward()
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(p.grad) for p in main]))
            if float(norm) > recipe["clip_max_norm"]:
                for p in main:
                    p.grad.mul_(recipe["clip_max_norm"] / norm)
        if t == 0:
            out["grad"] = {n: float(torch.linalg.vector_norm(p.grad))
                           for n, p in named}
        opt.step()
        aux_opt.step()
        out["loss"].append(rd + float(aux.detach()))
    with torch.no_grad():
        out["change"] = {n: float(torch.linalg.vector_norm(p - p0[n]))
                         for n, p in named}
    return out


def _leaf_gap(prog: Dict[str, float], refd: Dict[str, float], keep):
    """(worst gap, its leaf, the program's and the reference's norm of it,
    the median leaf's)."""
    names = [n for n in refd if keep(n)]
    med = float(np.median([refd[n] for n in names]))
    gap = {n: abs(prog[n] - refd[n]) / max(refd[n], med, 1e-30)
           for n in names}
    gap = {n: (v if math.isfinite(v) else math.inf) for n, v in gap.items()}
    w = max(gap, key=gap.get)
    return gap[w], w, prog[w], refd[w], med


def compare(prog: dict, refd: dict) -> dict:
    """The numbers of the module docstring, and under "worst" the
    leaf each gap is of (leaf, program's norm, reference's, median) and
    the leaves left out of the change."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["loss"], refd["loss"]))
    if len(prog["loss"]) != len(refd["loss"]) or \
            any(not math.isfinite(v) for v in prog["loss"]):
        loss_gap = math.inf
    g = refd["grad"]
    med = float(np.median(list(g.values())))
    moved = lambda n: g[n] >= 1e-3 * med  # noqa: E731
    gg = _leaf_gap(prog["grad"], g, lambda n: True)
    cg = _leaf_gap(prog["change"], refd["change"], moved)
    first = abs(prog["loss"][0] - refd["loss"][0]) / max(
        abs(refd["loss"][0]), 1e-30) if prog["loss"] else math.inf
    return {"loss_gap": loss_gap, "first_loss_gap": first,
            "grad_norm_gap": gg[0],
            "change_norm_gap": cg[0],
            "worst": {"grad": gg[1:], "change": cg[1:],
                      "left_out": sorted(n for n in g if not moved(n))}}
