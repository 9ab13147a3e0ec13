"""The kernels' gradients: a recompute through the plain version.

The hand kernels have no backward kernel, as the TPU kernels they replace
have none (there each forward sits in a `jax.custom_vjp` whose backward is
`jax.vjp` of an f32 restatement). Each wrapper's `torch.autograd.Function`
launches the kernel forward, saves only the operands, and calls
`recompute_backward` for its gradients: nothing of the forward's
intermediates (attention matrices, [g | v]) is kept between the passes.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def recompute_backward(plain: Callable, operands: Sequence,
                       needs_grad: Sequence[bool], grad_out: torch.Tensor,
                       **static) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of `plain(*operands, **static)` under the cotangent
    `grad_out`: the plain version is run again in f32 on detached f32
    copies (so a bf16 call is differentiated without its rounding points)
    and differentiated by autograd. One entry per operand, in the
    operand's own dtype; None where `needs_grad` is false or the operand
    is None."""
    with torch.enable_grad():
        prim = [None if t is None else
                t.detach().to(torch.float32).requires_grad_(bool(n))
                for t, n in zip(operands, needs_grad)]
        wanted = [p for p, n in zip(prim, needs_grad) if p is not None and n]
        out = plain(*prim, **static)
        grads = iter(torch.autograd.grad(out, wanted,
                                         grad_out.to(torch.float32)))
    return tuple(next(grads).to(t.dtype) if t is not None and n else None
                 for t, n in zip(operands, needs_grad))


def wants_grad(operands: Sequence) -> bool:
    """Whether a call must record a graph: grad mode is on and an operand
    requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in operands)
