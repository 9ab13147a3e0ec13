"""Train state and the dual-optimizer (main + aux / quantiles) setup.

The recipe: Adam over all non-quantile parameters behind global-norm
clipping at 1.0, a second Adam over the entropy bottleneck's `quantiles`,
and MultiStepLR (x0.1 at the milestones). Both parameter groups update
from ONE backward of (rd_loss + aux_loss): the groups' gradients are
disjoint (the quantiles get no RD gradient, since the straight-through
median term cancels, and aux_loss stops gradients to everything else), so
one backward equals the recipe's two.

Parity with the JAX package's optax chain (dcae_tpu/train/state.py):
torch.optim.Adam, like optax's, adds eps outside the square root of the
bias-corrected second moment; the clipping norm is taken over the main
group's gradients alone (frozen and aux parameters are left out); the
schedule is read at the step count before the update; a frozen parameter
gets no update (it is in no optimizer), though it still gets a gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from dcae_tpu_torch.utils.profiling import span

Schedule = Callable[[int], float]


def param_labels(model: nn.Module,
                 trainable_keys: Optional[Sequence[str]] = None
                 ) -> Dict[str, str]:
    """{parameter name: 'aux' | 'main' | 'frozen'}: 'aux' for the
    quantiles, 'main' for everything else; with `trainable_keys`, every
    parameter whose top-level name is not among them is 'frozen'."""
    keep = None if trainable_keys is None else set(trainable_keys)
    labels = {}
    for name, _ in model.named_parameters():
        if keep is not None and name.split(".")[0] not in keep:
            labels[name] = "frozen"
        else:
            labels[name] = "aux" if "quantiles" in name else "main"
    return labels


def multistep_lr(base_lr: float, milestones_steps: Sequence[int],
                 gamma: float = 0.1) -> Schedule:
    """MultiStepLR: multiplied by gamma from each milestone (in steps)
    on."""
    milestones = sorted(int(m) for m in milestones_steps)

    def schedule(step: int) -> float:
        return base_lr * gamma ** sum(int(step) >= m for m in milestones)

    return schedule


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What make_optimizer returns: the recipe, before it meets a model."""
    schedule: Schedule
    aux_learning_rate: float
    clip_max_norm: float
    trainable_keys: Optional[Tuple[str, ...]]


def make_optimizer(learning_rate: Union[float, Schedule],
                   aux_learning_rate: float = 1e-3,
                   clip_max_norm: float = 1.0,
                   trainable_keys: Optional[Sequence[str]] = None
                   ) -> OptimizerSpec:
    """Dual optimizer; optionally freeze all top-level sub-modules NOT in
    trainable_keys (encoder-only fine-tuning freezes everything but
    g_a / h_a). learning_rate: a float or a schedule of the step count.
    The aux Adam's learning rate can be retuned between epochs with
    set_aux_lr."""
    schedule = learning_rate if callable(learning_rate) \
        else (lambda step, lr=float(learning_rate): lr)
    return OptimizerSpec(schedule, float(aux_learning_rate),
                         float(clip_max_norm),
                         None if trainable_keys is None
                         else tuple(trainable_keys))


@dataclasses.dataclass
class TrainState:
    """step: updates taken so far. main_opt / aux_opt: the two Adams
    (aux_opt is None when the quantiles are frozen). generator: the source
    of all training noise, on the model's device. A train step updates
    the state in place."""
    step: int
    model: nn.Module
    main_opt: torch.optim.Adam
    aux_opt: Optional[torch.optim.Adam]
    generator: torch.Generator

    def main_params(self) -> List[nn.Parameter]:
        return [p for g in self.main_opt.param_groups for p in g["params"]]

    def state_dict(self) -> dict:
        return {"step": int(self.step),
                "model": self.model.state_dict(),
                "main_opt": self.main_opt.state_dict(),
                "aux_opt": None if self.aux_opt is None
                else self.aux_opt.state_dict(),
                "generator": self.generator.get_state()}

    def load_state_dict(self, sd: dict) -> None:
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["model"], strict=True)
        _load_optimizer(self.main_opt, sd["main_opt"])
        if self.aux_opt is not None and sd["aux_opt"] is not None:
            _load_optimizer(self.aux_opt, sd["aux_opt"])
        # a generator state from the other kind of device has another
        # layout: the noise then goes on from this state's own seed
        noise = sd["generator"].cpu()
        if noise.numel() == self.generator.get_state().numel():
            self.generator.set_state(noise)


def _load_optimizer(opt: torch.optim.Adam, sd: dict) -> None:
    """Moments, step counts and learning rates from `sd`; which Adam
    implementation runs (fused on the card) stays this state's own, so a
    checkpoint written on one device resumes on the other."""
    own = [(g["fused"], g["foreach"]) for g in opt.param_groups]
    opt.load_state_dict(sd)
    for group, (fused, foreach) in zip(opt.param_groups, own):
        group["fused"], group["foreach"] = fused, foreach


def create_train_state(model: nn.Module, tx: OptimizerSpec,
                       generator: torch.Generator, step: int = 0
                       ) -> TrainState:
    """Fresh optimizers of `tx` over `model`'s parameters."""
    labels = param_labels(model, tx.trainable_keys)
    by_label = {"main": [], "aux": [], "frozen": []}
    for name, p in model.named_parameters():
        by_label[labels[name]].append(p)
    # on the card one fused kernel a group updates every tensor; the
    # formula is the same
    fused = all(p.is_cuda for p in model.parameters())
    main_opt = torch.optim.Adam(by_label["main"], lr=tx.schedule(step),
                                fused=fused)
    aux_opt = torch.optim.Adam(by_label["aux"], lr=tx.aux_learning_rate,
                               fused=fused) if by_label["aux"] else None
    return TrainState(step=int(step), model=model, main_opt=main_opt,
                      aux_opt=aux_opt, generator=generator)


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """Scale `grads` in place by max_norm / norm where their global L2
    norm exceeds max_norm (optax.clip_by_global_norm); returns the norm.
    Never makes the host wait for the device."""
    norms = torch._foreach_norm(list(grads))
    norm = torch.linalg.vector_norm(torch.stack(norms))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(list(grads), scale)
    return norm


def apply_updates(state: TrainState, tx: OptimizerSpec) -> None:
    """One update of both groups from the gradients now on the parameters:
    the main group's gradients clipped by their own global norm, the main
    Adam at the schedule's value for the step count before the update,
    then the aux Adam; step += 1."""
    with span("train.update"):
        main = [p for p in state.main_params() if p.grad is not None]
        if tx.clip_max_norm > 0 and main:
            clip_by_global_norm_([p.grad for p in main], tx.clip_max_norm)
        for group in state.main_opt.param_groups:
            group["lr"] = tx.schedule(state.step)
        state.main_opt.step()
        if state.aux_opt is not None:
            state.aux_opt.step()
        state.step += 1


# ---------------------------------------------------------------------------
# adaptive aux-LR scheduling
# ---------------------------------------------------------------------------


def set_aux_lr(state: TrainState, lr: float) -> None:
    """Set the aux Adam's learning rate."""
    if state.aux_opt is not None:
        for group in state.aux_opt.param_groups:
            group["lr"] = float(lr)


def get_aux_lr(state: TrainState) -> float:
    if state.aux_opt is None:
        return float("nan")
    return float(state.aux_opt.param_groups[0]["lr"])


class ExponentialTargetScheduler:
    """Adaptive aux-LR schedule: drive the quantile (aux) loss along an
    exponential trajectory from start_loss to target_loss over
    total_epochs, boosting the LR when behind schedule: multiplier bands
    x(50..1000) on the main LR, safety cap 0.1. Host-side; apply the result
    with set_aux_lr."""

    def __init__(self, start_loss: float, target_loss: float = 10.0,
                 total_epochs: int = 100):
        self.start_loss = float(start_loss)
        self.target_loss = float(target_loss)
        self.total_epochs = int(total_epochs)
        self.decay_rate = ((self.target_loss / self.start_loss)
                           ** (1.0 / self.total_epochs))

    def step(self, current_aux_loss: float, main_lr: float,
             epoch: int) -> Tuple[float, float]:
        expected = self.start_loss * (self.decay_rate ** epoch)
        if current_aux_loss > expected * 1.5:
            boost = (current_aux_loss / expected) * 2
            multiplier = min(1000.0, 200.0 * boost)
        elif current_aux_loss > expected:
            boost = current_aux_loss / expected
            multiplier = min(500.0, 100.0 * boost)
        else:
            multiplier = max(50.0, 200.0 * (current_aux_loss
                                            / self.target_loss))
        new_lr = min(main_lr * multiplier, 0.1)
        return new_lr, multiplier
