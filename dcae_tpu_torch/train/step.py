"""The RD training step."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from dcae_tpu_torch.entropy.ops import draw_noise
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.train.losses import rate_distortion_loss
from dcae_tpu_torch.train.state import (OptimizerSpec, TrainState,
                                        apply_updates)
from dcae_tpu_torch.utils.profiling import span


def make_loss_fn(model: DCAE, lmbda: float, metric: str = "mse",
                 precision_reg: float = 0.0, precision_noise: float = 1e-6
                 ) -> Callable:
    """loss_fn(batch, generator) -> (loss, metrics): the training forward,
    rd + aux and, with precision_reg > 0, the cross-device precision
    penalty: two more decoder passes on the quantized latent, one
    perturbed by N(0, precision_noise^2) "transfer noise"; the MSE between
    their outputs, scaled by precision_reg, penalizes the decoder's
    sensitivity to tiny latent drift."""

    def loss_fn(batch: torch.Tensor, generator: torch.Generator):
        out = model(batch, training=True, generator=generator)
        rd = rate_distortion_loss(out, batch, lmbda, metric)
        aux = model.aux_loss()
        loss = rd["loss"] + aux
        if precision_reg > 0:
            y_hat = out["para"]["y_hat"]
            z_hat = out["para"]["z_hat"]
            noise = draw_noise(y_hat.shape, generator, y_hat.dtype,
                               y_hat.device, normal=True) * precision_noise
            x_a = model.decode_from_quantized(y_hat, z_hat)
            x_b = model.decode_from_quantized(y_hat + noise, z_hat)
            rd["precision_loss"] = torch.mean((x_a - x_b) ** 2)
            loss = loss + precision_reg * rd["precision_loss"]
        metrics = dict(rd)
        metrics["aux_loss"] = aux
        return loss, metrics

    return loss_fn


def make_train_step(model: DCAE, tx: OptimizerSpec, lmbda: float,
                    metric: str = "mse", precision_reg: float = 0.0,
                    precision_noise: float = 1e-6
                    ) -> Callable[[TrainState, torch.Tensor],
                                  Tuple[TrainState, Dict]]:
    """train_step(state, batch) -> (state, metrics): one backward of
    rd + aux (+ the precision penalty) and one update of both parameter
    groups. The state (the model's parameters, the optimizers, the
    generator, the step count) is updated in place and returned; the
    metrics are detached tensors on the model's device, so a step never
    makes the host wait for the device."""
    loss_fn = make_loss_fn(model, lmbda, metric, precision_reg,
                           precision_noise)

    def train_step(state: TrainState, batch: torch.Tensor):
        for p in model.parameters():
            p.grad = None
        with span("train.forward"):
            loss, metrics = loss_fn(batch, state.generator)
        with span("train.backward"):
            loss.backward()
        apply_updates(state, tx)
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_eval_step(model: DCAE, lmbda: float, metric: str = "mse"
                   ) -> Callable[[torch.Tensor], Dict]:
    """eval_step(batch) -> the eval-mode RD losses and the PSNR."""

    @torch.no_grad()
    def eval_step(batch: torch.Tensor) -> Dict:
        out = model(batch)
        rd = rate_distortion_loss(out, batch, lmbda, metric)
        mse = torch.mean((out["x_hat"] - batch) ** 2)
        rd["psnr"] = -10.0 * torch.log10(mse)
        return rd

    return eval_step
