"""Split training: the encoder half and the decoder half on two devices.

One DCAE is partitioned by top-level module into two disjoint halves,

    encoder half  {g_a, h_a, entropy_bottleneck}       on enc_device
    decoder half  everything else (g_s, hyper synthesis, dictionary and
                  its cross-attention, slice context nets)  on dec_device

and one step runs as a two-stage pipeline: the encoder half's training
forward (encode_half) on enc_device; y and z_hat shipped to dec_device,
detached, as leaves that take a gradient; the decoder half's forward
(decode_half), its RD loss and its backward there; the gradients of y and
z_hat shipped back; the encoder half's backward of
    <y, g_y> + <z_hat, g_z> + bpp_z + aux_loss.
The encoder's autograd graph is kept from its forward to that backward
(the JAX package recomputes the forward inside a VJP instead): the noise is
drawn once and the forward costs once, for the memory of one half's
activations. Each half has its own optimizers (main and aux Adam, as
train/state.py builds them for that half's parameters) and its own clip
by global norm, so the step equals the joint step (train/step.py) only
when no clip bites.

Training noise: on one device both halves draw from ONE generator, in the
joint forward's order (encode_half's, then decode_half's), so the forward
is the joint step's to the bit. On two devices each half draws from a
generator on its own device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from dcae_tpu_torch.models.codec import resolve_device
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.train.losses import rate_distortion_loss
from dcae_tpu_torch.train.state import (OptimizerSpec, TrainState,
                                        apply_updates, create_train_state)

ENC_KEYS = ("g_a", "h_a", "entropy_bottleneck")


def _top(key: str) -> str:
    return key.split(".", 1)[0]


def split_halves(params: Dict) -> Tuple[Dict, Dict]:
    """(encoder half, decoder half) of a state dict, by top-level name."""
    enc = {k: v for k, v in params.items() if _top(k) in ENC_KEYS}
    dec = {k: v for k, v in params.items() if _top(k) not in ENC_KEYS}
    return enc, dec


def merge_halves(enc: Dict, dec: Dict) -> Dict:
    out = dict(dec)
    out.update(enc)
    return out


class _Half(nn.Module):
    """A view of some of a model's top-level modules and parameters under
    their own names (the same objects, not copies): what a half's
    optimizers are built over."""

    def __init__(self, model: nn.Module, encoder: bool):
        super().__init__()
        for name, child in model.named_children():
            if (name in ENC_KEYS) == encoder:
                self.add_module(name, child)
        for name, p in model.named_parameters(recurse=False):
            if (name in ENC_KEYS) == encoder:
                self.register_parameter(name, p)


def _device(d) -> torch.device:
    """resolve_device, with a CUDA device's index made explicit (so that
    "cuda" and "cuda:0" are one device)."""
    d = resolve_device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@torch.no_grad()
def place_halves(model: DCAE, enc_device, dec_device) -> None:
    """Move the encoder half's modules to enc_device and everything else
    to dec_device, in place."""
    for name, child in model.named_children():
        child.to(enc_device if name in ENC_KEYS else dec_device)
    for name, p in list(model.named_parameters(recurse=False)):
        dev = enc_device if name in ENC_KEYS else dec_device
        if p.device != dev:
            setattr(model, name, nn.Parameter(p.detach().to(dev),
                                              p.requires_grad))


@dataclasses.dataclass
class SplitTrainState:
    """enc / dec: each half's TrainState (its view of the model, its
    optimizers, its generator, its step count); both step together."""
    model: DCAE
    enc: TrainState
    dec: TrainState

    @property
    def step(self) -> int:
        return self.enc.step

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The merged state dict (each tensor on its half's device)."""
        return merge_halves(self.enc.model.state_dict(),
                            self.dec.model.state_dict())


def create_split_train_state(model: DCAE, tx: OptimizerSpec, enc_device=None,
                             dec_device=None, seed: int = 0, step: int = 0,
                             generator: torch.Generator = None
                             ) -> SplitTrainState:
    """Place the halves on their devices and build each half's optimizers
    and generator. On one device both halves share `generator` (or a new
    one seeded with `seed`); on two, the encoder's generator is seeded
    with `seed` and the decoder's with seed + 1."""
    enc_device, dec_device = _device(enc_device), _device(dec_device)
    place_halves(model, enc_device, dec_device)
    if enc_device == dec_device:
        if generator is None or generator.device != enc_device:
            generator = torch.Generator(device=enc_device).manual_seed(seed)
        enc_gen = dec_gen = generator
    else:
        enc_gen = torch.Generator(device=enc_device).manual_seed(seed)
        dec_gen = torch.Generator(device=dec_device).manual_seed(seed + 1)
    return SplitTrainState(
        model=model,
        enc=create_train_state(_Half(model, True), tx, enc_gen, step),
        dec=create_train_state(_Half(model, False), tx, dec_gen, step))


def make_split_train_step(model: DCAE, tx: OptimizerSpec, lmbda: float,
                          metric: str = "mse", enc_device=None,
                          dec_device=None) -> Callable:
    """train_step(state, batch) -> (SplitTrainState, metrics), with the
    encoder half on enc_device and the decoder half on dec_device (both
    default to cuda:0; enc_device="cpu" is the CPU-encoder / GPU-decoder
    hybrid). A joint TrainState is converted on the first call: the halves
    are placed, each gets fresh optimizers, and on one device the
    state's generator serves both. Metrics: the decoder side's RD terms
    with bpp_z added to bpp_loss and loss, and aux_loss; detached tensors,
    so a step never makes the host wait for the device."""
    enc_device, dec_device = _device(enc_device), _device(dec_device)

    def to_split_state(state) -> SplitTrainState:
        if isinstance(state, SplitTrainState):
            return state
        return create_split_train_state(
            state.model, tx, enc_device, dec_device,
            seed=state.generator.initial_seed(), step=state.step,
            generator=state.generator)

    def train_step(state, batch):
        state = to_split_state(state)
        batch = torch.as_tensor(batch)
        for p in model.parameters():
            p.grad = None
        # encoder device: forward
        x_enc = batch.to(enc_device)
        y, z_hat, z_like = model.encode_half(x_enc, True,
                                             state.enc.generator)
        B, H, W, _ = x_enc.shape
        bpp_z = torch.sum(torch.log(z_like)) / (-math.log(2) * B * H * W)
        aux = model.aux_loss()

        # decoder device: forward, RD loss, backward
        y_d = y.detach().to(dec_device).requires_grad_()
        z_d = z_hat.detach().to(dec_device).requires_grad_()
        x_hat, y_like, *_ = model.decode_half(y_d, z_d, True,
                                              state.dec.generator)
        rd = rate_distortion_loss({"x_hat": x_hat,
                                   "likelihoods": {"y": y_like}},
                                  batch.to(dec_device), lmbda, metric)
        rd["loss"].backward()

        # encoder device: backward from the shipped gradients
        rest = bpp_z + aux
        torch.autograd.backward(
            [y, z_hat, rest],
            [y_d.grad.to(enc_device), z_d.grad.to(enc_device),
             torch.ones_like(rest)])

        apply_updates(state.enc, tx)
        apply_updates(state.dec, tx)
        metrics = {k: v.detach() for k, v in rd.items()}
        bpp_z_d = bpp_z.detach().to(dec_device)
        metrics["bpp_loss"] = metrics["bpp_loss"] + bpp_z_d
        metrics["loss"] = metrics["loss"] + bpp_z_d
        metrics["aux_loss"] = aux.detach()
        return state, metrics

    return train_step
