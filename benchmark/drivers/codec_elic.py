"""Closed-loop codec traffic on ELIC: drivers/codec_tcm.py's run as it is
(codec_closed's loop, with a sink of the program's own spans in traced
runs), with ELIC in TCM's three places: the program's ELICConfig of the
configuration file, its weights drawn from the seed
(harness/elic_weights.py) and the plain ELIC reference in the judge
(reference/elic_check.py). The sampled decoder outputs are kept with the
steps' index and symbol arrays flattened end to end, as the judge reads
them: ELIC's 10 coding steps differ in shape, so the program hands them
over as a tuple.

The program's ELICConfig is imported by codec_closed's first step, so a
program without ELIC stops at once on this cell.

Traffic file keys: codec_closed's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import types
from unittest import mock

import torch

from drivers import codec_closed, codec_tcm
from harness import core, elic_weights
from reference import elic_check


def model_config(config: dict):
    """The program's ELICConfig of a configuration file's "model" dict."""
    from dcae_tpu_torch.config import ELICConfig

    fields = {f.name for f in dataclasses.fields(ELICConfig)}
    return ELICConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in config["model"].items() if k in fields})


def flat_steps(t) -> torch.Tensor:
    """The steps' arrays (a tuple, or stacked) flattened end to end."""
    steps = t if isinstance(t, (tuple, list)) else list(t)
    return torch.cat([s.reshape(-1) for s in steps])


class Capture(codec_closed.Capture):
    """codec_closed's capture, keeping the steps' arrays flat."""

    def __init__(self, model):
        super().__init__(model)
        fn = model.decode_device_streams

        def decode_device_streams(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.armed:
                y_hat, ok, idxs, syms = self.last
                self.last = (y_hat, ok, flat_steps(idxs), flat_steps(syms))
            return out

        model.decode_device_streams = decode_device_streams


def run(ctx: core.Context, device: str = "cuda") -> core.Result:
    with contextlib.ExitStack() as stack:
        for mod, name, stand_in in (
                (codec_tcm, "model_config", model_config),
                (codec_tcm, "tcm_weights",
                 types.SimpleNamespace(make=elic_weights.make)),
                (codec_tcm, "tcm_check",
                 types.SimpleNamespace(judge=elic_check.judge)),
                (codec_closed, "Capture", Capture)):
            stack.enter_context(mock.patch.object(mod, name, stand_in))
        return codec_tcm.run(ctx, device)
