"""Seeded weights of the ELIC codec, made on the device in two draws:
harness/weights.py's recipe over the plain ELIC reference's module tree
(reference/elic_model.py), which names every tensor under the published
state dict's names. ELIC holds convolutions, transposed convolutions and
the entropy bottleneck only: torch's fan-in uniform for the first two,
the bottleneck's own init, all from one U[0, 1) draw of the whole model
on the device, from one generator seeded by the run's seed.
"""

from __future__ import annotations

import types
from typing import Dict
from unittest import mock

import torch

from harness import weights
from reference import elic_model
from reference import model as dcae_ref


def make(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of seed `seed`, f32, on `device`."""
    face = types.SimpleNamespace(**vars(dcae_ref))
    face.DCAE = elic_model.ELIC
    with mock.patch.object(weights, "ref", face):
        return weights.make(c, seed, device)
