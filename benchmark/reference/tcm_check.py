"""The judge of the TCM codec cells: reference/codec_check.py's judge,
every check and its docstring as they are, with the plain TCM reference
(reference/tcm_model.py) in the DCAE reference's place. The two share the
face the judge calls (g_a, h_a, hyper_prior, slice_context, lrp, g_s),
the entropy bottleneck's state dict and the scale table."""

from __future__ import annotations

import types
from typing import Dict, List

import torch

from reference import codec_check
from reference import model as dcae_ref
from reference import tcm_model


def judge(c: dict, state: Dict[str, torch.Tensor], samples: List[dict],
          device) -> Dict[str, float]:
    """codec_check.judge of the TCM configuration `c` (its "model" dict)."""
    face = types.SimpleNamespace(**vars(dcae_ref))
    face.DCAE = tcm_model.TCM
    before = codec_check.ref
    codec_check.ref = face
    try:
        return codec_check.judge(c, state, samples, device)
    finally:
        codec_check.ref = before
