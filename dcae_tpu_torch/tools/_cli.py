"""What the port's CLIs share: the config, the device flag, a codec from a
checkpoint, PNG output."""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np
import torch

from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.models.codec import DCAECodec
from dcae_tpu_torch.utils.checkpoint import load_params_only, load_tables


def config(tiny: bool, **overrides) -> DCAEConfig:
    return DCAEConfig.tiny(**overrides) if tiny else DCAEConfig(**overrides)


def synth_dir() -> str:
    """Where validate_training writes its synthetic corpus and
    rd_sweep_eval reads it, by default: under the temporary directory
    (TMPDIR)."""
    return os.path.join(tempfile.gettempdir(), "dcae_synth")


def add_device_flag(p, name: str = "--device", help_: str = "") -> None:
    p.add_argument(name, type=str, default="cuda",
                   help=(help_ + " " if help_ else "") + "cuda (default; "
                   "raises without a card) or cpu")


def require_card(tool: str) -> None:
    """A benchmark of the card refuses to run without one: a CPU run
    measures nothing of it."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device (a CPU run measures "
                         "nothing of the card)")


def load_codec(cfg: DCAEConfig, checkpoint: Optional[str], device,
               params=None) -> DCAECodec:
    """A codec on `device` with the checkpoint's parameters and baked
    tables (a seeded random init when checkpoint is empty); tables are
    baked when the checkpoint carries none. Raises when checkpoint names
    no file."""
    tables = None
    if checkpoint:
        if not os.path.isfile(checkpoint):
            raise FileNotFoundError(f"no checkpoint at {checkpoint}")
        params = load_params_only(checkpoint)
        tables = load_tables(checkpoint)
    codec = DCAECodec(cfg, params=params, tables=tables, device=device)
    codec.update()
    return codec


def save_png(x_hat, out_path: str) -> None:
    """(H, W, 3) image in [0, 1] (tensor or numpy) -> 8-bit PNG."""
    from PIL import Image

    if torch.is_tensor(x_hat):
        x_hat = x_hat.detach().float().cpu().numpy()
    img = np.clip(np.asarray(x_hat) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    Image.fromarray(img).save(out_path)
