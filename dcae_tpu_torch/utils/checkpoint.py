"""Checkpoint save / load with the latest / every-5-epochs / best policy.

A checkpoint is `torch.save` of {epoch, loss, state, extra}, where state is
TrainState.state_dict(): {step, model, main_opt, aux_opt, generator}; both
optimizers and the step count the schedule reads live in it, so a resumed
run continues exactly. It is written to `<path>.tmp` and renamed, so a
reader never sees half a file. Baked entropy tables are stored alongside
(`<path>.tables.npz`), so a checkpoint shipped to another machine decodes
bit-exactly without baking again.

The JAX package's checkpoints are msgpack of Flax pytrees and do not load
here: a JAX checkpoint's parameters enter the port through
`utils/convert.py::state_dict_from_flax`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from dcae_tpu_torch.entropy.tables import CodecTables


def save_checkpoint(path: str, state, epoch: int, loss: float,
                    tables: Optional[CodecTables] = None,
                    extra: Optional[Dict] = None) -> None:
    """state: a TrainState (or anything with state_dict())."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"epoch": int(epoch), "loss": float(loss),
               "state": state.state_dict(), "extra": extra or {}}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if tables is not None:
        tables.save(path + ".tables.npz")


def _read(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(path: str, state) -> Tuple[object, int, float]:
    """Restore into `state` (a TrainState over the same model and
    optimizer recipe), in place. Returns (state, epoch, loss)."""
    payload = _read(path)
    state.load_state_dict(payload["state"])
    return state, int(payload["epoch"]), float(payload["loss"])


def load_tables(path: str) -> Optional[CodecTables]:
    tp = path + ".tables.npz"
    if os.path.exists(tp):
        return CodecTables.load(tp)
    return None


def load_params_only(path: str) -> Dict[str, torch.Tensor]:
    """Just the model's state dict (e.g. for DCAECodec(params=...)), from
    a checkpoint that carries a full train state or a bare state dict."""
    state = _read(path)["state"]
    return state["model"] if "model" in state else state


class CheckpointPolicy:
    """latest / every-5-epochs / best files."""

    def __init__(self, save_dir: str, prefix: str = ""):
        self.save_dir = save_dir
        self.prefix = prefix
        self.best_loss = float("inf")

    def save(self, state, epoch: int, loss: float,
             tables: Optional[CodecTables] = None) -> None:
        base = os.path.join(self.save_dir, self.prefix)
        save_checkpoint(f"{base}checkpoint_latest.ckpt", state, epoch, loss,
                        tables)
        if epoch % 5 == 0:
            save_checkpoint(f"{base}checkpoint_epoch{epoch}.ckpt", state,
                            epoch, loss, tables)
        if loss < self.best_loss:
            self.best_loss = loss
            save_checkpoint(f"{base}checkpoint_best.ckpt", state, epoch,
                            loss, tables)
