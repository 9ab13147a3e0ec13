"""The benchmark's one door into the program under test: its configuration
object, built from a configuration file's widths."""

from __future__ import annotations

import dataclasses


def model_config(config: dict):
    """The program's DCAEConfig of a configuration file's "model" dict."""
    from dcae_tpu_torch.config import DCAEConfig

    fields = {f.name for f in dataclasses.fields(DCAEConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in config["model"].items() if k in fields}
    return DCAEConfig(**kw)
