"""Training observability: JSONL metric logs, optionally wandb.

The always-on sink is a JSONL file (machine-readable, no dependencies), in
the JAX package's record format {step, t, ns, metric...}; wandb attaches
only when asked for and installed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, log_dir: str, run_name: str = "train",
                 use_wandb: bool = False, wandb_config: Optional[Dict] = None):
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, f"{run_name}.jsonl")
        self._file = open(self._path, "a")
        self._t0 = time.time()
        self._wandb = None
        if use_wandb:
            try:  # optional wandb
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                self._wandb = wandb.init(project="dcae-tpu-torch",
                                         name=run_name,
                                         config=wandb_config or {})

    def log(self, step: int, metrics: Dict[str, float],
            namespace: str = "train") -> None:
        record = {"step": int(step), "t": round(time.time() - self._t0, 3),
                  "ns": namespace}
        record.update({k: float(v) for k, v in metrics.items()})
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log({f"{namespace}/{k}": float(v)
                             for k, v in metrics.items()}, step=int(step))

    def close(self) -> None:
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()
