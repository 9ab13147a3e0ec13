#!/usr/bin/env python3
"""Export a training checkpoint for coding on another machine: its
parameters, with the integer entropy tables baked here and stored beside
them (<output>.tables.npz), so the receiving machine codes bit-exactly
without baking again. utils.checkpoint.load_params_only / load_tables read
the result, as the codec CLIs' --checkpoint does.

    python -m dcae_tpu_torch.tools.export_checkpoint --checkpoint ck \
        --output exported.ckpt
"""

import argparse

import torch

from dcae_tpu_torch.tools._cli import add_device_flag, config
from dcae_tpu_torch.models.codec import DCAECodec
from dcae_tpu_torch.train.state import create_train_state, make_optimizer
from dcae_tpu_torch.utils.checkpoint import load_params_only, save_checkpoint


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--tiny", action="store_true")
    add_device_flag(p)
    a = p.parse_args(argv)

    codec = DCAECodec(config(a.tiny), params=load_params_only(a.checkpoint),
                      device=a.device)
    codec.update(force=True)
    state = create_train_state(codec.model, make_optimizer(1e-4),
                               torch.Generator())
    save_checkpoint(a.output, state, epoch=0, loss=0.0, tables=codec.tables)
    codec.close()
    print(f"exported {a.output} (+ .tables.npz with the baked CDFs)")


if __name__ == "__main__":
    main()
