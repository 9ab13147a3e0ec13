#!/usr/bin/env python3
"""Training CLI of the PyTorch port.

Example (the reference recipe):
    python -m dcae_tpu_torch.tools.train -d $DATASET --epochs 50 -lr 1e-4 \
        --lmbda 0.0483 --batch-size 8 --save --save_path ./checkpoints \
        --lr_epoch 46

Runs on the CUDA device; `--device cpu --tiny` is the smoke run on a CPU.
Data-parallel over several cards (--batch-size is the global batch), and
with --sp each image split over image rows by sp cards (dp = cards / sp):
    torchrun --nproc-per-node 4 -m dcae_tpu_torch.tools.train -d $DATASET ...
    torchrun --nproc-per-node 4 -m dcae_tpu_torch.tools.train --sp 2 ...
"""

import argparse
import os

from dcae_tpu_torch.train.loop import TrainOptions, run_training


def parse_args(argv):
    p = argparse.ArgumentParser(description="DCAE training (PyTorch port)")
    p.add_argument("-d", "--dataset", type=str, required=True,
                   help="root with train/ and test/ image folders")
    p.add_argument("-e", "--epochs", type=int, default=50)
    p.add_argument("-lr", "--learning_rate", type=float, default=1e-4)
    p.add_argument("--aux_learning_rate", type=float, default=1e-3)
    p.add_argument("--lmbda", type=float, default=60.5,
                   help="RD tradeoff (MSE: 0.0018..0.05; MS-SSIM: 2.4..60.5)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--test-batch-size", type=int, default=8)
    p.add_argument("--patch-size", type=int, default=256)
    p.add_argument("--type", type=str, default="mse",
                   choices=["mse", "ms-ssim", "l1"])
    p.add_argument("--lr_epoch", type=int, nargs="+", default=[46])
    p.add_argument("--clip_max_norm", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--save", action="store_true")
    p.add_argument("--save_path", type=str, default="./checkpoints")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="resume checkpoint path")
    p.add_argument("--continue_train", action="store_true", default=True)
    p.add_argument("--no-continue_train", dest="continue_train",
                   action="store_false",
                   help="keep params but rebuild optimizer state on resume")
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--sp", type=int, default=1,
                   help="spatial mesh axis size (dp = n_devices / sp)")
    p.add_argument("--drift_noise", type=float, default=0.0,
                   help="train drift-robust")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--finetune_encoder", action="store_true",
                   help="freeze everything but g_a/h_a (encoder-only "
                        "fine-tuning)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny config (smoke tests)")
    p.add_argument("--aux_scheduler", action="store_true", default=None,
                   help="adaptive aux-LR targeting; default auto: on for "
                        "full-size configs, off for --tiny")
    p.add_argument("--no-aux_scheduler", dest="aux_scheduler",
                   action="store_false", help="force plain aux Adam")
    p.add_argument("--aux_target_loss", type=float, default=10.0)
    p.add_argument("--precision_reg", type=float, default=0.0,
                   help="cross-device precision regularization weight")
    p.add_argument("--val_real_every", type=int, default=10,
                   help="true entropy-coded validation cadence in epochs "
                        "(0 disables)")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    opts = TrainOptions(
        dataset=a.dataset, epochs=a.epochs, learning_rate=a.learning_rate,
        aux_learning_rate=a.aux_learning_rate, lmbda=a.lmbda,
        batch_size=a.batch_size, test_batch_size=a.test_batch_size,
        patch_size=a.patch_size, loss_type=a.type,
        lr_epochs=tuple(a.lr_epoch), clip_max_norm=a.clip_max_norm,
        seed=a.seed, save=a.save, save_path=a.save_path,
        checkpoint=a.checkpoint, continue_train=a.continue_train,
        num_workers=a.num_workers, sp=a.sp, drift_noise=a.drift_noise,
        use_wandb=a.wandb,
        freeze_except=("g_a", "h_a") if a.finetune_encoder else None,
        aux_scheduler=a.aux_scheduler, aux_target_loss=a.aux_target_loss,
        precision_reg=a.precision_reg, val_real_every=a.val_real_every)
    cfg = None
    if a.tiny:
        from dcae_tpu_torch.config import DCAEConfig
        cfg = DCAEConfig.tiny(drift_noise=a.drift_noise)
    device = a.device
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:      # under torchrun
        from dcae_tpu_torch.parallel import multihost
        device = multihost.initialize(device=device)
    run_training(opts, cfg=cfg, device=device)


if __name__ == "__main__":
    main()
