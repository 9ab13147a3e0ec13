#!/usr/bin/env python3
"""Transforms-only pretraining CLI of the PyTorch port: trains
SimpleAutoencoder (g_a + g_s, no entropy model) with an mse / l1 /
ms-ssim / mixed reconstruction loss, optionally starting from a full DCAE
checkpoint's transforms.

    python -m dcae_tpu_torch.tools.train_autoencoder -d <root with train/
        and test/> --epochs 10 [--from_dcae ck] [--M 160]

Runs on the CUDA device; --device cpu (with --tiny) on the CPU.
"""

import argparse
import time

import torch

from dcae_tpu_torch.data.datasets import ImageFolder
from dcae_tpu_torch.models.autoencoder import (SimpleAutoencoder,
                                               params_from_dcae)
from dcae_tpu_torch.models.codec import resolve_device
from dcae_tpu_torch.tools._cli import add_device_flag, config
from dcae_tpu_torch.train.losses import reconstruction_loss
from dcae_tpu_torch.train.state import TrainState
from dcae_tpu_torch.utils.checkpoint import CheckpointPolicy, load_params_only
from dcae_tpu_torch.utils.metrics import AverageMeter


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-d", "--dataset", type=str, required=True)
    p.add_argument("-e", "--epochs", type=int, default=100)
    p.add_argument("-lr", "--learning_rate", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--patch-size", type=int, default=256)
    p.add_argument("--loss", type=str, default="mse",
                   choices=["mse", "l1", "ms-ssim", "mixed"])
    p.add_argument("--M", type=int, default=320,
                   help="latent channels (the split eval uses 160)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--save_path", type=str, default="./checkpoints/ae")
    p.add_argument("--from_dcae", type=str, default=None,
                   help="start g_a / g_s from a DCAE checkpoint")
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--num-workers", type=int, default=8)
    add_device_flag(p)
    a = p.parse_args(argv)

    device = resolve_device(a.device)
    cfg = config(a.tiny, M=a.M)
    model = SimpleAutoencoder(cfg)
    if a.from_dcae:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in
                               params_from_dcae(
                                   load_params_only(a.from_dcae),
                                   strict=True).items()}, strict=True)
        print(f"g_a / g_s from {a.from_dcae}")
    else:
        model.reset_parameters(torch.Generator().manual_seed(a.seed))
    model.to(device)
    opt = (torch.optim.AdamW(model.parameters(), a.learning_rate,
                             weight_decay=a.weight_decay)
           if a.weight_decay > 0 else
           torch.optim.Adam(model.parameters(), a.learning_rate))
    state = TrainState(step=0, model=model, main_opt=opt, aux_opt=None,
                       generator=torch.Generator(device=device))

    train_ds = ImageFolder(a.dataset, "train", a.patch_size, seed=a.seed,
                           num_workers=a.num_workers)
    test_ds = ImageFolder(a.dataset, "test", a.patch_size, seed=a.seed,
                          num_workers=a.num_workers)
    policy = CheckpointPolicy(a.save_path)
    for epoch in range(a.epochs):
        t0 = time.time()
        meter = AverageMeter()
        model.train()
        for i, batch in enumerate(train_ds.batches(a.batch_size, epoch)):
            x = torch.from_numpy(batch).to(device)
            opt.zero_grad(set_to_none=True)
            loss = reconstruction_loss(model(x)["x_hat"], x, a.loss)
            loss.backward()
            opt.step()
            state.step += 1
            meter.update(loss.item())
            if i % 100 == 0:
                print(f"epoch {epoch} [{i}] loss {loss.item():.5f}")
        test_m = AverageMeter()
        model.eval()
        with torch.no_grad():
            for batch in test_ds.batches(a.batch_size, drop_last=False):
                x = torch.from_numpy(batch).to(device)
                test_m.update(float(reconstruction_loss(
                    model(x)["x_hat"], x, a.loss)), x.shape[0])
        print(f"epoch {epoch}: train {meter.avg:.5f} test {test_m.avg:.5f} "
              f"({time.time() - t0:.0f}s, {state.step} steps)")
        policy.save(state, epoch + 1, test_m.avg)


if __name__ == "__main__":
    main()
