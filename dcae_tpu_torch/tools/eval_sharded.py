#!/usr/bin/env python3
"""Sharded forward eval of an image directory, the JAX package's
tools/eval_sharded.py: the batches are split over the dp axis of a (dp, sp)
mesh (one process a device, parallel/mesh.py) and each image's g_a / g_s
over image rows by the sp ranks; the metrics are reduced to the global
batch's, and the aggregate likelihood bpp / PSNR / loss and the throughput
are reported. A batch that does not split into equal shards (B % dp != 0)
is evaluated whole on the primary rank and counted once. The real
entropy-coded path stays per codec.

    python -m dcae_tpu_torch.tools.eval_sharded --data DIR [--checkpoint
        CKPT] [--batch-size 8] [--patch 512] [--tiny]
    torchrun --nproc-per-node 4 -m dcae_tpu_torch.tools.eval_sharded \
        --sp 2 ...

Runs on the CUDA device(s); --device cpu on the CPU (gloo under torchrun).
"""

import argparse
import os
import time


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="sharded forward eval")
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--patch", type=int, default=None,
                   help="center-crop eval patch (default: pad originals)")
    p.add_argument("--sp", type=int, default=1,
                   help="spatial mesh axis (dp = n_devices // sp)")
    p.add_argument("--lmbda", type=float, default=0.013)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; raises without a card) or cpu")
    a = p.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from dcae_tpu_torch.data.datasets import list_images, load_image
    from dcae_tpu_torch.models.codec import resolve_device
    from dcae_tpu_torch.models.dcae import DCAE
    from dcae_tpu_torch.ops.layers import pad_spatial
    from dcae_tpu_torch.parallel import mesh as pmesh, multihost
    from dcae_tpu_torch.tools._cli import config
    from dcae_tpu_torch.train.step import make_eval_step
    from dcae_tpu_torch.utils.checkpoint import load_params_only
    from dcae_tpu_torch.utils.metrics import AverageMeter

    cfg = config(a.tiny)
    device = resolve_device(a.device)
    if not (dist.is_available() and dist.is_initialized()) and \
            int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = multihost.initialize(device=device)
    mesh = pmesh.make_mesh(sp=a.sp, device=device)
    dp = mesh.dp
    primary = multihost.is_primary()
    if primary:
        print(f"mesh: dp={dp} sp={mesh.sp} over {mesh.world}/{mesh.world} "
              "devices")

    files = list_images(a.data)
    if a.limit:
        files = files[:a.limit]

    # one padded geometry for the whole run: crop to --patch, or pad
    # everything to the largest padded size
    def prep(path):
        x = load_image(path)
        if a.patch:
            h, w = x.shape[:2]
            t = max(0, (h - a.patch) // 2)
            l = max(0, (w - a.patch) // 2)
            x = x[t:t + a.patch, l:l + a.patch]
        padded, _ = pad_spatial(torch.from_numpy(x)[None], cfg.pad_multiple)
        return padded[0].numpy()

    imgs = [prep(f) for f in files]
    hmax = max(i.shape[0] for i in imgs)
    wmax = max(i.shape[1] for i in imgs)
    imgs = [np.pad(i, ((0, hmax - i.shape[0]), (0, wmax - i.shape[1]),
                       (0, 0))) for i in imgs]

    model = DCAE(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    if a.checkpoint:
        model.load_state_dict(load_params_only(a.checkpoint), strict=True)
    model.to(mesh.device).eval()
    # f32 products, as the codec that runs the model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eval_full = make_eval_step(model, a.lmbda)
    eval_step = pmesh.shard_eval_step(eval_full, mesh)

    meters = {k: AverageMeter() for k in ("loss", "bpp_loss", "psnr")}
    t0 = time.time()
    n_done = 0
    for i in range(0, len(imgs), a.batch_size):
        batch = np.stack(imgs[i:i + a.batch_size])
        if batch.shape[0] % dp == 0:
            m = eval_step(torch.from_numpy(
                pmesh.shard_rows(batch, mesh)).to(mesh.device))
        elif primary:
            m = eval_full(torch.from_numpy(batch).to(mesh.device))
        else:
            continue
        for k in meters:
            meters[k].update(float(m[k]), batch.shape[0])
        n_done += batch.shape[0]
    dt = time.time() - t0
    out = {"images": n_done, "seconds": dt,
           **{k: meters[k].avg for k in meters}}
    if primary:
        print(f"{n_done} images in {dt:.1f}s = {n_done / dt:.2f} img/s | "
              f"bpp {out['bpp_loss']:.4f} | psnr {out['psnr']:.2f} dB | "
              f"loss {out['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
