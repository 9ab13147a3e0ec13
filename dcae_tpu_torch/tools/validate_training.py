#!/usr/bin/env python3
"""Training-convergence validation of the PyTorch port: the JAX package's
tools/validate_training.py on the port's trainer.

Writes a synthetic, compressible image set (data/synthetic.py) unless
--data already holds one, trains the codec for a few epochs, and checks
the properties the reference recipe relies on:

  1. the RD loss and bpp fall;
  2. the aux (quantile) loss converges toward 0 (recorded, not a bar);
  3. real entropy-coded bpp after training beats the untrained codec's.

Writes <save_path>/train.jsonl (per-step metrics) and
<save_path>/summary.json, prints VALIDATION PASS or FAIL and exits 0 or 1.

    python -m dcae_tpu_torch.tools.validate_training [--full] \
        [--epochs 8] [--data DIR] [--save_path DIR] [--device cpu]

Runs on the CUDA device; --device cpu on the CPU (tiny config).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from dcae_tpu_torch.data.synthetic import make_dataset


def parse_args(argv=None):
    from dcae_tpu_torch.tools._cli import add_device_flag, synth_dir

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=synth_dir(),
                    help="the corpus (default: dcae_synth under TMPDIR)")
    ap.add_argument("--save_path", default=os.path.join(
        tempfile.gettempdir(), "dcae_train_validation"),
        help="default: dcae_train_validation under TMPDIR")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--patch-size", type=int, default=128)
    ap.add_argument("--lmbda", type=float, default=0.013)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--full", action="store_true",
                    help="full-size model (default: tiny config)")
    ap.add_argument("--n-train", type=int, default=200)
    ap.add_argument("--precision-reg", type=float, default=0.0)
    ap.add_argument("--aux_scheduler", action="store_true", default=None,
                    help="adaptive aux LR (the reference's "
                         "ExponentialTargetScheduler); default auto: on "
                         "for --full, off for tiny")
    ap.add_argument("--no-aux_scheduler", dest="aux_scheduler",
                    action="store_false", help="force plain aux Adam")
    ap.add_argument("--checkpoint", default=None,
                    help="resume training from this checkpoint")
    add_device_flag(ap)
    return ap.parse_args(argv)


def options(a):
    """The run's TrainOptions, as the JAX tool sets them."""
    from dcae_tpu_torch.train.loop import TrainOptions

    return TrainOptions(
        dataset=a.data, epochs=a.epochs, batch_size=a.batch_size,
        test_batch_size=a.batch_size, patch_size=a.patch_size,
        lmbda=a.lmbda, learning_rate=a.lr,
        lr_epochs=(max(1, int(a.epochs * 0.9)),),
        save_path=a.save_path, save=True, log_every=10,
        val_real_every=max(1, a.epochs // 2), val_real_images=4,
        precision_reg=a.precision_reg, aux_scheduler=a.aux_scheduler,
        checkpoint=a.checkpoint)


def _real_rd(codec, batch) -> tuple:
    """Mean (bpp, PSNR) of each image of batch coded for real."""
    from dcae_tpu_torch.eval_lib import eval_image_real

    rs = [eval_image_real(codec, batch[i:i + 1])
          for i in range(batch.shape[0])]
    return (float(np.mean([r.bpp for r in rs])),
            float(np.mean([r.psnr for r in rs])))


def summarize(save_path: str, bpp0: float, bpp1: float,
              psnr1: float) -> dict:
    """The JAX tool's summary of train.jsonl: the first and last tenth of
    the logged train steps, and the real-codec numbers."""
    with open(os.path.join(save_path, "train.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    train = [r for r in recs if r["ns"] == "train" and "bpp_loss" in r]
    k = max(1, len(train) // 10)
    head, tail = train[:k], train[-k:]

    def avg(rows, key):
        return float(np.mean([r[key] for r in rows]))

    return {
        "loss_first": avg(head, "loss"), "loss_last": avg(tail, "loss"),
        "bpp_first": avg(head, "bpp_loss"),
        "bpp_last": avg(tail, "bpp_loss"),
        "aux_first": avg(head, "aux_loss"),
        "aux_last": avg(tail, "aux_loss"),
        "real_bpp_untrained": bpp0, "real_bpp_trained": bpp1,
        "real_psnr_trained": psnr1,
        "loss_fell": avg(tail, "loss") < avg(head, "loss"),
        "bpp_fell": avg(tail, "bpp_loss") < avg(head, "bpp_loss"),
        "aux_converging": avg(tail, "aux_loss") < 0.5 * avg(head,
                                                            "aux_loss"),
        "real_codec_improved": bpp1 < bpp0,
    }


def validate(opts, cfg, device, n_train: int = 200) -> dict:
    """Generate the corpus if opts.dataset has none, code 4 test crops
    with an untrained codec (seed 100), train, code them again with the
    trained parameters; writes and returns the summary. Both codecs and
    the training run on `device`."""
    from dcae_tpu_torch.data.datasets import ImageFolder
    from dcae_tpu_torch.models.codec import DCAECodec
    from dcae_tpu_torch.train.loop import _cudnn_flags_kept, run_training

    if not os.path.isdir(os.path.join(opts.dataset, "train")):
        print(f"generating synthetic dataset at {opts.dataset} ...")
        make_dataset(opts.dataset, n_train=n_train)

    test_ds = ImageFolder(opts.dataset, "test", opts.patch_size,
                          num_workers=4)
    try:
        batch = next(iter(test_ds.batches(4, drop_last=False)))
    finally:
        test_ds.pool.shutdown()
    # the codec makes cuDNN deterministic; the training takes that back
    with _cudnn_flags_kept():
        codec0 = DCAECodec(cfg, seed=100, device=device)
        try:
            codec0.update(force=True)
            bpp0, _ = _real_rd(codec0, batch)
        finally:
            codec0.close()
    print(f"untrained real bpp: {bpp0:.4f}")

    state = run_training(opts, cfg=cfg, device=device)

    codec1 = DCAECodec(cfg, params=state.model.state_dict(), device=device)
    try:
        codec1.update(force=True)
        bpp1, psnr1 = _real_rd(codec1, batch)
    finally:
        codec1.close()

    summary = summarize(opts.save_path, bpp0, bpp1, psnr1)
    print(json.dumps(summary, indent=2))
    with open(os.path.join(opts.save_path, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def passed(summary: dict) -> bool:
    return all(summary[k] for k in ("loss_fell", "bpp_fell",
                                    "real_codec_improved"))


def main(argv=None) -> int:
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.codec import resolve_device

    a = parse_args(argv)
    device = resolve_device(a.device)
    cfg = DCAEConfig() if a.full else DCAEConfig.tiny()
    summary = validate(options(a), cfg, device, n_train=a.n_train)
    ok = passed(summary)
    print("VALIDATION", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
