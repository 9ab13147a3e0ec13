"""The training loop: the canonical RD recipe on one device, or over a
(dp, sp) mesh of every process of a torch.distributed group (torchrun):
each rank reads the same global batches (the primary rank's order) and
trains on its dp index's rows, split over image rows by the sp ranks
(parallel/mesh.py); only the primary rank logs and checkpoints.

The recipe: dual Adam, clip 1.0, MultiStepLR x0.1 at lr_epochs, batch 8,
256^2 patches, checkpoints latest / every-5 / best, a resume restores the
optimizers and the schedule. The model trains in f32 with TF32 off, and the
window-8 blocks and the routed GLUs run their hand kernels on the card.
Runs on CUDA unless the caller passes device="cpu"; without a card and
without device="cpu" it raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional, Tuple

import torch

from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.data.datasets import ImageFolder
from dcae_tpu_torch.models.codec import resolve_device
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.parallel import mesh as pmesh
from dcae_tpu_torch.parallel.multihost import is_primary
from dcae_tpu_torch.train.state import (ExponentialTargetScheduler,
                                        TrainState, create_train_state,
                                        make_optimizer, multistep_lr,
                                        set_aux_lr)
from dcae_tpu_torch.train.step import make_eval_step, make_train_step
from dcae_tpu_torch.utils.checkpoint import CheckpointPolicy, load_checkpoint
from dcae_tpu_torch.utils.logging import MetricLogger
from dcae_tpu_torch.utils.metrics import AverageMeter


@dataclasses.dataclass
class TrainOptions:
    dataset: str
    epochs: int = 50
    learning_rate: float = 1e-4
    aux_learning_rate: float = 1e-3
    lmbda: float = 0.0483
    batch_size: int = 8
    test_batch_size: int = 8
    patch_size: int = 256
    loss_type: str = "mse"          # mse | ms-ssim | l1
    lr_epochs: Tuple[int, ...] = (46,)
    clip_max_norm: float = 1.0
    seed: int = 100
    save: bool = True
    save_path: str = "./checkpoints"
    checkpoint: Optional[str] = None
    continue_train: bool = True
    num_workers: int = 8
    sp: int = 1                      # spatial mesh axis
    drift_noise: float = 0.0
    log_every: int = 100
    use_wandb: bool = False
    # e.g. ("g_a", "h_a") = encoder-only fine-tuning
    freeze_except: Optional[Tuple[str, ...]] = None
    # cross-device precision regularization: weight of the MSE between
    # decoder outputs under precision_noise latent noise
    precision_reg: float = 0.0
    precision_noise: float = 1e-6
    # real-codec validation cadence in epochs (true entropy-coded RD,
    # logged under val_real/*); 0 disables
    val_real_every: int = 10
    val_real_images: int = 4
    # adaptive aux-LR: drive the quantile loss to aux_target_loss by the
    # end of training, retuning the aux Adam LR every epoch. None = auto:
    # ON for full-size configs (where plain Adam at aux_learning_rate
    # barely moves the quantile loss), OFF for tiny test configs.
    # True / False force it either way.
    aux_scheduler: Optional[bool] = None
    aux_target_loss: float = 10.0


def resolve_aux_scheduler(opts: TrainOptions, cfg: DCAEConfig) -> bool:
    """The auto default: scheduled aux LR for full-size configs, plain
    Adam for tiny ones."""
    if opts.aux_scheduler is not None:
        return opts.aux_scheduler
    return cfg.N >= 64


@contextlib.contextmanager
def _cudnn_flags_kept():
    """The codec makes cuDNN deterministic for its own sake; training does
    not need bitwise repeatability, so the trainer takes the setting back
    after it has borrowed a codec."""
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = before


def validate_real(cfg: DCAEConfig, state: TrainState, test_ds,
                  n_images: int) -> Optional[dict]:
    """True entropy-coded RD on a few validation images: bake tables from
    the live parameters, compress and decompress for real, report stream
    bpp and PSNR (the val_real/* namespace)."""
    from dcae_tpu_torch.eval_lib import eval_image_real
    from dcae_tpu_torch.models.codec import DCAECodec

    batch = next(iter(test_ds.batches(max(1, n_images), drop_last=False)),
                 None)
    if batch is None:
        return None
    device = next(state.model.parameters()).device
    with _cudnn_flags_kept():
        codec = DCAECodec(cfg, params=state.model.state_dict(),
                          dtype=torch.float32, device=device)
        try:
            codec.update(force=True)
            meters = {k: AverageMeter() for k in ("bpp", "psnr")}
            for i in range(min(n_images, batch.shape[0])):
                r = eval_image_real(codec, batch[i:i + 1])
                meters["bpp"].update(r.bpp)
                meters["psnr"].update(r.psnr)
        finally:
            codec.close()
    return {k: m.avg for k, m in meters.items()}


class _NoLogger:
    """The logger of a rank that does not log."""

    def log(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def run_training(opts: TrainOptions, cfg: Optional[DCAEConfig] = None,
                 device=None) -> TrainState:
    """Under a process group (parallel/multihost.initialize) the mesh
    spans its processes, one device each: dp = processes / opts.sp.
    opts.batch_size is the global batch and must split into equal dp
    shards; with sp > 1 each patch's rows are cut into sp bands of whole
    multiples of the band rule, which may differ by one multiple
    (parallel/spatial.py: band_rows)."""
    # this process's device: its own card under a process group
    mesh = pmesh.make_mesh(sp=opts.sp, device=resolve_device(device))
    device = mesh.device
    primary = is_primary()
    say = print if primary else (lambda *a, **k: None)
    if opts.batch_size % mesh.dp:
        raise ValueError(f"batch size {opts.batch_size} does not split "
                         f"over dp = {mesh.dp}")
    # full-f32 products, as the codec that will run the trained model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg is None:
        cfg = DCAEConfig(drift_noise=opts.drift_noise)

    train_ds = ImageFolder(opts.dataset, "train", opts.patch_size,
                           seed=opts.seed, num_workers=opts.num_workers)
    test_ds = ImageFolder(opts.dataset, "test", opts.patch_size,
                          seed=opts.seed, num_workers=opts.num_workers)
    steps_per_epoch = train_ds.steps_per_epoch(opts.batch_size)

    model = DCAE(cfg)
    model.reset_parameters(torch.Generator().manual_seed(opts.seed))
    model.to(device)
    n_params = sum(p.numel() for p in model.parameters())
    say(f"model: {n_params / 1e6:.1f}M params, "
        f"{steps_per_epoch} steps/epoch, on {device}, dp {mesh.dp} sp "
        f"{mesh.sp}")

    schedule = multistep_lr(
        opts.learning_rate, [m * steps_per_epoch for m in opts.lr_epochs])
    tx = make_optimizer(schedule, opts.aux_learning_rate, opts.clip_max_norm,
                        trainable_keys=opts.freeze_except)

    def noise_generator() -> torch.Generator:
        return torch.Generator(device=device).manual_seed(opts.seed + 1)

    state = create_train_state(model, tx, noise_generator())

    last_epoch = 0
    policy = CheckpointPolicy(opts.save_path)
    if opts.checkpoint:
        state, last_epoch, best = load_checkpoint(opts.checkpoint, state)
        policy.best_loss = best
        say(f"resumed from {opts.checkpoint} @ epoch {last_epoch} "
            f"(loss {best:.4f})")
        if not opts.continue_train:
            # architecture-migration resume: keep the parameters, rebuild
            # the optimizer state
            state = create_train_state(model, tx, noise_generator(),
                                       step=last_epoch * steps_per_epoch)

    logger = MetricLogger(opts.save_path, use_wandb=opts.use_wandb,
                          wandb_config=dataclasses.asdict(opts)) \
        if primary else _NoLogger()
    train_step = pmesh.shard_train_step(
        make_train_step(model, tx, opts.lmbda, opts.loss_type,
                        precision_reg=opts.precision_reg,
                        precision_noise=opts.precision_noise), mesh)
    eval_full = make_eval_step(model, opts.lmbda, opts.loss_type)
    eval_step = pmesh.shard_eval_step(eval_full, mesh)

    def to_device(batch) -> torch.Tensor:
        return torch.from_numpy(batch).to(device)

    aux_sched = None  # built from the first epoch's measured aux loss
    aux_sched_on = resolve_aux_scheduler(opts, cfg)
    if opts.aux_scheduler is None:
        say(f"aux_scheduler auto -> {'on' if aux_sched_on else 'off'} "
            f"(N={cfg.N})")

    try:
        for epoch in range(last_epoch, opts.epochs):
            t0 = time.time()
            meters = {k: AverageMeter()
                      for k in ("loss", "bpp_loss", "aux_loss")}
            # every rank reads the primary's order of the global batches
            order = pmesh.broadcast(train_ds.epoch_seed(epoch), mesh)
            for i, batch in enumerate(train_ds.batches(
                    opts.batch_size, epoch, order_seed=order)):
                state, metrics = train_step(
                    state, to_device(pmesh.shard_rows(batch, mesh)))
                if i % opts.log_every == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    logger.log(epoch * steps_per_epoch + i, metrics)
                    for k in meters:
                        meters[k].update(metrics.get(k, 0.0))
                    dist_key = next(k for k in metrics if k.endswith("_loss")
                                    and k not in ("bpp_loss", "aux_loss",
                                                  "precision_loss"))
                    say(f"epoch {epoch} [{i}/{steps_per_epoch}] "
                        f"loss {metrics['loss']:.4f} | "
                        f"{dist_key} {metrics[dist_key]:.5f} | "
                        f"bpp {metrics['bpp_loss']:.3f} | "
                        f"aux {metrics['aux_loss']:.1f}")

            test_meter = AverageMeter()
            for batch in test_ds.batches(opts.test_batch_size,
                                         drop_last=False):
                if batch.shape[0] % mesh.dp == 0:
                    m = eval_step(to_device(pmesh.shard_rows(batch, mesh)))
                elif primary:
                    # a leftover batch: whole, on one rank, counted once
                    m = eval_full(to_device(batch))
                else:
                    continue
                test_meter.update(float(m["loss"]), batch.shape[0])
            test_loss = test_meter.avg
            logger.log((epoch + 1) * steps_per_epoch, {"loss": test_loss},
                       namespace="val")
            say(f"epoch {epoch}: test loss {test_loss:.4f} "
                f"({time.time() - t0:.0f}s)")

            if aux_sched_on and meters["aux_loss"].count:
                aux_now = meters["aux_loss"].avg
                if aux_sched is None:
                    aux_sched = ExponentialTargetScheduler(
                        start_loss=max(aux_now, opts.aux_target_loss * 2),
                        target_loss=opts.aux_target_loss,
                        total_epochs=max(1, opts.epochs - last_epoch))
                new_lr, mult = aux_sched.step(aux_now, schedule(state.step),
                                              epoch - last_epoch)
                set_aux_lr(state, new_lr)
                logger.log((epoch + 1) * steps_per_epoch,
                           {"aux_lr": new_lr, "aux_mult": mult},
                           namespace="aux_sched")
                say(f"epoch {epoch}: aux_lr -> {new_lr:.2e} (x{mult:.0f}, "
                    f"aux {aux_now:.1f})")

            if (primary and opts.val_real_every > 0
                    and (epoch + 1) % opts.val_real_every == 0):
                vr = validate_real(cfg, state, test_ds, opts.val_real_images)
                if vr:
                    logger.log((epoch + 1) * steps_per_epoch, vr,
                               namespace="val_real")
                    say(f"epoch {epoch}: val_real bpp {vr['bpp']:.4f} "
                        f"psnr {vr['psnr']:.2f} dB")

            if opts.save and primary:
                policy.save(state, epoch + 1, test_loss)
    finally:
        logger.close()
        train_ds.pool.shutdown()
        test_ds.pool.shutdown()
    return state
