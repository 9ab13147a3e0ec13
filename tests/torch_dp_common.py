"""What the data-parallel worker (tests/torch_dp_worker.py) and its tests
(tests/test_torch_parallel.py; on several cards tests/test_torch_cuda.py)
build alike: the tiny config (with drift noise, so that every
training-noise draw runs), a seeded train state and step, the global
batch, the run_training options."""

import numpy as np
import torch

from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.entropy.ops import dp_noise
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.train.loop import TrainOptions
from dcae_tpu_torch.train.state import (apply_updates, create_train_state,
                                        make_optimizer)
from dcae_tpu_torch.train.step import make_loss_fn, make_train_step

CFG = DCAEConfig.tiny(drift_noise=0.01)
LMBDA = 0.0483
# the precision penalty's normal draw too
TRAIN_KW = dict(precision_reg=0.1, precision_noise=1e-3)




def card_config() -> DCAEConfig:
    """On the card: the tiny model with window-8 stacks whose widths the
    window kernels take (chip_smoke.TINY_W8), drift noise on."""
    from chip_smoke import TINY_W8

    return DCAEConfig.tiny(**TINY_W8, drift_noise=0.01)


def global_batch(n: int = 2, size: int = 64, seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        0, 1, (n, size, size, 3)).astype(np.float32)


def _seeded(cfg: DCAEConfig, device):
    model = DCAE(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(device)
    tx = make_optimizer(1e-4, 1e-3, 1.0)
    state = create_train_state(
        model, tx, torch.Generator(device=device).manual_seed(1))
    return model, tx, state


def state_and_step(cfg: DCAEConfig = CFG, device="cpu", **kw):
    model, tx, state = _seeded(cfg, device)
    return model, state, make_train_step(model, tx, LMBDA, "mse", **kw)


def shard_mean_steps(cfg: DCAEConfig, device, batch: torch.Tensor,
                     world: int, steps: int = 2, **kw):
    """What `world` dp ranks compute, one shard after another in one
    process and in the ranks' batch shape: each shard's loss under
    dp_noise from the same generator state, the gradients summed over the
    shards and divided by world, then one update. Returns (model, step
    1's gradients as numpy)."""
    model, tx, state = _seeded(cfg, device)
    loss_fn = make_loss_fn(model, LMBDA, "mse", **kw)
    rows = batch.shape[0] // world
    first = None
    for step in range(steps):
        for p in model.parameters():
            p.grad = None
        start = state.generator.get_state()
        for rank in range(world):
            state.generator.set_state(start)
            with dp_noise(rank, world):
                loss, _ = loss_fn(batch[rank * rows:(rank + 1) * rows],
                                  state.generator)
            loss.backward()
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(world)
        apply_updates(state, tx)
        if step == 0:
            first = {k: p.grad.cpu().numpy()
                     for k, p in model.named_parameters()}
    return model, first


def train_options(work: str, save: str) -> TrainOptions:
    """One epoch of 2 global batches of 2 on 4 train PNGs; 3 test PNGs in
    batches of 2, so that the last test batch is a leftover under dp 2."""
    return TrainOptions(dataset=f"{work}/data", epochs=1, batch_size=2,
                        test_batch_size=2, patch_size=64,
                        save_path=f"{work}/{save}", val_real_every=0,
                        log_every=1, num_workers=1, seed=7)
