"""Training layer: losses, the dual-optimizer state, the step, the loop."""

from dcae_tpu_torch.train.losses import (rate_distortion_loss,
                                         reconstruction_loss)
from dcae_tpu_torch.train.state import (TrainState, create_train_state,
                                        make_optimizer, multistep_lr,
                                        param_labels)
from dcae_tpu_torch.train.step import make_eval_step, make_train_step

__all__ = [
    "rate_distortion_loss", "reconstruction_loss", "TrainState",
    "create_train_state", "make_optimizer", "multistep_lr", "param_labels",
    "make_eval_step", "make_train_step",
]
