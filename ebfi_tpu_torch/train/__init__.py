"""Training of the port (``python -m ebfi_tpu_torch.train``): config,
optimizer and schedule, train and eval steps, trainers, checkpoints."""
from .config import ConfigParser
from .optim import Updater, build_lr_schedule, build_optimizer
from .train_step import (TrainState, build_adversarial, init_adv_state, make_eval_step,
                         make_train_step)

__all__ = [
    "ConfigParser",
    "Updater",
    "build_optimizer",
    "build_lr_schedule",
    "TrainState",
    "make_train_step",
    "make_eval_step",
    "build_adversarial",
    "init_adv_state",
]
