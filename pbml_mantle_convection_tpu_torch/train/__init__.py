"""Losses, train and eval steps, the epoch loop and the Trainer: the
counterpart of the JAX package's ``train/``."""

from .losses import (  # noqa: F401,E402
    LossBreakdown, fluidnet_loss, mass_penalty, mass_residual,
    scaled_boundary_l1, unet_loss)
from .train_step import (  # noqa: F401,E402
    TrainStepConfig, make_eval_step, make_loss_fn, make_train_step)
from .trainer import (  # noqa: F401,E402
    TrainConfig, Trainer, best_epoch_from_log, parse_loss_log)
