"""Training runtime of the port (counterpart of toothgroupnetwork_tpu/train/):
the typed config tree, schedules, the optimizer factory, loss meters,
checkpoints and the ``Trainer``."""

from .config import (GeneratorConfig, OptimizerConfig, SchedulerConfig,
                     TrainConfig)
from .loss_meter import LossMap, LossMeter
from .schedule import make_epoch_lr_fn
from .train_state import make_optimizer, set_learning_rate
from .trainer import Trainer, eval_step, train_step

__all__ = ["GeneratorConfig", "LossMap", "LossMeter", "OptimizerConfig",
           "SchedulerConfig", "TrainConfig", "Trainer", "eval_step",
           "make_epoch_lr_fn", "make_optimizer", "set_learning_rate",
           "train_step"]
