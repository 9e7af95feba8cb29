"""Typed configuration tree (a copy of toothgroupnetwork_tpu/train/config.py,
held equal to it by the tests): the same dataclasses, so that a config the
JAX package's ``TrainConfig.save_json`` writes loads here and back.

``distributed`` and ``data_parallel`` are read from such a file, but the
port's trainer runs on one device (``Trainer`` raises for
``data_parallel > 1``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass
class OptimizerConfig:
    name: str = "adam"            # "adam" | "sgd"
    lr: float = 1e-3
    weight_decay: float = 1e-4    # L2 added to grads (torch convention)
    momentum: float = 0.9         # sgd only


@dataclass
class SchedulerConfig:
    sched: str = "cosine"  # cosine|exp|constant|step|tanh|poly|multistep|plateau
    full_steps: int = 40          # cosine period in EPOCHS (reference full_steps)
    min_lr: float = 1e-5
    warmup_epochs: int = 0
    step_decay: float = 0.95      # exp/step/multistep decay; poly power
    # tanh bounds (timm TanhLRScheduler defaults, tanh_lr.py:27-28)
    tanh_lb: float = -7.0
    tanh_ub: float = 3.0
    # multistep milestones (epochs); plateau patience/factor
    milestones: tuple = (30, 60)
    plateau_patience: int = 10
    plateau_factor: float = 0.1
    # reference "schedueler_step" (trainer.py:36-41): batches between scheduler
    # steps + per-step wandb logs. All shipped reference configs set 15e6 so it
    # effectively fires once per epoch — 0 (default) keeps that per-epoch
    # behavior; >0 enables the per-N-batch contract (step-frequency logs, lr_fn
    # fed the step counter instead of the epoch).
    step_batches: int = 0


@dataclass
class GeneratorConfig:
    input_data_dir_path: str = ""
    train_data_split_txt_path: str | None = None
    val_data_split_txt_path: str | None = None
    # augmentation as data, not eval()-strings; see data.augment.build_augmenter
    aug_specs: list = field(default_factory=lambda: [
        ("scaling", [0.85, 1.15]),
        ("rotation", [-30, 30], "fixed"),
        ("translation", [-0.2, 0.2]),
    ])
    train_batch_size: int = 1
    val_batch_size: int = 1


@dataclass
class DistributedConfig:
    """Multi-host init of the JAX package (its parallel/distributed.py); the
    port reads and writes it and starts nothing from it."""

    enabled: bool = False
    coordinator_address: str | None = None   # "host:port"; None = auto-detect
    num_processes: int | None = None          # None = auto-detect
    process_id: int | None = None             # None = auto-detect


@dataclass
class TrainConfig:
    model_name: str = "pointnet"
    experiment_name: str = "exp"
    checkpoint_path: str = "ckpts/exp"
    seed: int = 0
    max_epochs: int = 100000      # reference: unguarded range(100000) (trainer.py:99)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    generator: GeneratorConfig = field(default_factory=GeneratorConfig)
    # per-loss weights, e.g. {"tooth_class_loss_1": 1.0}
    loss_weights: dict[str, float] = field(default_factory=dict)
    # free-form per-model-family parameters (crop sizes, strides, ...)
    model_parameter: dict[str, Any] = field(default_factory=dict)
    # wandb-style experiment logging (off by default; console always logs)
    wandb_on: bool = False
    wandb_project: str = "toothgroupnetwork-tpu"
    # data-parallel: number of devices to shard the batch over (1 = one device;
    # the port's trainer takes only 1)
    data_parallel: int = 1
    # elastic recovery: on an epoch failure (preempted device, OOM, flaky IO),
    # restore the last checkpoint and retry up to this many times (0 = off —
    # the reference contract: one unguarded loop, trainer.py:96-101)
    elastic_retries: int = 0
    # multi-host init (read and written; the port starts nothing from it)
    distributed: DistributedConfig = field(default_factory=DistributedConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        d = dict(d)
        for key, sub in (("optimizer", OptimizerConfig),
                         ("scheduler", SchedulerConfig),
                         ("generator", GeneratorConfig),
                         ("distributed", DistributedConfig)):
            if key in d and isinstance(d[key], dict):
                d[key] = sub(**d[key])
        return cls(**d)

    def save_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load_json(cls, path: str) -> "TrainConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))
