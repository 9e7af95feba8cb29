"""Learning-rate schedules (a copy of toothgroupnetwork_tpu/train/schedule.py,
held equal to it by the tests).

The reference uses the timm-derived cosine scheduler stepped once per epoch
(external_libs/scheduler/cosine_lr.py via scheduler_factory.py:11-118; all configs set
``sched='cosine', full_steps=40`` and a schedueler_step so large it only fires at
epoch end, SURVEY.md §2.5). We reproduce that as a pure ``epoch -> lr`` function whose
value is set on the optimizer each epoch.
"""

from __future__ import annotations

import math

from .config import OptimizerConfig, SchedulerConfig


def make_epoch_lr_fn(opt: OptimizerConfig, sched: SchedulerConfig):
    """Returns ``lr(epoch: int) -> float``.

    cosine: timm CosineLRScheduler contract with cycle_limit=1 —
      warmup epochs ramp linearly to base lr, then
      ``min_lr + 0.5*(lr−min_lr)*(1+cos(pi*t/T))`` for t in [0, T), clamped to
      ``min_lr`` afterwards.
    exp: torch ExponentialLR per epoch.
    """
    base = opt.lr

    if sched.sched == "cosine":
        t_total = sched.full_steps
        warm = sched.warmup_epochs
        min_lr = sched.min_lr

        def lr_fn(epoch: int) -> float:
            if warm > 0 and epoch < warm:
                return base * (epoch + 1) / warm
            t = epoch - warm
            if t >= t_total:
                return min_lr
            return min_lr + 0.5 * (base - min_lr) * (1 + math.cos(math.pi * t / t_total))

        return lr_fn

    if sched.sched == "exp":
        def lr_fn(epoch: int) -> float:
            return base * (sched.step_decay ** epoch)

        return lr_fn

    if sched.sched == "constant":
        return lambda epoch: base

    if sched.sched == "step":
        # timm StepLRScheduler contract: decay by step_decay every full_steps epochs
        def lr_fn(epoch: int) -> float:
            return base * (sched.step_decay ** (epoch // max(sched.full_steps, 1)))

        return lr_fn

    if sched.sched == "tanh":
        # timm TanhLRScheduler (tanh_lr.py:70-97, cycle_limit=1):
        # lr = min + 0.5*(base-min)*(1 - tanh(lb*(1-tr) + ub*tr)), tr = t/T
        t_total, warm, min_lr = sched.full_steps, sched.warmup_epochs, sched.min_lr
        lb, ub = sched.tanh_lb, sched.tanh_ub

        def lr_fn(epoch: int) -> float:
            if warm > 0 and epoch < warm:
                return base * (epoch + 1) / warm
            t = epoch - warm
            if t >= t_total:
                return min_lr
            tr = t / t_total
            return min_lr + 0.5 * (base - min_lr) * (
                1 - math.tanh(lb * (1 - tr) + ub * tr))

        return lr_fn

    if sched.sched == "poly":
        # timm PolyLRScheduler (poly_lr.py:69-95, k_decay=1, cycle_limit=1):
        # lr = min + (base-min) * (1 - t/T)**power; the factory overloads
        # decay_rate as the power (scheduler_factory.py:102-105)
        t_total, warm, min_lr = sched.full_steps, sched.warmup_epochs, sched.min_lr
        power = sched.step_decay

        def lr_fn(epoch: int) -> float:
            if warm > 0 and epoch < warm:
                return base * (epoch + 1) / warm
            t = epoch - warm
            if t >= t_total:
                return min_lr
            return min_lr + (base - min_lr) * (1 - t / t_total) ** power

        return lr_fn

    if sched.sched == "multistep":
        # timm MultiStepLRScheduler (multistep_lr.py:45-53):
        # decay by step_decay at each milestone; bisect_right(milestones, t+1)
        import bisect

        milestones = sorted(sched.milestones)

        def lr_fn(epoch: int) -> float:
            return base * (sched.step_decay
                           ** bisect.bisect_right(milestones, epoch + 1))

        return lr_fn

    if sched.sched == "plateau":
        # torch ReduceLROnPlateau semantics (plateau_lr.py wraps it): stateful —
        # use make_plateau_lr() and feed it the validation metric each epoch.
        return make_plateau_lr(opt, sched)

    raise ValueError(f"unknown scheduler {sched.sched!r}")


class PlateauLR:
    """Stateful plateau scheduler (reference plateau_lr.py:12-58 wrapping torch
    ReduceLROnPlateau): multiply lr by ``factor`` after ``patience`` epochs
    without improvement, using torch's default RELATIVE threshold
    (``metric < best * (1 - 1e-4)`` in min mode). Call
    ``lr_fn(epoch, metric=val_loss)``; epochs without a metric reuse the
    current lr (matches the factory's eval-metric driven stepping,
    scheduler_factory.py:89-101).

    Deliberate deviation: we resolve mode='min' (improvement = lower val
    loss). The reference factory's getattr-on-dict quirk effectively resolves
    mode='max' — maximizing a LOSS, which never improves and decays lr every
    ``patience`` epochs regardless of training; we implement the intended
    semantics instead."""

    def __init__(self, base: float, min_lr: float, patience: int, factor: float):
        self.lr = base
        self.min_lr = min_lr
        self.patience = patience
        self.factor = factor
        self.best = float("inf")
        self.bad_epochs = 0

    def __call__(self, epoch: int, metric: float | None = None) -> float:
        if metric is not None:
            # torch ReduceLROnPlateau default threshold_mode='rel', mode='min'
            if metric < self.best * (1 - 1e-4):
                self.best = metric
                self.bad_epochs = 0
            else:
                self.bad_epochs += 1
                if self.bad_epochs > self.patience:
                    self.lr = max(self.lr * self.factor, self.min_lr)
                    self.bad_epochs = 0
        return self.lr


def make_plateau_lr(opt: OptimizerConfig, sched: SchedulerConfig) -> PlateauLR:
    return PlateauLR(opt.lr, sched.min_lr, sched.plateau_patience,
                     sched.plateau_factor)
