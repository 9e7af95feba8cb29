"""Trainer (counterpart of toothgroupnetwork_tpu/train/trainer.py).

The JAX package's loop contract on one device: epochs of ``train_epoch`` and
``eval_epoch``, the learning rate set per epoch (or every
``scheduler.step_batches`` batches), ``<loss>_{train,step,val}`` log names,
the latest and best-val checkpoint slots, ``resume``, and the elastic retry
that restores the last checkpoint after a failed epoch. The step is the
explicit function :func:`train_step`; the validation pass runs the model in
eval mode, so its attention layers run the kernel K3. A task's host stage
(tgnet_bdl's boundary resampling, tsegnet's crop proposals) runs on the
loader's numpy batch before each train and val step
(:meth:`Trainer.host_batch`), after a padded val batch lost its padding.
The Trainer owns the dropout generator, on the model's device, seeded
before each step from ``(config.seed + 1, step)`` (:func:`dropout_seed`).

``data_parallel = D > 1`` trains over a group of D ranks (the JAX
Trainer's data mesh, trainer.py:92-103; ``cli.train --data_parallel``
spawns them): every rank iterates the same seeded loader and keeps its
rows of each batch (``parallel.shard_batch``; the global batch must divide
by D), runs the host stage on them, and takes the step of
:func:`train_step` with the mesh, whose BatchNorm statistics, loss
normalisers, dropout draws and gradient are those of the global batch
(``parallel/data_parallel.py``). Rank 0 broadcasts the parameters and the
optimizer state at the start, logs, and writes the checkpoints; the val
batches are padded to a multiple of D, and the val meters are summed over
the ranks, weighted by items. A host stage, the val pass or the checkpoint
failing on one rank fails every rank at the same exchange
(``data_parallel.RankFailure``), so the elastic retry restores them
together.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import TYPE_CHECKING

import numpy as np
import torch
import torch.distributed as dist

from ..nn.layers import Dropout
from ..parallel import data_parallel
from ..parallel.distributed import maybe_initialize
from ..parallel.mesh import make_data_mesh, replicate, shard_batch
from ..utils import profiling
from ..utils.device import resolve_device
from ..utils.weights import init_like_flax_
from .checkpoints import restore_train_checkpoint, save_train_checkpoint
from .loss_meter import LossMap, LossMeter
from .schedule import PlateauLR, make_epoch_lr_fn
from .train_state import make_optimizer, set_learning_rate

if TYPE_CHECKING:
    from ..models.registry import ModelTask

# cuBLAS is deterministic under torch.use_deterministic_algorithms only with
# a fixed workspace; the size torch picks by default on Hopper
CUBLAS_WORKSPACE = ":4096:8"


@contextlib.contextmanager
def deterministic_algorithms(on: bool = True):
    """``torch.use_deterministic_algorithms(on)`` inside the block: every op
    takes its deterministic implementation (the gathers' backward
    scatter-adds among them) or raises."""
    before = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(on)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before, warn_only=warn)


def dropout_seed(seed: int, step: int) -> int:
    """The dropout generator's seed before optimizer step ``step``: a
    function of ``(seed + 1, step)`` alone, so that a resumed run draws
    what an unbroken run draws (JAX: ``fold_in(PRNGKey(seed + 1), step)``;
    the draws themselves differ from threefry's)."""
    state = np.random.SeedSequence([seed + 1, step]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def train_step(model, optimizer, task: "ModelTask", config, batch: dict,
               deterministic: bool = True,
               generator: torch.Generator | None = None, mesh=None) -> dict:
    """One step: the train-mode forward, the weighted sum of the task's
    losses, backward and the optimizer's update, under deterministic
    algorithms unless ``deterministic`` is False. ``generator`` (on the
    model's device) is every ``Dropout``'s for this step only; a model with
    dropout needs one. Returns each loss's value (a detached tensor on the
    model's device).

    With a data-parallel ``mesh`` (``batch`` is this rank's rows of the
    global batch) the step is the one-process step over the global batch:
    the forward runs in ``data_parallel.context(mesh)``, the gradients are
    all-reduced in one call and divided by D
    (``data_parallel.all_reduce_grads``), and the values are averaged over
    the ranks. On a thread that traces, the forward with the losses, the
    backward with the gradients' reduction, and the update are the spans
    ``step.forward``, ``step.backward`` and ``step.optimizer``."""
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    for m in drops:
        m.generator = generator
    model.train()
    try:
        with deterministic_algorithms(deterministic), data_parallel.context(mesh):
            with profiling.span("step.forward"):
                outputs = model(batch["feat"], batch.get("mask"),
                                **task.forward_kwargs(batch))
                losses = task.compute_losses(outputs, batch, config)
            with profiling.span("step.backward"):
                optimizer.zero_grad(set_to_none=True)
                LossMap(losses).get_sum().backward()
                zero_missing_grads(optimizer)
                if mesh is not None:
                    data_parallel.all_reduce_grads(
                        [p for g in optimizer.param_groups for p in g["params"]], mesh)
            with profiling.span("step.optimizer"):
                optimizer.step()
    finally:
        for m in drops:
            m.generator = None
    values = {k: v.detach() for k, (v, _) in losses.items()}
    return values if mesh is None else data_parallel.mean_values(values, mesh)


def apply_host_stage(task: "ModelTask", model, batch: dict, config, step: int) -> dict:
    """The batch with the task's host stage applied: the stage gets the
    loader's numpy arrays (a mask of ones where there is none), its other
    fields and ``step``, the optimizer steps taken, and the arrays it
    returns replace the batch's. The batch as it is for a task without a
    host stage."""
    if task.host_stage is None:
        return batch
    arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    arrays.setdefault("mask", np.ones(arrays["feat"].shape[:2], dtype=bool))
    host = {**batch, **arrays}
    return {**host, **task.host_stage(model, host, config, step=step)}


def zero_missing_grads(optimizer) -> None:
    """A zero gradient for every parameter the losses did not reach (the
    crop stage's offset classifier), so that it still decays, as under
    optax; torch's optimizers skip a parameter whose gradient is None."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def eval_step(model, task: "ModelTask", config, batch: dict) -> dict:
    """The task's losses of the eval-mode forward (running statistics, the
    eval kernels), without gradients."""
    model.eval()
    with torch.no_grad():
        outputs = model(batch["feat"], batch.get("mask"), **task.forward_kwargs(batch))
        losses = task.compute_losses(outputs, batch, config)
    return {k: v for k, (v, _) in losses.items()}


class Trainer:
    """``device``: where the model trains (the card unless the caller names
    another device). The model starts from flax's initial distribution,
    drawn from a generator seeded with ``config.seed``. ``mesh``: the data
    mesh of ``config.data_parallel`` ranks (by default the running process
    group, which must hold that many ranks)."""

    def __init__(self, config, task: "ModelTask", train_loader, val_loader,
                 log_fn=print, device: str | torch.device = "cuda", mesh=None):
        # before the process's first cuBLAS call, which fixes the workspace
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
        self.config = config
        self.task = task
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.device = resolve_device(str(device))
        self.mesh = self._data_mesh(config, mesh)
        self.is_main = self.mesh is None or self.mesh.rank == 0
        self.log = log_fn if self.is_main else (lambda _msg: None)
        self.lr_fn = make_epoch_lr_fn(config.optimizer, config.scheduler)
        self.model = task.build_module(config, device=self.device)
        init_like_flax_(self.model, torch.Generator().manual_seed(config.seed))
        self.optimizer = make_optimizer(config.optimizer, self.model.parameters())
        self._replicate_state()
        self.dropout_generator = torch.Generator(device=self.device)
        self.step = 0          # optimizer steps taken
        self.best_val = float("inf")
        self.epoch = 0
        self.step_count = 0    # scheduler-step counter (reference step_count)
        self.wandb = None
        if config.wandb_on and self.is_main:
            try:
                import wandb

                self.wandb = wandb
                wandb.init(project=config.wandb_project, name=config.experiment_name,
                           config=config.to_dict())
            except Exception as e:  # wandb is optional: log and go on without it
                self.log(f"wandb disabled: {e!r}")

    def _data_mesh(self, config, mesh):
        """The data mesh of ``config.data_parallel`` ranks, or None for one:
        ``mesh`` when given, else the process group, which must be running
        with that many ranks (started here from ``config.distributed`` when
        it is enabled)."""
        d = config.data_parallel
        if d <= 1:
            return None
        if mesh is not None:
            if mesh.size != d:
                raise ValueError(f"data_parallel={d} on a mesh of {mesh.size} ranks")
            return mesh
        maybe_initialize(config, self.device)
        if not dist.is_initialized() or dist.get_world_size() != d:
            raise ValueError(
                f"data_parallel={d} needs a torch.distributed group of {d} ranks "
                "(cli.train --data_parallel spawns them; parallel.RankPool and "
                "maybe_initialize start one)")
        return make_data_mesh(d, device=self.device)

    def _replicate_state(self) -> None:
        """Rank 0's parameters, buffers and optimizer state on every rank."""
        if self.mesh is None:
            return
        replicate(self.model, self.mesh)
        replicate([t for st in self.optimizer.state.values() for t in st.values()
                   if isinstance(t, torch.Tensor)], self.mesh)

    def host_batch(self, batch: dict) -> dict:
        """The batch with the task's host stage applied
        (:func:`apply_host_stage`, at the optimizer steps taken)."""
        return apply_host_stage(self.task, self.model, batch, self.config, self.step)

    def device_batch(self, batch: dict) -> dict:
        """The batch's arrays as tensors on the device (a mask of ones where
        the batch has none); other fields dropped."""
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        arrays.setdefault("mask", np.ones(arrays["feat"].shape[:2], dtype=bool))
        return {k: torch.from_numpy(v).to(self.device) for k, v in arrays.items()}

    def _weighted(self, values: dict, postfix: str) -> dict:
        out = {f"{k}_{postfix}": float(profiling.fetch(v)) * self._weight(k)
               for k, v in values.items()}
        out[f"total_{postfix}"] = sum(out.values())
        return out

    def train_epoch(self) -> dict:
        """One pass over the train loader. Under a recording torch profiler
        each batch is a ``step`` span, group the step's number, holding the
        loader's ``data.next``, ``step.batch`` (the host stage and the copy
        to the device), the step's own spans and the losses' ``card_wait``
        (``utils/profiling.py``)."""
        meter = LossMeter()
        step_meter = LossMeter()
        step_every = self.config.scheduler.step_batches
        pre_step = self.step_count
        try:
            n_batches = len(self.train_loader)
        except TypeError:
            n_batches = -1  # unsized loader: no epoch-end fallback fire
        batches = iter(self.train_loader)
        with profiling.tracing():
            for batch_idx in itertools.count():
                with profiling.span("step", self.step) as step:
                    batch = next(batches, None)
                    if batch is None:
                        step.drop()
                        break
                    with profiling.span("step.batch"), self._agreed():
                        if self.mesh is not None:
                            batch = shard_batch(batch, self.mesh)
                        with data_parallel.context(self.mesh):
                            batch = self.device_batch(self.host_batch(batch))
                    self.dropout_generator.manual_seed(
                        dropout_seed(self.config.seed, self.step))
                    values = train_step(self.model, self.optimizer, self.task,
                                        self.config, batch,
                                        generator=self.dropout_generator, mesh=self.mesh)
                    self.step += 1
                    weighted = self._weighted(values, "step")
                meter.aggr(weighted)
                if step_every > 0:
                    # per-N-batch scheduler stepping and step-frequency
                    # logging: every step_batches batches, or once at the
                    # epoch's end if it never fired
                    step_meter.aggr(weighted)
                    if ((batch_idx + 1) % step_every == 0
                            or (self.step_count == pre_step
                                and batch_idx == n_batches - 1)):
                        plateau = isinstance(self.lr_fn, PlateauLR)
                        lr = self.lr_fn.lr if plateau else self.lr_fn(self.step_count)
                        if self.wandb:
                            self.wandb.log(step_meter.get_avg_results(),
                                           step=self.step_count)
                            self.wandb.log({"step_lr": lr}, step=self.step_count)
                        self.step_count += 1
                        if not plateau:
                            set_learning_rate(self.optimizer, self.lr_fn(self.step_count))
                        step_meter = LossMeter()
        return {k.replace("_step", "_train"): v
                for k, v in meter.get_avg_results().items()}

    def eval_epoch(self) -> dict:
        meter = LossMeter()
        with self._agreed():
            self._eval_batches(meter)
        if self.mesh is not None:
            meter.loss_meter_dict, meter.step_num = data_parallel.merge_meters(
                meter.loss_meter_dict, meter.step_num, self.mesh)
        return meter.get_avg_results()

    def _eval_batches(self, meter) -> None:
        for batch in self.val_loader:
            # a partial val batch is padded by repeating item 0 and flagged
            # in batch_valid: slice the padding off, so that it cannot bias
            # the val loss (and the best-checkpoint choice)
            bv = batch.pop("batch_valid", None)
            if self.mesh is not None:
                # padded to a multiple of D the same way; each rank keeps its
                # rows, and a rank left with padding only skips the batch
                batch = shard_batch(_pad_rows(batch, bv, self.mesh.size), self.mesh)
                bv = batch.pop("batch_valid")
                if not bv.any():
                    continue
            if bv is not None and not bv.all():
                n_valid = int(bv.sum())
                batch = {k: (v[:n_valid] if isinstance(v, (np.ndarray, list))
                             and len(v) == len(bv) else v)
                         for k, v in batch.items()}
            else:
                n_valid = len(batch["feat"])
            values = eval_step(self.model, self.task, self.config,
                               self.device_batch(self.host_batch(batch)))
            meter.aggr(self._weighted(values, "val"), weight=n_valid)

    @contextlib.contextmanager
    def _agreed(self):
        """Work of this rank outside the step's collectives (the host stage,
        the val pass, the checkpoint) whose failure every rank must hear
        of: under a mesh, a failure inside raises ``RankFailure`` on every
        rank at the same exchange (``data_parallel.fail``), and the work's
        end is an exchange that every rank passes together."""
        if self.mesh is None:
            yield
            return
        try:
            yield
        except data_parallel.RankFailure:
            raise
        except Exception as e:
            data_parallel.fail(e, self.mesh)
        data_parallel.exchange(None, self.mesh)

    def _weight(self, name: str) -> float:
        return self.config.loss_weights.get(name, 1.0)

    def _run_one_epoch(self):
        set_learning_rate(self.optimizer, self.lr_fn(self.epoch))
        t0 = time.perf_counter()
        train_stats = self.train_epoch()
        val_stats = self.eval_epoch()
        dt = time.perf_counter() - t0
        if isinstance(self.lr_fn, PlateauLR):
            # plateau decays on the val metric
            self.lr_fn(self.epoch, metric=val_stats.get("total_val"))
        stats = {**train_stats, **val_stats,
                 "lr": self.lr_fn(self.epoch), "epoch_time_s": dt}
        self.log(f"epoch {self.epoch}: " +
                 " ".join(f"{k}={v:.5f}" for k, v in stats.items()))
        if self.wandb:
            self.wandb.log(stats, step=self.epoch)

        improved = val_stats.get("total_val", float("inf")) < self.best_val
        if improved:
            self.best_val = val_stats["total_val"]
        with self._agreed():   # the checkpoint is whole for every rank after
            if self.is_main:
                save_train_checkpoint(self.config.checkpoint_path, self.model,
                                      self.optimizer, self.step, self.epoch)
                if improved:
                    save_train_checkpoint(self.config.checkpoint_path + "_val",
                                          self.model, self.optimizer, self.step,
                                          self.epoch, {"best_val": self.best_val})
        self.epoch += 1

    def run(self, max_epochs: int | None = None):
        """The epoch loop, bounded by ``max_epochs`` (else the config's).
        With ``config.elastic_retries > 0`` a failed epoch restores the last
        checkpoint (model, optimizer, step and epoch) and runs again, up to
        that many times in a row. Under a mesh only a failure that every
        rank raised together (``RankFailure``: a host stage, the val pass or
        the checkpoint failing on some rank) is retried, every rank
        restoring at once; a failure inside a step's collectives ends the
        run, since the peers wait in a collective that cannot pair up."""
        total = max_epochs if max_epochs is not None else self.config.max_epochs
        end = self.epoch + total
        failures = 0
        while self.epoch < end:
            try:
                self._run_one_epoch()
                failures = 0  # a completed epoch resets the retry budget
            except KeyboardInterrupt:
                raise
            except Exception as e:
                failures += 1
                if failures > self.config.elastic_retries or (
                        self.mesh is not None
                        and not isinstance(e, data_parallel.RankFailure)):
                    raise
                self.log(f"epoch {self.epoch} failed ({e!r}); restoring last "
                         f"checkpoint and retrying "
                         f"({failures}/{self.config.elastic_retries})")
                if os.path.exists(self.config.checkpoint_path):
                    self.resume()  # rolls the state and the epoch back
                else:
                    # nothing checkpointed yet: retry the epoch with the
                    # current (partly advanced) state
                    self.log("no checkpoint to restore; retrying in place")
        return self.model

    def resume(self) -> int:
        """Restore the latest checkpoint (on every rank, from the one file
        rank 0 wrote); returns the epoch to run next."""
        self.step, epoch = restore_train_checkpoint(
            self.config.checkpoint_path, self.model, self.optimizer)
        self._replicate_state()
        self.epoch = epoch + 1
        return self.epoch


def _pad_rows(batch: dict, valid, multiple: int) -> dict:
    """``batch`` with its rows padded to a multiple of ``multiple`` by
    repeats of row 0 (as the loader pads a partial batch's arrays; its
    lists, which the loader leaves at the valid items, are padded so too),
    and its row validity under ``batch_valid`` (``valid``, or all rows)."""
    b = len(batch["feat"])
    valid = np.ones(b, bool) if valid is None else np.asarray(valid, bool)
    extra = -b % multiple
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim and v.shape[0] == b:
            v = np.concatenate([v] + [v[:1]] * extra)
        elif isinstance(v, list) and 0 < len(v) <= b:
            v = v + v[:1] * (b + extra - len(v))
        out[k] = v
    out["batch_valid"] = np.concatenate([valid, np.zeros(extra, bool)])
    return out
