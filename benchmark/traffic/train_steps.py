"""Traffic kind ``train_steps``: ``Trainer.train_epoch`` over a loader of
labelled synthetic arch cases, epoch after epoch, for any task the port
registers and either optimizer its ``make_optimizer`` builds.

The traffic file names the task (``model``), the cases (``[ns, nu, teeth,
jaw]`` each: the arch mesh the case's points are drawn from, so every seed
trains on the same sizes), the warm-up epochs, the steps the check follows
(``check_steps``) and the limits. The configuration gives the points a case,
the batch, the optimizer, the augmentation and the model's sizes. The seed
draws the cases, the weights, the loader's order and the augmentation.

Set-up builds one ``Trainer`` (the program's model, optimizer state and
dropout generator) over the loader, loads weights drawn from the seed and
runs the warm-up epochs through ``train_epoch``, the window's own call. The
window hands that same trainer on and runs whole epochs until ``--seconds``
have passed; ``train_clouds_per_s`` counts the clouds trained over its
seconds, the loader's included.

The check follows ``check_steps`` steps twice: the first steps of set-up,
from the seeded weights (``loss_gap``, ``grad_gap``, ``change_gap``), and
the first steps of the window (``window_*``), from the state the window
began with: the weights, the running statistics and the optimizer's state,
kept before its first step. After the window, with the program's state
freed, the plain reference takes each start, works out the same batches
from the case files, the loader's seed and the augmentation's (the epochs
before replayed), and takes ``check_steps`` steps, its optimizer
(``reference/optim.py``, the configuration's) going on from the program's
state and at the configuration's learning rate. Compared: each step's
loss, each leaf's first gradient as the optimizer took it (worked out from
its state before and after the first step, ``optim.first_gradient``), and
each leaf's change after the steps (parameters and the running
statistics), by the gap of their norms, against the larger of the leaf's
own norm and the median leaf's; leaves whose reference gradient is under a
thousandth of the median leaf's are left out of the change, since the
optimizer moves them by rounding alone.

A task's reference module, ``reference/<model>.py``, found by the name,
gives:

* ``TrainReference(params, buffers, config, prec)``: the plain model from
  name -> tensor dicts as the program's ``named_parameters`` and
  ``named_buffers`` give them, with ``p`` and ``b``, those dicts (the
  optimizer replaces ``p``'s entries), and ``gradients(batch, generator) ->
  (loss, {name: gradient or None})``, which moves ``b``'s running
  statistics; ``prec`` is ``reference.ops.Precision``, TF32 for the control;
* ``batches(paths, config, loader_seed, data_seed, start, steps, device)``:
  the loader's batches ``start`` on, and ``dropout_seed(seed, step)``: the
  dropout generator's seed of a step (``reference/training.py`` has both
  for the port's ``BatchLoader`` and ``Trainer``);
* the yardstick: ``train_flops(config)``, a step's FLOPs, and
  ``kernel_bounds_s(config) -> {kernel: seconds}``, the bound of a step's
  calls of each kernel a roofline metric reads (``records["<kernel>_bound_s"]``
  over the window's steps), from ``counts.py``'s primitives.
"""

from __future__ import annotations

import dataclasses
import importlib
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

import synthetic
import weights
from harness import Check
from reference import optim


@dataclass
class Followed:
    """``check_steps`` steps of the program from loader count ``start``:
    the state before them (``before``: params, buffers and each leaf's
    optimizer state), each step's loss, the optimizer's state after the
    first step and the state after the last."""
    start: int
    before: dict
    losses: list = field(default_factory=list)
    first: dict | None = None
    after: dict | None = None


class TimedLoader:
    """The program's loader, each ``next()`` timed; ``on_next(j)`` runs
    before the j-th batch is handed out (0-based, over all epochs), when
    the steps before it have ended."""

    def __init__(self, inner, on_next, faults):
        self.inner, self.on_next, self.faults = inner, on_next, faults
        self.load_s, self.count, self.spans = 0.0, 0, None

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        it = iter(self.inner)
        while True:
            self.on_next(self.count)
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            t1 = time.perf_counter()
            self.load_s += t1 - t0
            if self.spans is not None:
                self.spans.append(("loader.next", t0, t1))
            if "half_batch" in self.faults:
                batch["mask"] = batch["mask"].copy()
                batch["mask"][:, batch["mask"].shape[1] // 2:] = False
            self.count += 1
            yield batch


class Traffic:
    def __init__(self, run):
        self.run = run
        self.cfg, self.w = run.config, run.workload
        self.records: dict = {}
        self.rng = np.random.default_rng(run.seed)

    def setup(self) -> None:
        marks = [("start", time.perf_counter())]
        from toothgroupnetwork_tpu_torch.data.augment import build_augmenter
        from toothgroupnetwork_tpu_torch.data.dataset import BatchLoader, DentalScanDataset
        import toothgroupnetwork_tpu_torch.models.tasks  # noqa: F401  (registers the tasks)
        from toothgroupnetwork_tpu_torch.models.registry import get_task
        from toothgroupnetwork_tpu_torch.train.trainer import Trainer

        run, cfg, dev = self.run, self.cfg, torch.device(self.run.device)
        marks.append(("imports", time.perf_counter()))
        self.case_dir = run.workdir / "cases"
        self.case_dir.mkdir()
        for i, (ns, nu, teeth, jaw) in enumerate(self.w["cases"]):
            synthetic.write_case(self.case_dir / f"CASE{i:02d}_{jaw}_sampled_points.npy",
                                 self.rng, ns, nu, teeth, cfg["n_points"])
        self.data_seed, self.loader_seed, weight_seed = (
            int(s) for s in self.rng.integers(2 ** 62, size=3))

        marks.append(("cases", time.perf_counter()))
        self.ref = importlib.import_module(f"reference.{self.w['model']}")
        task = get_task(self.w["model"])
        config = task.default_config()
        config.seed = run.seed
        config.model_parameter = dict(cfg["model_parameter"])
        config.optimizer = dataclasses.replace(config.optimizer, **cfg["optimizer"])
        config.generator.aug_specs = [tuple(s) for s in cfg["aug_specs"]]
        config.checkpoint_path = str(run.workdir / "ckpt")
        dataset = DentalScanDataset(str(self.case_dir),
                                    augmenter=build_augmenter(config.generator.aug_specs),
                                    seed=self.data_seed)
        inner = BatchLoader(dataset, cfg["batch_size"], shuffle=True, seed=self.loader_seed)
        self.loader = TimedLoader(inner, self._on_next, run.faults)
        self.followed: list[Followed] = []
        steps = self.w["check_steps"]

        def recorded(outputs, batch, conf):
            out = task.compute_losses(outputs, batch, conf)
            step = self.loader.count - 1
            for f in self.followed:
                if f.start <= step < f.start + steps:
                    f.losses.append(sum(v.detach() * w for v, w in out.values()))
            return out

        self.trainer = Trainer(config, dataclasses.replace(task, compute_losses=recorded),
                               self.loader, None, log_fn=lambda _m: None, device=dev)
        model = self.trainer.model
        dense = {n: tuple(p.shape) for n, p in model.named_parameters()
                 if n.endswith(".weight") and not getattr(
                     model.get_submodule(n.rsplit(".", 1)[0]), "zero_init", False)}
        drawn = weights.draw(dense, dev, weight_seed)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n in drawn:
                    p.copy_(drawn[n])
        self.followed.append(Followed(0, self._state()))
        if "unchanged_state" in run.faults:
            self.trainer.optimizer.step = lambda *a, **k: None
        marks.append(("trainer", time.perf_counter()))
        for _ in range(self.w["warm_epochs"]):
            self.trainer.train_epoch()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        marks.append(("warm", time.perf_counter()))
        run.log("setup s: " + " ".join(f"{name} {t - prev:.3f}" for (_, prev), (name, t)
                                        in zip(marks, marks[1:])))

    def _state(self) -> dict:
        """Copies of the params, the buffers and the optimizer's state."""
        m = self.trainer.model
        return {"params": {n: p.detach().clone() for n, p in m.named_parameters()},
                "buffers": {n: b.detach().clone() for n, b in m.named_buffers()},
                "optim": self._optim_state()}

    def _optim_state(self) -> dict:
        """Each leaf's optimizer state, copied whole (empty where the
        optimizer has not stepped the leaf)."""
        state = self.trainer.optimizer.state
        return {n: {k: v.detach().clone() if torch.is_tensor(v) else v
                    for k, v in state.get(p, {}).items()}
                for n, p in self.trainer.model.named_parameters()}

    def _on_next(self, j: int) -> None:
        for f in self.followed:
            if j == f.start + 1:
                f.first = self._optim_state()
            if j == f.start + self.w["check_steps"]:
                f.after = self._state()

    def window(self, seconds: float) -> dict:
        loader = self.loader
        loader.load_s = 0.0
        if self.run.trace:
            loader.spans = []
        steps0 = loader.count
        # the state the window begins with, for the check to follow its
        # first steps from
        self.followed.append(Followed(steps0, self._state()))
        if "window_unchanged_state" in self.run.faults:
            # a change that only the window's steps see
            self.trainer.optimizer.step = lambda *a, **k: None
        t0 = time.perf_counter()
        ends = []
        while True:
            self.trainer.train_epoch()
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        elapsed = ends[-1]
        gaps = np.diff([0.0] + ends)
        self.run.log(f"window: {len(ends)} epochs of {len(loader)} steps, epoch s "
                     f"min {gaps.min():.4f} median {np.median(gaps):.4f} max {gaps.max():.4f}")
        steps = loader.count - steps0
        clouds = steps * self.cfg["batch_size"]
        wall0 = time.time_ns() - time.perf_counter_ns()
        self.records.setdefault("spans", []).extend(
            (n, wall0 + int(a * 1e9), wall0 + int(b * 1e9)) for n, a, b in loader.spans or ())
        self.records.update(
            steps=steps, load_s=loader.load_s, window_s=elapsed,
            flops=steps * self.ref.train_flops(self.cfg),
            **{f"{k}_bound_s": steps * v
               for k, v in self.ref.kernel_bounds_s(self.cfg).items()})
        return {"attempted": clouds, "failed": 0,
                "metrics": {"train_clouds_per_s": clouds / elapsed}}

    def check(self) -> list[Check]:
        dev = torch.device(self.run.device)
        followed = self.followed
        del self.trainer, self.loader, self.followed
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        from reference.ops import Precision

        readings, control = {}, {}
        for f, prefix in zip(followed, ("", "window_")):
            before = f.before
            prog = {"losses": [float(v) for v in f.losses],
                    "first": optim.first_gradient(self.cfg["optimizer"], before["optim"],
                                                  f.first, before["params"]),
                    "after": f.after}
            ref = self.reference(f, Precision())
            self.run.log(f"{prefix}losses (program, reference): " + ", ".join(
                f"{a!r} {b!r}" for a, b in zip(prog["losses"], ref["losses"])))
            readings.update({prefix + k: v for k, v in judge(prog, ref, before).items()})
            if self.run.control:
                ctrl = self.reference(f, Precision(tf32=True))
                control.update({prefix + k: v for k, v in judge(ctrl, ref, before).items()})
        limits = self.w["limits"]
        if self.run.control:
            self.records["control"] = {k: float(control[k]) for k in limits}
        return [Check(k, float(readings[k]), limits[k]) for k in limits]

    def reference(self, f: Followed, prec) -> dict:
        """The plain reference's ``check_steps`` steps from ``f.before``
        on the batches it works out from the case files for loader counts
        ``f.start`` on: each step's loss, the first gradient, the state
        after."""
        dev = torch.device(self.run.device)
        mod, before = self.ref, f.before
        ref = mod.TrainReference(before["params"], before["buffers"], self.cfg, prec)
        opt = optim.build(self.cfg["optimizer"], before["optim"])
        batches = mod.batches(sorted(Path(self.case_dir).glob("*_sampled_points.npy")),
                              self.cfg, self.loader_seed, self.data_seed, f.start,
                              self.w["check_steps"], dev)
        losses, first = [], None
        # the reference's own reading of a seed repeats: its gathers'
        # backward accumulates in a fixed order (on the card, atomics made
        # the later steps' losses differ by up to 2e-5 between runs)
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            for step, batch in enumerate(batches, start=f.start):
                gen = torch.Generator(device=dev).manual_seed(
                    mod.dropout_seed(self.run.seed, step))
                loss, grads = ref.gradients(batch, gen)
                took = opt.step(ref.p, grads)
                losses.append(loss)
                first = took if first is None else first
        finally:
            torch.use_deterministic_algorithms(was)
        return {"losses": losses, "first": first,
                "after": {"params": ref.p, "buffers": ref.b}}


def judge(got: dict, ref: dict, start: dict) -> dict:
    """Each step's loss gap, the first gradient's and the change's worst
    leaf (``norm_gap``); the change leaves out the leaves whose reference
    gradient is under a thousandth of the median leaf's."""
    g = {n: float(t.norm()) for n, t in ref["first"].items()}
    med = float(np.median(list(g.values())))
    keep = {n for n, v in g.items() if v >= 1e-3 * med} | set(start["buffers"])

    def change(after):
        return {n: after[k][n] - start[k][n] for k in ("params", "buffers") for n in start[k]}

    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
            "grad_gap": norm_gap(got["first"], ref["first"]),
            "change_gap": norm_gap(change(got["after"]), change(ref["after"]), keep)}


def norm_gap(got: dict, want: dict, keep=None) -> float:
    """The worst leaf's gap between the norms, over the larger of the
    reference leaf's norm and the median reference leaf's."""
    names = [n for n in want if keep is None or n in keep]
    ref = {n: float(want[n].norm()) for n in names}
    med = float(np.median(list(ref.values())))
    return max(abs(float(got[n].norm()) - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)
