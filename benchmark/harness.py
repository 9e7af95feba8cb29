"""The harness: finds a cell's configuration, traffic kind and metrics by
name, runs set-up, the measured window and the correctness check, and
builds the result line.

Everything that belongs to one configuration, traffic mix, traffic kind or
per-layer metric lives in a file of its own, found by its name:

* ``BENCHMARK.json`` (the checkout's root): the cells, the end-to-end and
  per-layer metrics, and which cells report which;
* ``configs/<config>.json``: a configuration's sizes;
* ``workloads/<cell>.json``: a cell's traffic mix, ``{"kind": ..., ...}``
  with the parameters its kind reads and the correctness limits;
* ``traffic/<kind>.py``: a traffic kind, a class ``Traffic(run)`` with
  ``setup()``, ``window(seconds) -> dict`` and ``check() -> list[Check]``,
  and a ``records`` dict for the metrics;
* ``metrics/<metric>.py``: a per-layer metric, ``read(records) -> float |
  None`` (None where the run holds nothing to read).
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "toothgroupnetwork_tpu")


@dataclass
class Check:
    """One number compared, with its limit (``value <= limit`` passes)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Run:
    """What a traffic kind gets: the cell, its configuration and traffic
    files, the run's seed and flags, the device, a work directory (gone
    after the run) and a cache directory (the checkout's, kept)."""
    cell: str
    config: dict
    workload: dict
    seed: int
    trace: bool
    device: object
    workdir: Path
    cache_dir: Path
    faults: frozenset = frozenset()
    control: bool = False
    log: object = field(default=lambda msg: print(msg, file=sys.stderr, flush=True))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file ``path`` as module ``name`` (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path, bench_dir: Path = BENCH_DIR):
        self.root, self.dir = root, bench_dir
        self.spec = load_json(root / "BENCHMARK.json")
        self.cells = {w["name"]: w for w in self.spec["workloads"]}
        self.configs = {c["name"]: c for c in self.spec["configs"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(has {sorted(self.cells)})")
        return self.cells[name]

    def config(self, cell: str) -> dict:
        return load_json(self.root / self.configs[self.cell(cell)["config"]]["file"])

    def workload(self, cell: str) -> dict:
        return load_json(self.dir / "workloads" / f"{cell}.json")

    def traffic(self, kind: str):
        return load_module(self.dir / "traffic" / f"{kind}.py", f"bench_traffic_{kind}")

    def metrics_of(self, cell: str, group: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports: those
        that list it under ``workloads``, or have no such list (a per-layer
        metric without one goes with every cell reporting its ``moves``)."""
        e2e = {m["name"]: m for m in self.spec["end_to_end"]}
        out = []
        for m in self.spec[group]:
            cells = m.get("workloads")
            if cells is None and group == "per_layer":
                cells = e2e[m["moves"]].get("workloads")
            if cells is None or cell in cells:
                out.append(m)
        return out

    def reader(self, metric: str):
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           "bench_metric_" + metric.replace(".", "_"))


def forbidden_modules() -> list[str]:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(bench: Bench, cell: str, seed: int, seconds: float, trace: bool,
             device, workdir: Path, t_start: float,
             faults: frozenset = frozenset(), control: bool = False) -> dict:
    """Set-up, the window and the check of one cell; returns the result
    line's dict (``checks`` last). ``faults`` breaks the timed path (the
    tests' runs); ``control`` also reads the control's numbers, the
    reference one precision below in the program's place (``control.py``),
    and holds them to the same limits, under ``control``."""
    import torch

    spec = bench.cell(cell)
    workload = bench.workload(cell)
    run = Run(cell, bench.config(cell), workload, seed, trace, device, workdir,
              bench.root / "build" / "bench_weights", faults, control)
    traffic = bench.traffic(workload["kind"]).Traffic(run)
    run.log(f"set-up begins {time.perf_counter() - t_start:.3f} s after the start")
    traffic.setup()
    setup_s = time.perf_counter() - t_start
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if trace:
        from trace_reader import traced

        with traced(on_card, traffic.records.setdefault("spans", [])) as tr:
            window = traffic.window(seconds)
        traffic.records["trace"] = tr.summary
    else:
        window = traffic.window(seconds)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    checks = traffic.check()
    values = dict(window["metrics"], setup_s=setup_s)
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics_of(cell, group):
        v = values.get(m["name"]) if group == "end_to_end" else \
            bench.reader(m["name"]).read(traffic.records)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": spec["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": all(c.ok for c in checks), "attempted": window["attempted"],
           "failed": window["failed"], "metrics": metrics, "device": device_info}
    if trace:
        summary = traffic.records["trace"]
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        out["breakdown"] = {"device_ops": summary["device_ops"][:10],
                            "idle_gaps": summary["idle_gaps"][:10]}
    if control:
        # the control held to the same limits: it has to come out not correct
        held = [Check(c.name, traffic.records["control"][c.name], c.limit) for c in checks]
        out["control"] = {"correct": all(c.ok for c in held),
                          "checks": {c.name: {"value": c.value, "limit": c.limit}
                                     for c in held}}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return out


def cache_env(root: Path) -> None:
    """The program's build and kernel caches at fixed paths in the checkout,
    and the libraries that could load JAX told not to."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    # deterministic cuBLAS, as the trainer needs, before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
