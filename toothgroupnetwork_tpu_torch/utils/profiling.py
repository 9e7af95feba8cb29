"""Profiling utilities (counterpart of toothgroupnetwork_tpu/utils/profiling.py).

* :func:`chained_time` — seconds per call of ``fn(*args)``. On a CUDA
  device: CUDA events around ``iters`` back-to-back calls after a warm-up
  call (the host launch time counts where a call's kernels are shorter than
  it), or with ``graph=True`` the replay of one CUDA graph that captured
  them (device time only). Elsewhere: the host clock around the calls,
  which times the CPU, not a device.
* :func:`trace` — a ``torch.profiler`` context writing a Chrome trace
  (``trace.json``) into ``log_dir``, with the CUDA activity when a card is
  there.
* :class:`ScansPerSec` — a throughput counter.

The JAX module's ``cost_bytes`` reads "bytes accessed" from XLA's cost
analysis of a compiled program. PyTorch runs eagerly and keeps no such
count, so this module defines nothing under that name rather than report
an invented number; a kernel's bytes are counted from its shapes
(``chip_smoke.py``'s bounds).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def chained_time(fn, *args, iters: int = 10, warmup: bool = True,
                 graph: bool = False, device=None) -> float:
    """Seconds per call of ``fn(*args)`` over ``iters`` back-to-back calls,
    on ``device`` or else the device of the first tensor argument (module
    docstring). ``graph`` needs a CUDA device and a ``fn`` that a CUDA
    graph can capture (no host synchronisation inside)."""
    dev = torch.device(device) if device is not None else _device_of(args)
    if dev.type != "cuda":
        if warmup:
            fn(*args)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(dev):
        if warmup or graph:
            fn(*args)
            torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if graph:
            captured = torch.cuda.CUDAGraph()
            with torch.cuda.graph(captured):
                for _ in range(iters):
                    fn(*args)
            captured.replay()
            torch.cuda.synchronize(dev)
            start.record()
            captured.replay()
        else:
            start.record()
            for _ in range(iters):
                fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('traces/scan'): run()`` writes ``log_dir/trace.json``
    (open it in ``chrome://tracing`` or Perfetto); ``prof.key_averages()``
    of the yielded profiler sums the time by kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class ScansPerSec:
    """Simple throughput counter: ``c = ScansPerSec(); ...; c.add(n); c.rate()``."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.n = 0

    def add(self, n: int = 1):
        self.n += n

    def rate(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.n / dt if dt > 0 else float("inf")
