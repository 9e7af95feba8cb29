"""Reduce a ``torch.profiler`` trace of the measured window to what the
per-layer metrics and the result line read: the device's busy seconds (the
union of every operation's interval on the card, all streams merged), the
traced window's length, device time and launches by kernel, and the longest
idle gaps, each named by what the host was doing meanwhile.

A gap is named by the host span (``(name, start_ns, end_ns)`` on the wall
clock, recorded by the traffic kind around the program's calls) that
overlaps it most, else by the profiled host operation that does, else
``python``: the interpreter between operations.
"""

from __future__ import annotations

import contextlib
import re
import time

import numpy as np

TOP = 10


def short(name: str) -> str:
    """A kernel's name without its return type, namespace, template and
    argument lists."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    base = re.split(r"[<(]", name, maxsplit=1)[0].rsplit("::", 1)[-1]
    return (base or name)[:80]


def _events(prof):
    """``(is_device, name, start_ns, end_ns)`` of every profiled event."""
    from torch.autograd import DeviceType

    try:
        for e in prof.profiler.kineto_results.events():
            if getattr(e, "is_user_annotation", lambda: False)():
                continue
            start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
            dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
            yield e.device_type() == DeviceType.CUDA, e.name(), start, start + dur
    except AttributeError:
        for e in prof.events():
            if getattr(e, "is_user_annotation", False):
                continue
            yield (e.device_type == DeviceType.CUDA, e.name,
                   e.time_range.start * 1000, e.time_range.end * 1000)


def summarize(prof, window_s: float, spans: list) -> dict:
    dev, host = [], []
    for is_dev, name, s, e in _events(prof):
        (dev if is_dev else host).append((s, e, name))
    by_name: dict = {}
    for s, e, name in dev:
        key = short(name)
        t, n = by_name.get(key, (0.0, 0))
        by_name[key] = (t + (e - s) / 1e9, n + 1)
    busy, end, gaps = 0.0, None, []
    lo = min((s for s, _, _ in host), default=None)
    for s, e, _ in sorted(dev):
        if end is not None and s > end:
            gaps.append((end, s))
        elif end is None and lo is not None and s > lo:
            gaps.append((lo, s))
        busy += max(0, e - max(s, end if end is not None else s))
        end = e if end is None else max(end, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [(_gap_name(g, spans, host), (g[1] - g[0]) / 1e9) for g in gaps[:TOP]]
    launches = sum(n for k, (_, n) in by_name.items() if not k.startswith("Mem"))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"busy_s": busy / 1e9, "window_s": window_s, "kernels": by_name,
            "launches": launches,
            "device_ops": [[k, t] for k, (t, _) in ops[:TOP]],
            "idle_gaps": named}


def _gap_name(gap, spans, host) -> str:
    for pool in (spans, [(n, s, e) for s, e, n in host]):
        if not pool:
            continue
        s = np.array([p[1] for p in pool], np.int64)
        e = np.array([p[2] for p in pool], np.int64)
        over = np.minimum(e, gap[1]) - np.maximum(s, gap[0])
        i = int(over.argmax())
        if over[i] > 0:
            return pool[i][0]
    return "python"


class _Traced:
    summary: dict | None = None


@contextlib.contextmanager
def traced(on_card: bool, spans: list):
    """Profile the block (host operations, and the card's when there is
    one) and leave the summary in ``.summary`` after it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    out = _Traced()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield out
        if on_card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    out.summary = summarize(prof, window_s, spans)
