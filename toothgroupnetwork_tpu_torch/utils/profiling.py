"""Profiling utilities (counterpart of toothgroupnetwork_tpu/utils/profiling.py).

* :func:`chained_time` — seconds per call of ``fn(*args)``. On a CUDA
  device: CUDA events around ``iters`` back-to-back calls after a warm-up
  call (the host launch time counts where a call's kernels are shorter than
  it), or with ``graph=True`` the replay of one CUDA graph that captured
  them (device time only). Elsewhere: the host clock around the calls,
  which times the CPU, not a device.
* :func:`trace` — a ``torch.profiler`` context writing a Chrome trace
  (``trace.json``) into ``log_dir``, with the CUDA activity when a card is
  there, and the program's spans beside the profiler's events.
* The program's spans: :func:`span`, :func:`phase`, :func:`fetch` and
  :func:`tracing`, read back by :func:`spans`.

The JAX module's ``cost_bytes`` reads "bytes accessed" from XLA's cost
analysis of a compiled program. PyTorch runs eagerly and keeps no such
count, so this module defines nothing under that name rather than report
an invented number; a kernel's bytes are counted from its shapes
(``chip_smoke.py``'s bounds).

Spans
-----
A span is a named interval of the program's own work: its start and end on
``time.time_ns``'s clock, which is the torch profiler's, so spans lie over
the profiler's operations and the card's kernels. They are read as
``time.perf_counter_ns`` plus its offset to ``time.time_ns``, taken when a
call starts tracing, so that a phase's span and the pipeline's
``timings`` (``time.perf_counter`` seconds) are one reading of one clock.
A span also records the span it ran inside
(``parent``); and a ``group`` shared by every span of one scan (``(call,
index)``) or one training step (the step's number). A span may carry
integer counts of the work it did (:meth:`Span.count`).

A thread records spans only while it traces. The program's entry points
(``TgnInferencePipeline.run_many`` and ``__call__``, the other pipelines'
``__call__``, ``Trainer.train_epoch``) enter :func:`tracing`, which turns
it on for the call exactly when a torch profiler is recording on the
calling thread; ``run_many`` hands its call's span to its worker threads
(:func:`joined`), whose profiler state is their own. So an untraced run
records nothing, and a span there costs one attribute check and returns
the shared :data:`NULL` context. Finished spans are kept in memory, at
most :data:`SPAN_LIMIT` of them (:func:`dropped` counts the rest).

This module imports torch only inside the functions that use it: the
spawned prep workers import the numpy-only ``data/scan_prep.py``, which
records a span.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

SPAN_LIMIT = 1 << 17
# the name of a pipeline phase while it runs, before phase() names it
_OPEN_PHASE = ""
# trace.json thread ids of the spans' tracks, apart from the profiler's
_SPAN_TID_BASE = 1 << 40


def _device_of(args):
    import torch

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
    import torch

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
    of the yielded profiler sums the time by kernel. The program's spans
    recorded inside the block are written into the same file as complete
    events, one track for each thread that recorded them, so a scan's
    phases lie over the card's kernels."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    begin = _now_ns()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, [s for s in spans() if s.start_ns >= begin])


def _add_spans(path: str, recorded: list) -> None:
    """Append ``recorded`` spans to the Chrome trace at ``path``, on the
    trace's clock (microseconds from its ``baseTimeNanoseconds``)."""
    with open(path) as f:
        doc = json.load(f)
    base, pid = doc.get("baseTimeNanoseconds", 0), os.getpid()
    events = doc.setdefault("traceEvents", [])
    for thread in sorted({s.thread for s in recorded}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": _SPAN_TID_BASE + thread,
                       "args": {"name": f"program spans, thread {thread}"}})
    for s in recorded:
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                       "tid": _SPAN_TID_BASE + s.thread,
                       "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"id": s.id, "parent": s.parent, "group": str(s.group),
                                **(s.counts or {})}})
    with open(path, "w") as f:
        json.dump(doc, f)


# ------------------------------------------------------------------ spans
_ids = itertools.count(1)
_calls = itertools.count(1)
_lock = threading.Lock()
_spans: list = []
_dropped = 0


def _wall_offset() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the tightest of
    three readings (a thread switch between the two clocks' reads would
    shift it)."""
    best = None
    for _ in range(3):
        before = time.perf_counter_ns()
        wall = time.time_ns()
        gap = time.perf_counter_ns() - before
        if best is None or gap < best[0]:
            best = (gap, wall - before - gap // 2)
    return best[1]


_wall0 = _wall_offset()


def _now_ns() -> int:
    return time.perf_counter_ns() + _wall0


class _Thread(threading.local):
    # this thread's open spans while it traces, None while it does not
    stack: list | None = None


_thread = _Thread()


class Span:
    """A span (module docstring): ``name``, ``start_ns``, ``end_ns``,
    ``id``, ``parent`` (the id of the span it ran inside, 0 for none),
    ``group``, ``counts`` (None or a dict of integers) and ``thread`` (the
    native id of the thread that ran it). Opened by :func:`span` and
    recorded when its ``with`` block ends."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "group", "counts",
                 "thread", "phased")

    def __init__(self, name, group, parent: int, phased: bool = False,
                 start_ns: int | None = None):
        self.name, self.group, self.parent, self.phased = name, group, parent, phased
        self.id = next(_ids)
        self.start_ns = _now_ns() if start_ns is None else start_ns
        self.end_ns = 0
        self.counts = None
        self.thread = threading.get_native_id()

    def __enter__(self):
        stack = _thread.stack
        stack.append(self)
        if self.phased:
            stack.append(Span(_OPEN_PHASE, self.group, self.id, start_ns=self.start_ns))
        return self

    def __exit__(self, *exc):
        self.end_ns = _now_ns()
        stack = _thread.stack
        while stack.pop() is not self:   # the phase left open after the last
            pass
        if self.name is not None:
            _record(self)
        return False

    def count(self, key: str, n: int) -> None:
        """Add ``n`` to this span's count ``key``."""
        if self.counts is None:
            self.counts = {}
        self.counts[key] = self.counts.get(key, 0) + int(n)

    def drop(self) -> None:
        """Record nothing of this span when it ends (a step that found no
        batch)."""
        self.name = None


class _Null:
    """What :func:`span` returns on a thread that does not trace."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, key: str, n: int) -> None:
        pass

    def drop(self) -> None:
        pass


NULL = _Null()


def _record(s: Span) -> None:
    global _dropped
    with _lock:
        if len(_spans) < SPAN_LIMIT:
            _spans.append(s)
        else:
            _dropped += 1


def span(name: str, group=None, phases: bool = False):
    """``with span("cluster") as s: ...; s.count("points", n)``: a span
    inside the one this thread has open, in its group (``group`` when
    given; a span opened outside any other starts a new call, ``(call,
    0)``). With ``phases`` the span's time is cut into the phases that
    :func:`phase` names. :data:`NULL` on a thread that does not trace."""
    stack = _thread.stack
    if stack is None:
        return NULL
    top = stack[-1] if stack else None
    if group is None:
        group = top.group if top is not None else (next(_calls), 0)
    return Span(name, group, top.id if top is not None else 0, phases)


def phase(timings: dict, name: str, t0: float) -> float:
    """End a pipeline phase that began at ``t0`` (``time.perf_counter``):
    add its seconds to ``timings[name]`` and return the time now, the next
    phase's start. Inside a span opened with ``phases``, the phase is also
    recorded as a span under it, from ``t0`` to now, and the spans opened
    meanwhile are its children."""
    now_ns = time.perf_counter_ns()
    now = now_ns / 1e9    # what time.perf_counter() reads at that instant
    timings[name] += now - t0
    stack = _thread.stack
    if stack and stack[-1].name == _OPEN_PHASE:
        ended = stack[-1]
        ended.name = name
        ended.start_ns, ended.end_ns = round(t0 * 1e9) + _wall0, now_ns + _wall0
        _record(ended)
        stack[-1] = Span(_OPEN_PHASE, ended.group, ended.parent, start_ns=ended.end_ns)
    return now


def fetch(tensor):
    """``tensor.cpu()``: the copy of a result to the host. While this
    thread traces, the wait for the work queued before it on the current
    stream is a ``card_wait`` span first (no extra wait otherwise)."""
    if _thread.stack is None:
        return tensor.cpu()
    with span("card_wait"):
        if tensor.is_cuda:
            import torch

            torch.cuda.current_stream(tensor.device).synchronize()
    return tensor.cpu()


def _profiler_recording() -> bool:
    import torch

    return torch._C._autograd._profiler_enabled()


@contextlib.contextmanager
def tracing():
    """An entry point's call: this thread traces inside it when it already
    does (a caller's call handed on) or when a torch profiler is recording
    on it, read once here."""
    global _wall0
    if _thread.stack is not None or not _profiler_recording():
        yield
        return
    _wall0 = _wall_offset()   # the wall clock may have been set since
    _thread.stack = []
    try:
        yield
    finally:
        _thread.stack = None


def new_call() -> int:
    """A fresh call number, for the groups ``(call, index)`` of the scans
    of one ``run_many`` call."""
    return next(_calls)


@contextlib.contextmanager
def joined(parent, group):
    """Trace this thread's spans inside ``parent``, a span open on another
    thread (``run_many``'s, handed to a worker), under ``group``; nothing
    when ``parent`` is :data:`NULL`."""
    if parent is NULL:
        yield
        return
    frame = Span(None, group, parent.parent, start_ns=parent.start_ns)
    frame.id = parent.id
    before, _thread.stack = _thread.stack, [frame]
    try:
        yield
    finally:
        _thread.stack = before


def spans() -> list:
    """The spans recorded so far (:class:`Span`), in the order they ended."""
    with _lock:
        return list(_spans)


def dropped() -> int:
    """The spans not kept since :data:`SPAN_LIMIT` was reached."""
    return _dropped


def reset_spans() -> None:
    """Forget the spans recorded and the count of those dropped."""
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0
