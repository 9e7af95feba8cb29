"""Milliseconds of host time a training step spent in the loader (read,
augment, collate): the program's ``data.next`` spans
(``utils/profiling.py``) in the window's steps, over its ``step`` spans.
The program's own twin of ``data.load_ms_per_step``. None where the
program records no spans."""

from toothgroupnetwork_tpu_torch.utils import profiling


def value(spans):
    steps = {s.group for s in spans if s.name == "step"}
    if not steps:
        return None
    return sum(s.end_ns - s.start_ns for s in spans
               if s.name == "data.next" and s.group in steps) / 1e6 / len(steps)


def read(records):
    spans = getattr(profiling, "spans", None)
    return value(spans()) if spans else None
