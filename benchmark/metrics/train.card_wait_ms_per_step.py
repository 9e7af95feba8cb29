"""Milliseconds a training step waited for the card: the program's
``card_wait`` spans (``utils/profiling.py``; the fetch of the step's
losses) in the window's steps, over its ``step`` spans. None where the
program records no spans."""

from toothgroupnetwork_tpu_torch.utils import profiling


def value(spans):
    steps = {s.group for s in spans if s.name == "step"}
    if not steps:
        return None
    return sum(s.end_ns - s.start_ns for s in spans
               if s.name == "card_wait" and s.group in steps) / 1e6 / len(steps)


def read(records):
    spans = getattr(profiling, "spans", None)
    return value(spans()) if spans else None
