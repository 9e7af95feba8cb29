"""Milliseconds a training step spent on the host outside the loader and
the waits for the card (the host stage, the forward's, backward's and
update's launches, the bookkeeping): the program's ``step`` spans
(``utils/profiling.py``) less the ``data.next`` and ``card_wait`` spans in
them, over the window's steps. None where the program records no spans."""

from toothgroupnetwork_tpu_torch.utils import profiling


def value(spans):
    steps = {s.group for s in spans if s.name == "step"}
    if not steps:
        return None
    total = sum(s.end_ns - s.start_ns for s in spans if s.name == "step")
    inside = sum(s.end_ns - s.start_ns for s in spans
                 if s.name in ("data.next", "card_wait") and s.group in steps)
    return (total - inside) / 1e6 / len(steps)


def read(records):
    spans = getattr(profiling, "spans", None)
    return value(spans()) if spans else None
