"""Seconds a scan's thread waited for the card before its device-to-host
copies (the sample's indices, stage 1's classes and moved points, the
votes, the boundary route's masks and fill, the final labels): the
program's ``card_wait`` spans (``utils/profiling.py``) in the window's
scans, over its ``scan`` spans. None where the program records no
spans."""

from toothgroupnetwork_tpu_torch.utils import profiling


def value(spans):
    scans = {s.group for s in spans if s.name == "scan"}
    if not scans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans
               if s.name == "card_wait" and s.group in scans) / 1e9 / len(scans)


def read(records):
    spans = getattr(profiling, "spans", None)
    return value(spans()) if spans else None
