"""Host seconds a scan in ``data/scan_prep`` (the ``.obj`` parse, dedup,
normals) on the scan's own thread: the program's ``scan_prep`` spans
(``utils/profiling.py``) in the window's scans, over its ``scan`` spans.
None where the program records no spans."""

from toothgroupnetwork_tpu_torch.utils import profiling


def value(spans):
    scans = {s.group for s in spans if s.name == "scan"}
    if not scans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans
               if s.name == "scan_prep" and s.group in scans) / 1e9 / len(scans)


def read(records):
    spans = getattr(profiling, "spans", None)
    return value(spans()) if spans else None
