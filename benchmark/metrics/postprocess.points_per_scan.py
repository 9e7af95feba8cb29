"""Points a scan handed to ``postprocess/clustering``: the ``points``
counts of the program's ``cluster`` spans (``utils/profiling.py``) in the
window's scans, over its ``scan`` spans. The work behind
``postprocess.cluster_s_per_scan``: heads that mark more foreground cost
more. None where the program records no spans."""

from toothgroupnetwork_tpu_torch.utils import profiling


def value(spans):
    scans = {s.group for s in spans if s.name == "scan"}
    if not scans:
        return None
    return sum((s.counts or {}).get("points", 0) for s in spans
               if s.name == "cluster" and s.group in scans) / len(scans)


def read(records):
    spans = getattr(profiling, "spans", None)
    return value(spans()) if spans else None
