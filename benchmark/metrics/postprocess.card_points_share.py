"""Share of the points handed to ``postprocess/clustering`` that were
instanced on the card: the ``card_points`` counts of the program's
``cluster`` spans (``utils/profiling.py``) in the window's scans, over
their ``points`` counts. The instancing's DBSCAN and MeanShift climbs run
on the card (K9 / K10) where its points are a CUDA tensor; the boundary
cloud's KMeans stays on the host. None where the program records no spans,
or no ``card_points`` count (a program without the card route)."""

from toothgroupnetwork_tpu_torch.utils import profiling


def value(spans):
    scans = {s.group for s in spans if s.name == "scan"}
    counts = [s.counts or {} for s in spans if s.name == "cluster" and s.group in scans]
    points = sum(c.get("points", 0) for c in counts)
    if not any("card_points" in c for c in counts) or points == 0:
        return None
    return sum(c.get("card_points", 0) for c in counts) / points


def read(records):
    spans = getattr(profiling, "spans", None)
    return value(spans()) if spans else None
