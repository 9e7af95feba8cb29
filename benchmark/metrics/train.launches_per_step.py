"""Kernels launched on the card in the traced window (memory copies and
sets not counted) over the steps taken in it."""


def read(records):
    tr = records.get("trace")
    if not tr or not records.get("steps") or not tr["launches"]:
        return None
    return tr["launches"] / records["steps"]
