"""The window's model FLOPs (``counts.tgnet_scan_flops`` of each scan
completed, over the crops it had) over the window's seconds, as a share of
the card's float32 peak."""

import counts


def read(records):
    if not records.get("flops") or not records.get("window_s"):
        return None
    return 100.0 * records["flops"] / records["window_s"] / counts.F32_FLOPS_PER_S
