"""The window's training FLOPs (the task's ``train_flops`` of each step,
``reference/<task>.py``) over the window's seconds, as a share of the
card's float32 peak."""

import counts


def read(records):
    if not records.get("flops") or not records.get("window_s"):
        return None
    return 100.0 * records["flops"] / records["window_s"] / counts.F32_FLOPS_PER_S
