"""Weighted-loss containers (reference loss_meter.py contract; a copy of
toothgroupnetwork_tpu/train/loss_meter.py).

``LossMap`` holds named ``(value, weight)`` pairs; ``get_sum`` is the weighted total
used for backward (loss_meter.py:43-47); ``get_loss_dict_for_print`` emits the
``<name>_<postfix>`` + ``total_<postfix>`` naming convention used by the logging
(loss_meter.py:49-61). ``LossMeter`` step-averages dicts (loss_meter.py:2-24).
"""

from __future__ import annotations


class LossMap:
    def __init__(self, loss_dict: dict | None = None):
        self.loss_dict: dict[str, tuple] = {}
        if loss_dict:
            self.add_loss_by_dict(loss_dict)

    def add_loss(self, name: str, value, weight: float):
        self.loss_dict[name] = (value, weight)

    def add_loss_by_dict(self, loss_dict: dict):
        for key, (value, weight) in loss_dict.items():
            if key in self.loss_dict:
                raise KeyError(f"duplicate loss {key!r}")
            self.add_loss(key, value, weight)

    def get_sum(self):
        total = 0.0
        for value, weight in self.loss_dict.values():
            total = total + value * weight
        return total

    def get_loss_dict_for_print(self, postfix: str) -> dict:
        out = {}
        for key, (value, weight) in self.loss_dict.items():
            out[f"{key}_{postfix}"] = float(value) * weight
        out[f"total_{postfix}"] = sum(out.values())
        return out


class LossMeter:
    def __init__(self):
        self.loss_meter_dict: dict[str, float] = {}
        self.step_num = 0

    def aggr(self, loss_map: dict, weight: float = 1.0):
        """Accumulate one step's loss dict. ``weight`` makes the running average
        item-weighted (pass the number of scans in the batch so partial validation
        batches don't bias the mean)."""
        for key, val in loss_map.items():
            self.loss_meter_dict[key] = (self.loss_meter_dict.get(key, 0.0)
                                         + float(val) * weight)
        self.step_num += weight

    def get_avg_results(self) -> dict:
        return {k: v / self.step_num for k, v in self.loss_meter_dict.items()}

    def init(self):
        self.step_num = 0
        self.loss_meter_dict = {}
