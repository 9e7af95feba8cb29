"""Evaluation of predicted labels against the ground truth (numpy only)."""

from .metrics import cal_metric

__all__ = ["cal_metric"]
